"""Spans of the serving path, kept in memory while a tracer is on.

A :class:`Tracer` records where the cluster's host time goes: each span is
a :class:`Span` tuple of its name, its start and end on
``time.perf_counter_ns()``, the index of the span it ran inside (-1 for
none) and the request id(s) it is for.  The tracer exports nothing; its
reader takes ``tracer.spans``.

Off (the default), :meth:`Tracer.span` returns one shared no-op context:
no allocation, no clock read, no profiler range.  On, each span is also a
``torch.profiler.record_function`` range while a profiler is active, so
that it lies on the profiler's timeline beside the device's operations
(a range costs tens of microseconds of host time, so none is opened where
no profiler would record it).

The span names and what each covers:

* ``cluster.tick``: ``DisaggregatedCluster.step``; ``cluster.schedule``:
  its ``_try_schedule``; ``router.route``: each routing attempt, with the
  request id; ``cluster.queue``: a placed request's wait from its
  ``submit`` to its placement (recorded with :meth:`Tracer.record`, so its
  parent is -1); ``cluster.telemetry``: the end-of-tick TTFT poll and the
  controller's ``observe``.
* ``prefill.batch``: ``PrefillEngine.prefill_many``, with children
  ``prefill.match`` (one prefix lookup), ``prefill.pass`` (one prompt pass,
  tagged ``cold`` or ``resumed``, with its rows' request ids, and its
  children ``prefill.dispatch`` up to the logits' copy to the host and
  ``prefill.wait``, that copy) and ``prefill.store`` (the passes' rows
  kept in the prefix cache).
* ``decode.admit``: ``DecodeEngine.admit``, with the request id, and
  inside it ``decode.admit.state``: the copy of the request's recurrent
  state (a Mamba layer's SSM and conv state) into its slot, on a model
  that has one;
  ``decode.step``: a ``DecodeEngine.step`` that runs the model, with
  children ``decode.dispatch`` (up to the argmax being queued),
  ``decode.wait`` (its copy to the host) and ``decode.bookkeep`` (the slot
  loop and releases).

While a tracer is on and a profiler records, the engines also run their
eager passes inside :meth:`Tracer.layers`: the model then opens a
``record_function`` range per sub-block, named by its kind (``layer.attn``,
``layer.mamba``, ``layer.mlp``, ...; ``models/model.py``).  A replayed
decode step records none.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch.models.model import LAYER_RANGES


class Span(NamedTuple):
    name: str
    t0: int                 # ns, time.perf_counter_ns()
    t1: int
    parent: int             # index in Tracer.spans of the enclosing span
    rid: object = None      # a request id, or a tuple of them
    tag: str = ""           # prefill.pass: "cold" or "resumed"


class _Off:
    """The span of an off tracer: enters and leaves, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Layers:
    """The model's per-layer ranges switched on for a pass."""
    __slots__ = ("token",)

    def __enter__(self):
        self.token = LAYER_RANGES.set(True)
        return self

    def __exit__(self, *exc):
        LAYER_RANGES.reset(self.token)
        return False


class _Live:
    """An open span of an on tracer."""
    __slots__ = ("tracer", "name", "rid", "tag", "index", "parent", "t0",
                 "range")

    def __init__(self, tracer: "Tracer", name: str, rid, tag: str):
        self.tracer, self.name, self.rid, self.tag = tracer, name, rid, tag
        self.range = None

    def __enter__(self):
        tr = self.tracer
        self.parent = tr._open[-1] if tr._open else -1
        self.index = len(tr.spans)
        tr.spans.append(None)           # filled in when the span closes
        tr._open.append(self.index)
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        tr = self.tracer
        tr._open.pop()
        tr.spans[self.index] = Span(self.name, self.t0, t1, self.parent,
                                    self.rid, self.tag)
        return False


class Tracer:
    """Span recorder of one cluster (or one engine built alone), switched
    by ``enabled``.  ``spans`` holds every span recorded while it was on,
    in the order they opened (None for one still open)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.spans: List[Optional[Span]] = []
        self._open: List[int] = []

    def span(self, name: str, rid=None, tag: str = ""):
        """A context that records ``name`` around its body, inside the
        innermost span open at its entry."""
        if not self.enabled:
            return _OFF
        return _Live(self, name, rid, tag)

    def layers(self):
        """A context in which the model's passes open a range per layer
        kind, where the tracer is on and a profiler records; else the
        shared no-op."""
        if not self.enabled or not torch._C._autograd._profiler_enabled():
            return _OFF
        return _Layers()

    def record(self, name: str, t0_ns: int, t1_ns: int, rid=None) -> None:
        """A span from explicit stamps (one that crosses ticks), with no
        parent and no profiler range."""
        if self.enabled:
            self.spans.append(Span(name, t0_ns, t1_ns, -1, rid))

    def name_rows(self, since: int, ids: Sequence) -> None:
        """Give the prompt-pass spans recorded from index ``since`` the
        request ids of the rows they ran: ``PrefillEngine`` tags them with
        the rows' positions in the ``prefill_many`` call, whose caller
        knows the ids (``ids[i]`` for position ``i``)."""
        for k in range(since, len(self.spans)):
            s = self.spans[k]
            if s is not None and s.name == "prefill.pass":
                self.spans[k] = s._replace(rid=tuple(ids[i] for i in s.rid))
            elif s is not None and s.name == "prefill.batch":
                self.spans[k] = s._replace(rid=tuple(ids))
