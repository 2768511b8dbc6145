"""The served path under the cell's traffic, and what the harness sees of it.

The window drives ``DisaggregatedCluster`` through ``submit`` and ``step``,
built with the cell's deployment and otherwise the program's defaults.
The harness keeps its own clock (``time.perf_counter``) and records spans
around the calls into each layer, from outside the program:

* ``route``: each ``ControlPlane.route`` call (the router, per attempt);
* ``prefill``: each ``PrefillEngine.prefill_many`` call, with the
  engine's ``PrefillStats`` before and after;
* ``admit``: each ``DecodeEngine.admit`` (the hand-off); its entry stamps
  the request's first token, which the prompt pass produced;
* ``decode``: each ``DecodeEngine.step`` that ran the model; its return
  stamps the tokens it produced (its argmax has been copied to the host).

The engine's prompt-pass chunks are wrapped to count their work from the
rows they are handed.  A traced run also opens a ``torch.profiler`` trace
over a steady sub-window, with a ``record_function`` range around each of
those calls, each cluster step and the harness's own work between steps."""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

import architectures
from harness import weights as weights_lib
from harness.load import ClosedLoop, OpenLoop, Request, build_traffic
from harness.spec import Cell, model_config

STAT_KEYS = ("total_blocks", "reused_blocks", "wall_s", "batches")
RANGES = ("harness", "cluster_step", "route", "prefill", "admit", "decode")
TOP_RANGES = ("harness", "cluster_step")
DRAIN_S = 90.0


@dataclass
class Record:
    """One request as the harness saw it."""
    req: Request
    tokens: List[int]
    due: float
    first: Optional[float] = None
    times: List[float] = field(default_factory=list)
    finished: Optional[float] = None
    prefill: str = ""          # "cold", "resumed" or "" where not known
    served: Optional[object] = None   # the program's ServeRequest

    @property
    def output(self) -> List[int]:
        """The tokens the program served, the prompt pass's first."""
        return list(self.served.output)


@dataclass
class Run:
    """What a run leaves for the metric readers."""
    model: dict
    deployment: dict
    device: str
    arch: object = None            # the cell's architecture module
    device_kind: str = "cpu"
    records: Dict[str, Record] = field(default_factory=dict)
    spans: Dict[str, list] = field(default_factory=dict)
    decode_steps: list = field(default_factory=list)  # (t0, t1, lengths, n)
    passes: list = field(default_factory=list)        # (t0, flops)
    placements: list = field(default_factory=list)    # admit stamps
    stats_open: dict = field(default_factory=dict)
    stats_close: dict = field(default_factory=dict)
    w0: float = 0.0
    w1: float = 0.0
    setup_s: float = 0.0
    trace: Optional[object] = None
    traced_steps: list = field(default_factory=list)  # decode steps traced
    traced_from: Optional[float] = None   # when the profiler opened

    def span(self, name, t0, t1):
        self.spans.setdefault(name, []).append((t0, t1))


def _stats(engine) -> dict:
    st = engine.stats
    return {k: float(getattr(st, k)) for k in STAT_KEYS}


class Harness:
    """Weights, model and cluster of one cell and seed on ``device``."""

    def __init__(self, cell: Cell, seed: int, device, registry=None):
        from repro_torch.models.model import Model
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.arch = architectures.load(cell.config, cell.bench_dir)
        self.cfg = model_config(cell.config, self.arch, registry)
        self.model = Model(self.cfg)
        self.weights = weights_lib.make_weights(
            self.arch, cell.config["model"], seed, self.device)
        self.cluster = None

    # ------------------------------------------------------------ set-up --

    def build(self):
        from repro_torch.serving.disagg import DisaggregatedCluster
        d = self.cell.deployment
        self.cluster = DisaggregatedCluster(
            self.model, self.weights, num_decode=d["decoders"],
            slots_per_worker=d["slots"], max_len=d["max_len"],
            decode_impl=d["decode_impl"], num_pages=d.get("num_pages"),
            seed=self.seed, sanitize=False, device=self.device)
        if self.cluster.sanitizer is not None:
            raise RuntimeError("the sanitizer is on; the benchmark runs "
                               "the program's default path without it")
        return self.cluster

    def warm(self, traffic) -> None:
        """One prompt pass of each batch width at the mix's shortest and
        longest prompts, resumed passes at its shortest and longest suffix
        where prompts share prefixes, and a decode step of every
        page-table width the mix can reach."""
        c = self.cluster
        reqs = [r for q in _all_requests(traffic) for r in q]
        lens = [r.prompt_len for r in reqs]
        widths = []
        w = 1
        while w <= c.prefill.max_batch:
            widths.append(w)
            w *= 2
        suffixes = ()
        if any(r.group >= 0 for r in reqs):
            mix = self.cell.traffic
            suffixes = tuple(mix["user_len"])
        c.prefill.warmup([min(lens), max(lens)], suffixes, widths)
        longest = max(r.prompt_len + r.max_new + 1 for r in reqs)
        for dec in c.decoders:
            if dec.paged:
                dec.warmup(dec.width_ladder(longest))
            else:
                dec.warmup()
        _sync(self.device)

    def traffic(self, seconds: float):
        return build_traffic(self.cell.traffic, self.seed, seconds,
                             self.arch.vocab(self.cell.config["model"]))

    # ------------------------------------------------------------ window --

    def run(self, traffic, seconds: float, t_start: float,
            trace_s: float = 0.0, drain: int = 0) -> Run:
        """Drive the cluster under ``traffic`` through a window of
        ``seconds``; ``trace_s`` > 0 traces a sub-window of that length in
        the middle of it.  After the close, with nothing more sent, the
        cluster runs on until ``drain`` requests have finished since the
        window opened (at most ``DRAIN_S`` seconds), so that the check has
        finished requests to judge where outputs outlast the window."""
        c = self.cluster
        run = Run(self.cell.config["model"], self.cell.deployment,
                  str(self.device), self.arch)
        traced = trace_s > 0
        if traced:
            _warm_profiler(self.device)
        rng = (torch.profiler.record_function if traced
               else (lambda name: contextlib.nullcontext()))
        state = _Instruments(run, rng)
        state.install(c)
        prof = None
        trace_from = trace_to = None
        pending = _Feeder(self, run, traffic, state)
        if isinstance(traffic, ClosedLoop):
            slots = len(c.decoders) * self.cell.deployment["slots"]
            deadline = time.perf_counter() + 600.0
            while state.in_flight < slots or not pending.all_started():
                if time.perf_counter() > deadline:
                    raise RuntimeError("the closed loop never filled its "
                                       f"{slots} slots")
                pending.start_due(time.perf_counter())
                if c.pending or c.running:
                    with rng("cluster_step"):
                        c.step()
                else:
                    time.sleep(0.001)
                pending.after_step()
            run.w0 = time.perf_counter()
        else:
            run.w0 = pending.t_base + traffic.lead_in_s
        run.w1 = run.w0 + seconds
        if traced:
            trace_from = run.w0 + max(0.0, (seconds - trace_s) / 2)
            trace_to = trace_from + trace_s
        stats_taken = False
        while True:
            now = time.perf_counter()
            if now >= run.w1:
                break
            if not stats_taken and now >= run.w0:
                run.stats_open = _stats(c.prefill)
                stats_taken = True
            if traced and prof is None and now >= trace_from:
                run.traced_from = now
                _sync(self.device)
                prof = torch.profiler.profile(activities=_activities())
                prof.__enter__()
                trace_to = time.perf_counter() + trace_s
                state.tracing = True
            elif prof is not None and state.tracing and now >= trace_to:
                state.tracing = False
                _sync(self.device)
                prof.__exit__(None, None, None)
            with rng("harness"):
                pending.submit_due(now)
            if c.pending or c.running:
                with rng("cluster_step"):
                    c.step()
                with rng("harness"):
                    pending.after_step()
            else:
                nxt = pending.next_due()
                time.sleep(max(0.0, min(nxt, run.w1) - time.perf_counter()))
        if prof is not None and state.tracing:
            state.tracing = False
            _sync(self.device)
            prof.__exit__(None, None, None)
        if not stats_taken:
            run.stats_open = _stats(c.prefill)
        run.stats_close = _stats(c.prefill)
        run.setup_s = run.w0 - t_start
        self._drain(run, state, drain)
        state.uninstall(c)
        if prof is not None:
            from harness.trace import reduce
            run.trace = reduce(prof, RANGES, TOP_RANGES)
        return run

    def _drain(self, run: Run, state, want: int) -> None:
        c = self.cluster
        deadline = time.perf_counter() + DRAIN_S
        while (c.pending or c.running) and time.perf_counter() < deadline:
            done = sum(1 for r in run.records.values()
                       if r.finished is not None and r.finished >= run.w0)
            if done >= want:
                return
            c.step()
            state.done = []

    def free(self) -> None:
        """Drop the program's state (caches, prefix cache, pools); the
        weights stay for the reference."""
        self.cluster = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _all_requests(traffic):
    if isinstance(traffic, OpenLoop):
        return [traffic.requests]
    return traffic.queues


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its own first start (its
    libraries and buffers) falls in set-up and not in the window."""
    with torch.profiler.profile(activities=_activities()):
        torch.ones(1, device=device).add_(1)
    _sync(device)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class _Feeder:
    """Submits the traffic's requests: open-loop ones when due, a closed
    loop's next request of a client as soon as its last has finished."""

    def __init__(self, h: Harness, run: Run, traffic, state):
        from repro_torch.serving.disagg import ServeRequest
        self.h, self.run, self.traffic, self.state = h, run, traffic, state
        self.make = ServeRequest
        self.t_base = time.perf_counter()
        self.i = 0
        self.next_of = {}

    def submit(self, req: Request, due: float) -> None:
        toks = req.make_tokens()
        rec = Record(req, toks, due)
        self.run.records[req.rid] = rec
        sr = self.make(request_id=req.rid, tokens=toks,
                       max_new_tokens=req.max_new)
        rec.served = sr
        self.state.by_tokens[id(toks)] = rec
        self.h.cluster.submit(sr)

    def start_due(self, now: float) -> None:
        """Send the first request of every client whose start is due."""
        starts = self.traffic.starts
        while self.i < len(starts) and self.t_base + starts[self.i] <= now:
            q = self.traffic.queues[self.i]
            self.next_of[self.i] = 1
            self.submit(q[0], self.t_base + starts[self.i])
            self.i += 1

    def all_started(self) -> bool:
        return self.i >= len(self.traffic.starts)

    def submit_due(self, now: float) -> None:
        if not isinstance(self.traffic, OpenLoop):
            return
        reqs = self.traffic.requests
        while self.i < len(reqs) and self.t_base + reqs[self.i].due <= now:
            self.submit(reqs[self.i], self.t_base + reqs[self.i].due)
            self.i += 1

    def next_due(self) -> float:
        reqs = getattr(self.traffic, "requests", [])
        if self.i < len(reqs):
            return self.t_base + reqs[self.i].due
        return float("inf")

    def after_step(self) -> None:
        done, self.state.done = self.state.done, []
        if not isinstance(self.traffic, ClosedLoop):
            return
        for rec in done:
            c = rec.req.client
            k = self.next_of[c]
            q = self.traffic.queues[c]
            if k < len(q):
                self.next_of[c] = k + 1
                self.submit(q[k], rec.finished)


class _Instruments:
    """The wrappers around the calls into each layer (instance attributes
    that shadow the methods, removed after the window)."""

    def __init__(self, run: Run, rng):
        self.run, self.rng = run, rng
        self.by_tokens: Dict[int, Record] = {}
        self.in_flight = 0
        self.done: List[Record] = []
        self.tracing = False
        self.patched = []

    def _patch(self, obj, name, wrapper):
        setattr(obj, name, wrapper(getattr(obj, name)))
        self.patched.append((obj, name))

    def uninstall(self, c) -> None:
        for obj, name in self.patched:
            delattr(obj, name)
        self.patched = []

    def install(self, c) -> None:
        run, rng = self.run, self.rng

        def route(fn):
            def wrapped(*a, **k):
                with rng("route"):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    run.span("route", t0, time.perf_counter())
                return out
            return wrapped

        def prefill_many(fn):
            def wrapped(requests):
                with rng("prefill"):
                    before = _stats(c.prefill)
                    t0 = time.perf_counter()
                    out = fn(requests)
                    t1 = time.perf_counter()
                    after = _stats(c.prefill)
                run.span("prefill", t0, t1)
                recs = [self.by_tokens.get(id(t)) for t, _, _ in requests]
                reused = after["reused_blocks"] - before["reused_blocks"]
                kind = ("cold" if reused == 0 else
                        "resumed" if len(recs) == 1 else "")
                for r in recs:
                    if r is not None:
                        r.prefill = kind
                return out
            return wrapped

        def admit(fn):
            def wrapped(slot, request_id, caches, first_token, *a, **k):
                with rng("admit"):
                    t0 = time.perf_counter()
                    rec = run.records[request_id]
                    rec.first = t0
                    rec.times.append(t0)
                    run.placements.append(t0)
                    out = fn(slot, request_id, caches, first_token, *a, **k)
                    run.span("admit", t0, time.perf_counter())
                self.in_flight += 1
                return out
            return wrapped

        def step(dec):
            def wrap(fn):
                def wrapped():
                    lengths = [s.length if s.active else 0 for s in dec.slots]
                    live = [s.length for s in dec.slots
                            if s.active and s.generated]
                    with rng("decode"):
                        t0 = time.perf_counter()
                        out = fn()
                        t1 = time.perf_counter()
                    if out:
                        run.decode_steps.append((t0, t1, lengths, live))
                        run.span("decode", t0, t1)
                        if self.tracing:
                            run.traced_steps.append((lengths, live))
                    for rid, _tok, fin in out:
                        rec = run.records[rid]
                        rec.times.append(t1)
                        if fin:
                            rec.finished = t1
                            self.in_flight -= 1
                            self.done.append(rec)
                    return out
                return wrapped
            return wrap

        self._patch(c.control, "route", route)
        self._patch(c.prefill, "prefill_many", prefill_many)
        for dec in c.decoders:
            self._patch(dec, "admit", admit)
            self._patch(dec, "step", step(dec))
        self._patch_passes(c.prefill)

    def _patch_passes(self, engine) -> None:
        """Count the work of every prompt pass from the host's own data,
        the real rows of each chunk the engine runs (its padding rows left
        out): a cold row's positions from 0, a resumed row's from
        ``start``."""
        run, m = self.run, self.run.model
        prompt_flops = run.arch.prompt_flops

        def cold(fn):
            def wrapped(plen, group, results):
                flops = sum(prompt_flops(m, 0, len(t))
                            for _, t, _ in group)
                run.passes.append((time.perf_counter(), flops))
                return fn(plen, group, results)
            return wrapped

        def resume(fn):
            def wrapped(start, group, results):
                flops = sum(prompt_flops(m, start, len(t))
                            for _, t, _, _ in group)
                run.passes.append((time.perf_counter(), flops))
                return fn(start, group, results)
            return wrapped

        self._patch(engine, "_run_cold_chunk", cold)
        self._patch(engine, "_run_resume_chunk", resume)
