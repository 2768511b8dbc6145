"""The port's span recorder and its counters, on the CPU.

A ``DisaggregatedCluster`` of the reduced phi4-mini serves a fixed stream
with ``cluster.tracer`` on: the span tree (each span inside its parent,
the parents the recorder documents), the request ids spans carry, the
served tokens (the same with the tracer on and off), the counters against
hand counts, and the spans as ranges on a CPU ``torch.profiler``
timeline, nested as the recorder nests them.  An off tracer records
nothing and hands out one shared no-op context.
"""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.disagg import (DisaggregatedCluster,  # noqa: E402
                                        ServeRequest)
from repro_torch.serving.engine import PrefillEngine  # noqa: E402
from repro_torch.serving.tracing import Tracer  # noqa: E402

torch.set_num_threads(1)

# the span each span runs inside (None: a root)
PARENT = {"cluster.tick": None, "cluster.schedule": "cluster.tick",
          "router.route": "cluster.schedule",
          "prefill.batch": "cluster.schedule",
          "prefill.match": "prefill.batch", "prefill.pass": "prefill.batch",
          "prefill.dispatch": "prefill.pass", "prefill.wait": "prefill.pass",
          "prefill.store": "prefill.batch",
          "decode.admit": "cluster.schedule", "decode.step": "cluster.tick",
          "decode.dispatch": "decode.step", "decode.wait": "decode.step",
          "decode.bookkeep": "decode.step",
          "cluster.telemetry": "cluster.tick", "cluster.queue": None}
IMPLS = ["pallas", "paged"]


@pytest.fixture(scope="module")
def cpu_model():
    model = Model(get_reduced("phi4-mini-3.8b"))
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    return model, params


def _prompt(model, template, n=40, tail=()):
    vocab = model.cfg.vocab_size
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)] \
        + list(tail)


def _stream(model, n=6):
    """Three shared prefixes of 40 tokens, each request its own tail."""
    return [(f"r{i}", _prompt(model, i % 3, tail=[5 + i] * (3 + i)), 3)
            for i in range(n)]


def _serve(cpu_model, stream, traced, **kw):
    model, params = cpu_model
    kw.setdefault("num_decode", 2)
    kw.setdefault("slots_per_worker", 2)
    c = DisaggregatedCluster(model, params, max_len=96, adaptive=False,
                             cache_ttl=None, device="cpu", **kw)
    c.tracer.enabled = traced
    for rid, toks, max_new in stream:
        c.submit(ServeRequest(rid, list(toks), max_new_tokens=max_new))
    c.run_until_done()
    return c


@pytest.fixture(scope="module", params=IMPLS)
def served(request, cpu_model):
    model, _ = cpu_model
    stream = _stream(model)
    on = _serve(cpu_model, stream, True, decode_impl=request.param)
    off = _serve(cpu_model, stream, False, decode_impl=request.param)
    return stream, on, off


def test_span_tree(served):
    _, c, _ = served
    spans = c.tracer.spans
    assert None not in spans
    assert set(s.name for s in spans) == set(PARENT)
    for s in spans:
        assert s.t0 <= s.t1
        want = PARENT[s.name]
        if want is None:
            assert s.parent == -1, s
            continue
        p = spans[s.parent]
        assert p.name == want, (s, p)
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
    for s in spans:
        if s.name.startswith("decode.") and s.name != "decode.admit":
            step = s if s.name == "decode.step" else spans[s.parent]
            assert spans[step.parent].name == "cluster.tick"
    # a step's children follow one another: dispatch, wait, bookkeep
    kids = {}
    for s in spans:
        if s.name in ("decode.dispatch", "decode.wait", "decode.bookkeep"):
            kids.setdefault(s.parent, []).append(s)
    assert kids and all([k.name for k in v] == ["decode.dispatch",
                                                "decode.wait",
                                                "decode.bookkeep"]
                        and v[0].t1 <= v[1].t0 and v[1].t1 <= v[2].t0
                        for v in kids.values())


def test_request_ids(served):
    stream, c, _ = served
    ids = [rid for rid, _, _ in stream]
    spans = c.tracer.spans

    def of(name):
        return [s for s in spans if s.name == name]
    assert sorted(s.rid for s in of("cluster.queue")) == sorted(ids)
    assert sorted(s.rid for s in of("decode.admit")) == sorted(ids)
    routed = Counter(s.rid for s in of("router.route"))
    assert set(routed) == set(ids)
    assert sum(routed.values()) == c.route_attempts.value
    # four slots for six requests: two wait, and are routed again
    assert sum(routed.values()) > len(ids)
    rows = [r for s in of("prefill.pass") for r in s.rid]
    assert sorted(rows) == sorted(ids)
    assert {s.tag for s in of("prefill.pass")} == {"cold", "resumed"}
    batches = [r for s in of("prefill.batch") for r in s.rid]
    assert sorted(batches) == sorted(ids)
    for s in of("cluster.queue"):
        req = next(r for r in c.done if r.request_id == s.rid)
        assert s.t0 == req.submit_ns and s.t1 > s.t0


def test_tokens_do_not_depend_on_the_tracer(served):
    _, on, off = served
    assert off.tracer.spans == []
    got = {r.request_id: r.output for r in on.done}
    want = {r.request_id: r.output for r in off.done}
    assert got == want and len(got) == 6
    assert on.prefill.stats.as_dict().keys() == off.prefill.stats.as_dict().keys()
    for key in ("lookups", "hits", "evictions"):
        assert getattr(on.prefill.stats, key) == getattr(off.prefill.stats,
                                                         key)
    assert on.route_attempts.value == off.route_attempts.value


def test_off_tracer_records_nothing():
    tr = Tracer()
    a, b = tr.span("decode.step"), tr.span("router.route", rid="r0")
    assert a is b
    with a:
        with b:
            pass
    tr.record("cluster.queue", 1, 2, rid="r0")
    assert tr.spans == []
    tr.enabled = True
    live = tr.span("decode.step")
    assert live is not tr.span("decode.step")
    with live:
        tr.record("cluster.queue", 1, 2, rid="r0")
    assert [s.name for s in tr.spans] == ["decode.step", "cluster.queue"]
    assert tr.spans[1].parent == -1


@pytest.mark.parametrize("max_new", [1, 2, 4])
def test_route_attempts_count_retries(cpu_model, max_new):
    """One decoder of one slot, three requests at once, each ``max_new``
    decode steps: the first is placed on its first attempt; each other is
    routed again every tick until the slot frees at the end of the tick
    whose step finished the request ahead of it."""
    model, _ = cpu_model
    stream = [(f"r{i}", _prompt(model, i), max_new) for i in range(3)]
    c = _serve(cpu_model, stream, True, num_decode=1, slots_per_worker=1)
    retries = max_new + 2 * max_new      # r1 waits one request, r2 two
    assert c.placements.value == 3
    assert c.route_attempts.value == 3 + retries
    assert len([s for s in c.tracer.spans if s.name == "router.route"]) \
        == 3 + retries
    text = c.metrics.export_text()
    assert f"route_attempts {3.0 + retries}" in text
    assert "placements 3.0" in text


def test_prefix_cache_counters(cpu_model):
    """Five prompts one at a time through a prefix cache of two entries:
    a, b, c (cold; c's store evicts a), b' (b's two blocks and a third of
    its own: a hit, and its store evicts c), a (a miss: a is gone; its
    store evicts b)."""
    model, params = cpu_model
    eng = PrefillEngine(model, params, max_len=96, cache_entries=2,
                        device="cpu")
    st = eng.stats
    want = [(1, 0, 0), (2, 0, 0), (3, 0, 1), (4, 1, 2), (5, 1, 3)]
    prompts = [_prompt(model, 0), _prompt(model, 1), _prompt(model, 2),
               _prompt(model, 1, tail=[9] * 10), _prompt(model, 0)]
    for toks, counts in zip(prompts, want):
        eng.prefill_many([(toks, None, None)])
        assert (st.lookups, st.hits, st.evictions) == counts
    assert st.reused_blocks == 2        # b' resumed from b's two blocks
    assert len(eng._cache) == 2


def test_resident_blocks(cpu_model):
    """Two prompts on one decoder sharing two of their three blocks: the
    second moves only the block the decoder does not hold."""
    model, _ = cpu_model
    a = _prompt(model, 0, n=48)
    b = a[:32] + _prompt(model, 1, n=20)
    c = _serve(cpu_model, [("a", a, 2)], False, num_decode=1)
    dec = c.decoders[0]
    assert (dec.admitted_blocks, dec.transferred_blocks) == (3, 3)
    c.submit(ServeRequest("b", b, max_new_tokens=2))
    c.run_until_done()
    assert (dec.admitted_blocks, dec.transferred_blocks) == (6, 4)
    assert [r.transfer_blocks for r in c.done] == [3, 1]


def _nest(items):
    """(name, parent name) of each interval, in start order; the parent
    is the innermost earlier interval that holds it."""
    items = sorted(items, key=lambda x: (x[1], -x[2]))
    out, stack = [], []
    for name, a, b in items:
        while stack and stack[-1][2] < b:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


def test_spans_on_the_profiler_timeline(cpu_model):
    model, params = cpu_model
    c = DisaggregatedCluster(model, params, num_decode=2, slots_per_worker=2,
                             max_len=96, adaptive=False, cache_ttl=None,
                             device="cpu", decode_impl="paged")
    c.tracer.enabled = True
    for rid, toks, max_new in _stream(model, 5):
        c.submit(ServeRequest(rid, list(toks), max_new_tokens=max_new))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        c.run_until_done()
    names = set(PARENT) - {"cluster.queue"}
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    spans = [s for s in c.tracer.spans if s.name in names]
    assert len(events) == len(spans) > 0
    assert _nest(events) == _nest([(s.name, s.t0, s.t1) for s in spans])
    for s in spans:
        want = PARENT[s.name]
        assert (c.tracer.spans[s.parent].name if s.parent >= 0
                else None) == want
