"""The readers of the program's own spans and counters
(``harness/spans.py``) on runs built by hand, the trace's reducer naming
an idle gap after a program span, and ``tracer_states.py`` driving the
tiny cells on the CPU."""
import pytest

from harness import spans, trace
from harness.serve import RANGES, TOP_RANGES, Run
from repro_torch.serving.tracing import Span

PHI = {"num_hidden_layers": 2}
NS = 1_000_000_000


def _ns(seconds):
    return int(round(seconds * NS))


def _span(name, a, b, rid=None, parent=-1):
    return Span(name, _ns(a), _ns(b), parent, rid)


def _run(program_spans=None, opened=None, closed=None, traced_from=None):
    run = Run(PHI, {}, "cuda")
    run.w0, run.w1 = 10.0, 20.0
    run.traced_from = traced_from
    if program_spans is not None:
        run.program_spans = program_spans
    run.stats_open = {"total_blocks": 0.0, **(opened or {})}
    run.stats_close = {"total_blocks": 0.0, **(closed or {})}
    return run


def test_span_means_read_the_window():
    run = _run([_span("decode.dispatch", 9.9, 9.95),     # before: out
                _span("decode.dispatch", 10.0, 10.04),
                _span("decode.dispatch", 15.0, 15.06),
                _span("decode.wait", 15.06, 15.065),
                _span("decode.dispatch", 20.0, 20.1),     # at the close
                None])                                    # still open
    assert spans.mean_ms(run, "decode.dispatch") == pytest.approx(50.0)
    assert spans.mean_ms(run, "decode.wait") == pytest.approx(5.0)
    assert spans.mean_ms(run, "prefill.dispatch") is None


def test_attempts_per_placement_and_resident_share():
    run = _run(opened={"route_attempts": 100.0, "placements": 10.0,
                       "admitted_blocks": 40.0, "transferred_blocks": 30.0},
               closed={"route_attempts": 340.0, "placements": 16.0,
                       "admitted_blocks": 100.0, "transferred_blocks": 54.0})
    assert spans.attempts_per_placement(run) == pytest.approx(240 / 6)
    assert spans.resident_share(run) == pytest.approx(1 - 24 / 60)
    assert spans.delta(run, "lookups") is None


def test_queue_wait_stops_where_the_profiler_opened():
    waits = [_span("cluster.queue", 9.0, 9.5, "a"),      # placed before
             _span("cluster.queue", 9.9, 10.1, "b"),     # 0.2
             _span("cluster.queue", 11.0, 11.6, "c"),    # 0.6
             _span("cluster.queue", 13.0, 14.0, "d"),    # 1.0
             _span("cluster.queue", 14.0, 16.5, "e")]    # placed traced
    assert spans.queue_wait_p50_ms(_run(waits)) == pytest.approx(800.0)
    assert spans.queue_wait_p50_ms(_run(waits, traced_from=15.0)) \
        == pytest.approx(600.0)


@pytest.mark.parametrize("reader", [
    "attempts_per_placement", "queue_wait_p50_ms", "resident_share"])
def test_a_program_without_them_reads_nothing(reader):
    """An older program keeps no such span or counter: nothing, no error."""
    assert getattr(spans, reader)(_run()) is None
    assert spans.mean_ms(_run(), "decode.wait") is None


def test_clock_offsets_pair_ranges_with_spans():
    off = 1_700_000_000 * NS
    sp = [_span("cluster.tick", 10.0, 10.1), _span("decode.step", 10.01, 10.09),
          _span("cluster.queue", 9.0, 10.05),            # no range
          _span("cluster.tick", 12.0, 12.1), _span("decode.step", 12.01, 12.09)]
    ev = [("decode.step", _ns(12.01) - off - 300),
          ("cluster.tick", _ns(12.0) - off - 200)]
    assert spans.clock_offsets(sp, ev, 11.0) == [off + 200, off + 300]
    assert spans.clock_offsets(sp, ev[:1], 11.0) == []   # names differ


class _Event:
    def __init__(self, name, a, b, cuda=False):
        self._n, self._a, self._b, self._cuda = name, a, b, cuda

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def test_a_program_span_names_the_idle_gap():
    """A program span nested in the harness's ``decode`` range names the
    gaps inside it; without the program's names the harness's does."""
    events = [_Event("cluster_step", 0, 100), _Event("decode", 10, 90),
              _Event("decode.step", 12, 88),
              _Event("decode.dispatch", 12, 60), _Event("decode.wait", 60, 85),
              _Event("gemm", 14, 20, cuda=True),
              _Event("argmax", 62, 84, cuda=True)]
    named = trace.reduce(_Prof(events), RANGES + spans.PROGRAM_SPANS,
                         TOP_RANGES)
    assert named.idle == pytest.approx({"cluster_step": 30e-9,
                                        "decode.dispatch": 42e-9})
    assert named.busy_s == pytest.approx(28e-9)
    plain = trace.reduce(_Prof(events), RANGES, TOP_RANGES)
    assert plain.idle == pytest.approx({"cluster_step": 30e-9,
                                        "decode": 42e-9})
    assert plain.busy_s == named.busy_s


@pytest.mark.parametrize("kind,impl", [("open", "pallas"),
                                       ("closed", "paged")])
def test_tiny_cell_reads_every_span_metric(kind, impl):
    """The tiny cells on the CPU with the tracer on and a profiled
    sub-window: every reading the tool makes of the program is there."""
    import torch
    import tiny
    import tracer_states
    from harness.serve import Harness
    cell = tiny.cell(kind, impl=impl)
    if kind == "closed":      # clients that outlast the window
        cell.traffic["requests_per_client"] = 40
    h = Harness(cell, 11, "cpu", tiny.registry())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # steps that keep pace beside other workers
    try:
        line = tracer_states.measure(h, "traced", 6.0, trace_s=2.0)
    finally:
        torch.set_num_threads(threads)
    ms = line["span_ms"]
    for name in ("decode.dispatch", "decode.wait", "decode.bookkeep",
                 "prefill.dispatch", "decode.step", "router.route"):
        assert ms[name] is not None and ms[name] > 0, name
    assert line["router.attempts_per_placement"] >= 1.0
    assert line["cluster.queue_wait_p50_ms"] > 0
    share = line["router.resident_share"]
    if kind == "open":        # shared system prompts stay resident
        assert 0 < share < 1
    else:                     # unshared prompts: every block moves
        assert share == 0.0
    assert line["deltas"]["lookups"] > 0
    assert line["parts_over_harness_step"] == pytest.approx(1.0, abs=0.1)
    assert line["clock_offset_ns"]["n"] == line["ranges"] > 0
    assert line["device.idle_share"] is None       # no device operations
    assert line["k1_roofline"] is None and line["k2_roofline"] is None
    off = tracer_states.measure(h, "off", 2.0)
    assert "span_ms" not in off and off["output_tokens_per_s"] > 0
