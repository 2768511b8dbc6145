"""The program's own spans and counters over a cell's window, and what its
tracer costs, on the chip.

    python3 perfbench/tracer_states.py --workload <name> --seeds <n>,<m> \
        --seconds <s> [--states off,on,traced] [--out <file.jsonl>]

One process; for each seed its weights, and for each state a fresh
cluster, the mix's warm-up and fill, and a window of ``--seconds``:

* ``off``: ``cluster.tracer`` off, no profiler (a ``--trace 0`` run);
* ``on``: the tracer on from the fill to the close, no profiler;
* ``traced``: the tracer on and the profiler's sub-window of a
  ``--trace 1`` run;
* ``profiled``: the profiler's sub-window with the tracer off (what a
  ``--trace 1`` run of ``run.py`` traces).

One JSON line a state and seed: the window's output tokens a second and
the harness's mean decode-step span (every state); with the tracer on,
the readers of ``harness/spans.py`` (the decode step's dispatch, wait and
bookkeeping, the prompt pass's, routing attempts per placement, queue
wait, the decoders' resident share, the prefix cache's counters); with
the profiler, the device's idle share, K1's and K2's roofline shares (the
benchmark's own readers), the idle gaps named by the innermost range (the
program's spans among the harness's where the tracer is on) and the
offset of each span's start on ``perf_counter_ns`` from its range's on
the profiler's clock.  No served token is judged here."""
from __future__ import annotations

import time

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
STATES = ("off", "on", "traced", "profiled")
TRACE_S = 3.0       # the profiled sub-window, as run.py's


def offsets(values) -> dict:
    """Median, quartile spread and range of integer nanoseconds, exact
    (offsets near 1.8e18 ns are past a float's integer precision)."""
    if len(values) < 2:
        return {"n": len(values)}
    base = min(values)
    q1, q2, q3 = statistics.quantiles([v - base for v in values], n=4)
    return {"n": len(values), "median_ns": base + round(q2),
            "iqr_ns": q3 - q1, "range_ns": max(values) - base}


def program_line(run, spans) -> dict:
    """The readings of the program's spans and counters over the window."""
    ms = {name: spans.mean_ms(run, name) for name in (
        "decode.step", "decode.dispatch", "decode.wait", "decode.bookkeep",
        "prefill.pass", "prefill.dispatch", "prefill.wait",
        "prefill.batch", "router.route", "cluster.tick")}
    parts = [ms["decode.dispatch"], ms["decode.wait"], ms["decode.bookkeep"]]
    return {
        "span_ms": ms,
        "decode_parts_ms": None if None in parts else sum(parts),
        "router.attempts_per_placement": spans.attempts_per_placement(run),
        "cluster.queue_wait_p50_ms": spans.queue_wait_p50_ms(run),
        "router.resident_share": spans.resident_share(run),
        "deltas": {k: spans.delta(run, k) for k in (
            "route_attempts", "placements", "admitted_blocks",
            "transferred_blocks", "lookups", "hits", "evictions")},
        "spans_recorded": len(run.program_spans)}


def trace_line(run, report, readers, spans, events) -> dict:
    """The readings of the profiled sub-window."""
    idle = dict(run.trace.idle)
    total = sum(idle.values())
    out = {"device.idle_share": readers.idle_share(run),
           "k1_roofline": report.read_metric("k1_roofline", run),
           "k2_roofline": report.read_metric("k2_roofline", run),
           "busy_s": run.trace.busy_s, "window_s": run.trace.window_s,
           "idle_gaps": sorted(idle.items(), key=lambda x: -x[1]),
           "harness_label_share": (idle.get("decode", 0.0)
                                   + idle.get("prefill", 0.0)) / total
           if total > 0 else None}
    if events:
        offs = spans.clock_offsets(run.program_spans, events,
                                   run.traced_from)
        out["clock_offset_ns"] = offsets(offs)
        out["ranges"] = len(events)
    return out


def measure(h, state, seconds, trace_s=TRACE_S) -> dict:
    """One window of ``state`` on a fresh cluster of ``h`` (a profiled
    sub-window of ``trace_s``)."""
    import torch
    from torch.autograd import DeviceType

    from harness import readers, report, serve, spans, trace
    traffic = h.traffic(seconds)
    c = h.build()
    h.warm(traffic)
    c.tracer.enabled = state in ("on", "traced")
    events = []
    reduce = trace.reduce

    def keep_ranges(prof, ranges, top):
        events.extend((e.name(), e.start_ns())
                      for e in prof.profiler.kineto_results.events()
                      if e.name() in spans.PROGRAM_SPANS
                      and e.device_type() == DeviceType.CPU)
        return reduce(prof, ranges, top)
    stats, ranges = serve._stats, serve.RANGES
    serve._stats = lambda engine: {**stats(engine), **spans.counters(c)}
    if c.tracer.enabled:
        serve.RANGES = ranges + spans.PROGRAM_SPANS
    trace.reduce = keep_ranges
    try:
        run = h.run(traffic, seconds, time.perf_counter(),
                    trace_s if state in ("traced", "profiled") else 0.0)
    finally:
        serve._stats, serve.RANGES, trace.reduce = stats, ranges, reduce
    run.device_kind = (torch.cuda.get_device_name()
                       if h.device.type == "cuda" else "cpu")
    run.program_spans = [s for s in c.tracer.spans if s is not None]
    line = {"state": state,
            "output_tokens_per_s": readers.tokens_in_window(run)
            / (run.w1 - run.w0),
            "harness_step_ms": readers.mean_ms(
                readers.spans_in_window(run, "decode")),
            "decode_steps": len(readers.spans_in_window(run, "decode"))}
    if c.tracer.enabled:
        line.update(program_line(run, spans))
        if line["decode_parts_ms"] and line["harness_step_ms"]:
            line["parts_over_harness_step"] = (line["decode_parts_ms"]
                                               / line["harness_step_ms"])
    if run.trace is not None:
        line.update(trace_line(run, report, readers, spans, events))
    h.free()
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--states", default="off,on,traced")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    states = args.states.split(",")
    if not set(states) <= set(STATES):
        p.error(f"--states takes {','.join(STATES)}")
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch
    from harness import spec
    from harness.report import power_limit_w
    from harness.serve import Harness
    if not torch.cuda.is_available():
        print("tracer_states: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    kind = {"kind": torch.cuda.get_device_name(),
            "power_limit_w": power_limit_w()}
    for seed in (int(s) for s in args.seeds.split(",")):
        h = Harness(cell, seed, "cuda")
        for state in states:
            line = {"workload": cell.workload, "seed": seed,
                    **measure(h, state, args.seconds), **kind}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            gc.collect()
            torch.cuda.empty_cache()
        del h
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
