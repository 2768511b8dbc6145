"""One run of a cell, start to result line."""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Optional

import torch

from harness import check, readers
from harness.load import load_module
from harness.serve import Harness
from harness.spec import BENCH_DIR, Cell


def read_metric(name: str, run) -> Optional[float]:
    value = load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def host_probe_ms() -> float:
    """A fixed piece of pure-Python work, timed: the host's own speed,
    which sets a host-bound step, beside the run's numbers."""
    t0 = time.perf_counter()
    sum(i * i for i in range(200_000))
    return 1e3 * (time.perf_counter() - t0)


def host_split(run) -> dict:
    """Where the window's host time went, by the harness's spans."""
    out = {"decode_steps": len(readers.spans_in_window(run, "decode")),
           "decode_step_ms": readers.mean_ms(
               readers.spans_in_window(run, "decode"))}
    for name in ("route", "prefill", "admit", "decode"):
        out[f"{name}_s"] = sum(b - a for a, b in
                               readers.spans_in_window(run, name))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, trace_s: float = 0.0, registry=None,
             control: bool = False) -> dict:
    """Set up, measure, read the metrics, free the program's state and
    judge what it served.  ``control`` also reads the fp8 control's gap
    (not a benchmark run's work).  ``registry`` stands in for the
    program's config (the tests' reduced models)."""
    marks = [("start", t_start), ("imports", time.perf_counter())]
    h = Harness(cell, seed, device, registry)
    marks.append(("weights", time.perf_counter()))
    traffic = h.traffic(seconds)
    h.build()
    marks.append(("cluster", time.perf_counter()))
    h.warm(traffic)
    marks.append(("warm-up", time.perf_counter()))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    probe = [host_probe_ms()]
    run = h.run(traffic, seconds, t_start, trace_s if trace else 0.0,
                drain=cell.limits["requests"])
    probe.append(host_probe_ms())
    marks.append(("traffic fill", run.w0))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    retries = (torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
               if dev.type == "cuda" else 0)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run.device_kind = kind
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["name"] in cell.metric_names(trace):
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    records = list(run.records.values())
    attempted = sum(1 for r in records
                    if r.due < run.w1 and (r.finished is None
                                           or r.finished >= run.w0))
    failed = sum(1 for r in records
                 if r.finished is not None and not r.output)
    h.free()
    t_check = time.perf_counter()
    in_window = [r for r in records
                 if r.finished is not None and r.finished >= run.w0]
    chosen = check.sample(in_window or records, cell.limits["requests"], seed)
    gaps = check.logit_gaps(h.arch.reference, h.weights,
                            cell.config["model"], chosen, control)
    limit = cell.limits["logit_gap"]
    correct = bool(chosen) and gaps["gap"] <= limit and failed == 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if dev.type == "cuda"
                   else None}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {"logit_gap": {"value": gaps["gap"], "limit": limit}}
    out["_compared"] = (len(chosen), gaps["tokens"])
    out["_check_s"] = time.perf_counter() - t_check
    out["_setup"] = [(b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])]
    out["_alloc_retries"] = retries
    out["_host"] = dict(host_split(run), probe_ms=probe)
    if run.trace is not None:
        out["_trace"] = {
            "device_ops": sum(c for _, c in run.trace.ops.values()),
            "traced_decode_steps": len(run.traced_steps),
            "layers": h.arch.decode_attention_layers(cell.config["model"]),
            "k1_launches": run.trace.kernel("dense_split_kernel")[1],
            "k2_launches": run.trace.kernel("paged_split_kernel")[1]}
    out["_control_gap"] = gaps["control_gap"]
    out["_run"] = run
    return out


def emit(result: dict) -> None:
    """The numbers compared beside their limits as the last lines on
    standard error, then the result line last on standard output."""
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    print("set-up " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                result.get("_setup", [])), file=sys.stderr)
    print(f"allocator retries {result.get('_alloc_retries', 0)}",
          file=sys.stderr)
    if "_host" in result:
        print(f"host {json.dumps(result['_host'])}", file=sys.stderr)
    if "_trace" in result:
        print(f"trace {result['_trace']}", file=sys.stderr)
    n, toks = result.get("_compared", (0, 0))
    print(f"compared {toks} served tokens of {n} requests", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
