"""Readings for a cell's ``correct`` limit, on the chip, in one process.

    python3 perfbench/calibrate.py --workload <name> --seconds <s> \
        --seeds <n,n,...> [--control] [--out <file.jsonl>]

Runs the cell once per seed as a benchmark run does (its own weights,
traffic, warm-up and window), then reads the widest logit gap of the
served tokens and, with ``--control``, the gap of the fp8 reference's
first choices at the same positions.  One JSON line a seed: the gaps, the
run's end-to-end metrics, its set-up and peak memory.  The limit is set
between the program's largest gap and the control's smallest (PERF.md)."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch
    from harness import report, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res = report.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                                  control=args.control)
            t1 = time.perf_counter()
            run = res.pop("_run")
            line = {"workload": cell.workload, "seed": seed,
                    "correct": res["correct"],
                    "gap": res["checks"]["logit_gap"]["value"],
                    "control_gap": res["_control_gap"],
                    "compared": res["_compared"],
                    "metrics": {k: v["value"] for k, v in
                                res["metrics"].items()},
                    "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                    "kind": res["device"]["kind"],
                    "power_limit_w": res["device"]["power_limit_w"],
                    "attempted": res["attempted"],
                    "requests": len(run.records),
                    "finished": sum(r.finished is not None
                                    for r in run.records.values()),
                    "decode_steps": len(run.decode_steps),
                    "setup_s": run.setup_s, "check_s": res["_check_s"],
                    "alloc_retries": res["_alloc_retries"],
                    "total_s": t1 - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            del run, res
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
