"""The knee of an open-loop cell: the highest offered rate that the
system serves with no growing backlog, found once, on the chip.

    python3 perfbench/sweep.py --workload <name> --rates 2,3,4 \
        --seconds <s> --seeds <n>,<m> [--out <file.jsonl>] [--write]

One process; for each seed its weights, and for each rate a fresh cluster,
the mix's warm-up and lead-in, and a window of ``--seconds``.  One JSON
line a rate and seed: requests due in the window, those still waiting for
a first token at its close, median TTFT of the window's first and second
halves (a backlog that grows shows as the second above the first), the
TTFT p90, the ITL p99 and the tokens a second.  No served token is judged
here.  The knee is the highest rate that, with every lower rate swept, is
sustained on every seed (:func:`sustained`); ``--write`` sets the mix's
``rate_per_s`` in its traffic file to ``LOAD`` times the knee."""
from __future__ import annotations

import time

import argparse
import gc
import json
import sys
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
LOAD = 0.8          # the cell's share of the knee
MAX_WAITING = 0.05  # of the requests due, waiting at the close (at least 2)
MAX_GROWTH = 1.5    # second half's median TTFT over the first half's


def ms(seconds):
    return None if seconds is None else 1e3 * seconds


def summary(run, readers) -> dict:
    half = (run.w0 + run.w1) / 2
    due = [r for r in run.records.values() if run.w0 <= r.due < run.w1]
    waiting = [r for r in due if r.first is None or r.first > run.w1]

    def med(rs):
        v = [(min(r.first, run.w1) if r.first else run.w1) - r.due for r in rs]
        return readers.percentile(v, 50)
    return {"due": len(due), "waiting_at_close": len(waiting),
            "ttft_p50_first_half_s": med([r for r in due if r.due < half]),
            "ttft_p50_second_half_s": med([r for r in due if r.due >= half]),
            "ttft_p50_ms": ms(readers.percentile(readers.ttfts(run), 50)),
            "ttft_p90_ms": ms(readers.percentile(readers.ttfts(run), 90)),
            "itl_p99_ms": ms(readers.percentile(readers.itls(run), 99)),
            "output_tokens_per_s": readers.tokens_in_window(run)
            / (run.w1 - run.w0),
            "decode_step_ms": readers.mean_ms(
                readers.spans_in_window(run, "decode"))}


def sustained(line: dict) -> bool:
    """No growing backlog: few requests still waiting at the close, and the
    window's second half no slower to a first token than its first."""
    waiting_ok = line["waiting_at_close"] <= max(2, MAX_WAITING * line["due"])
    first, second = (line["ttft_p50_first_half_s"],
                     line["ttft_p50_second_half_s"])
    return (waiting_ok and first is not None and second is not None
            and second <= MAX_GROWTH * first)


def knee(lines) -> Optional[float]:
    """The highest rate sustained on every seed, as is every lower rate
    swept (None where the lowest is not)."""
    best = None
    for rate in sorted({ln["rate_per_s"] for ln in lines}):
        if not all(sustained(ln) for ln in lines if ln["rate_per_s"] == rate):
            break
        best = rate
    return best


def write_rate(workload: str, rate: float) -> Path:
    from harness import spec
    entry = next(w for w in spec.load_manifest()["workloads"]
                 if w["name"] == workload)
    path = spec.BENCH_DIR / "traffic" / f"{entry['traffic']}.json"
    with open(path) as f:
        mix = json.load(f)
    mix["rate_per_s"] = rate
    with open(path, "w") as f:
        json.dump(mix, f, indent=2)
        f.write("\n")
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="1")
    p.add_argument("--out", default="")
    p.add_argument("--write", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch
    from harness import readers, spec
    from harness.serve import Harness
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        h = Harness(cell, seed, "cuda")
        for rate in (float(r) for r in args.rates.split(",")):
            cell.traffic["rate_per_s"] = rate
            traffic = h.traffic(args.seconds)
            h.build()
            h.warm(traffic)
            run = h.run(traffic, args.seconds, time.perf_counter())
            line = {"workload": cell.workload, "rate_per_s": rate,
                    "seed": seed, **summary(run, readers),
                    "kind": torch.cuda.get_device_name()}
            line["sustained"] = sustained(line)
            lines.append(line)
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            h.free()
            del run
            gc.collect()
        del h
        gc.collect()
        torch.cuda.empty_cache()
    k = knee(lines)
    print(json.dumps({"knee_per_s": k, "rate_per_s":
                      None if k is None else round(LOAD * k, 3)}), flush=True)
    if args.write and k is not None:
        print(f"sweep: wrote {write_rate(cell.workload, round(LOAD * k, 3))}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
