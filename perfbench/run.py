"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, draws its weights and traffic
from the seed, warms up, measures for ``--seconds``, checks the served
tokens against the plain reference, and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), the device, and the numbers compared
with their limits.  Exits non-zero, printing no result, where the device
or the program is missing, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 3.0     # the profiled sub-window


def _env() -> None:
    """Keep every cache the run writes inside the checkout, at fixed paths
    (the program's kernels build into ``build/kernels/`` of the checkout
    by themselves).  Let PyTorch's allocator grow its segments rather than
    keep fixed blocks, as a server with a long-context pool runs it: the
    prompt passes' varying scores otherwise strand gigabytes between
    blocks, and a fill near the card's capacity runs out of memory."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    """Modules loaded under a forbidden top-level name, compared whole
    (``repro_torch`` is the port, ``repro`` the JAX package)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    _env()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    from harness import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device", 3)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.workload} needs {cell.chips} cards, found "
                    f"{torch.cuda.device_count()}", 3)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program is missing: {e}", 4)
    from harness import report
    result = report.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START,
                             trace_s=TRACE_S if args.trace else 0.0)
    bad = forbidden_modules()
    if bad:
        return fail(f"loaded in the measuring process: {bad}", 5)
    report.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
