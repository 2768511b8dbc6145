"""Where the flash-attention kernel (K3) spends its time, on one GPU: the
kernel against variants of its own source with one feature taken out.

    PYTHONPATH=src python benchmarks/bench_torch_flash_ablation.py \
        [--variants base one_block_per_task ...] [--json reports/ablation.json]

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with exact
text replacements (the script fails if one no longer applies), built with
the port's ``nvcc`` flags into ``build/ablation/<variant>/``:

* ``base``: the kernel as it is;
* ``one_block_per_task``: a block per task, exiting after it (the grid is
  the task count instead of one persistent block per SM);
* ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns;
* ``exact_exp2``: ``exp2f`` in place of ``ex2.approx.ftz``;
* ``no_softmax``: the softmax skipped (P is the raw scores), so the time
  left is the loads and the products;
* ``one_tile``: every task stops after its first K/V tile, so the time
  left is each task's fixed cost.

Every variant is timed at the loss's shape (bf16, B=2, S=T=2048, H=24,
K=8, hd=128, causal) and at B=1, S=T=8192, beside
``scaled_dot_product_attention``: 30 calls rotating over 4 input sets,
captured in a CUDA graph, its replay timed with CUDA events.  The variants
that compute attention (``base``, ``one_block_per_task``, ``no_pingpong``,
``exact_exp2``) are also held against an fp32 reference at the loss's
shape: the mean signed and the mean absolute error of their bf16 output.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# variant -> [(old text, new text)] applied to flash_attention.cu
PATCHES = {
    "base": [],
    "one_block_per_task": [
        ("const int blocks = min(sch.n_tasks, sm_count());",
         "const int blocks = sch.n_tasks;")],
    "no_pingpong": [
        ("auto my_turn = [&] { hopper::named_barrier_sync(3 + wg, 256); };",
         "auto my_turn = [&] {};"),
        ("auto your_turn = [&] { hopper::named_barrier_arrive(4 - wg, 256); };",
         "auto your_turn = [&] {};")],
    "exact_exp2": [("hopper::exp2_ftz(", "exp2f(")],
    "no_softmax": [
        ("      softmax_tile(sc, masked(0)", "      if (0) softmax_tile(sc, masked(0)"),
        ("        softmax_tile(sc, masked(i", "        if (0) softmax_tile(sc, masked(i")],
    "one_tile": [
        ("  tk.n_tiles = (tk.n_keys + kBlockN - 1) / kBlockN;",
         "  tk.n_tiles = 1;")],
}
ACCURATE = ("base", "one_block_per_task", "no_pingpong", "exact_exp2")


def variant_source(src: str, name: str) -> str:
    for old, new in PATCHES[name]:
        if src.count(old) < 1:
            raise SystemExit(f"ablation {name}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_torch_flash_ablation: needs a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    spec = importlib.util.spec_from_file_location(
        "ab", ROOT / "benchmarks" / "bench_torch_attention_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    src = (build.CSRC / "flash_attention.cu").read_text()
    dirs = {}
    for name in args.variants:
        d = ROOT / "build" / "ablation" / name
        shutil.rmtree(d / "csrc", ignore_errors=True)
        (d / "csrc").mkdir(parents=True)
        for f in build.CSRC.glob("*.cuh"):
            shutil.copy(f, d / "csrc")
        (d / "csrc" / "flash_attention.cu").write_text(
            variant_source(src, name))
        dirs[name] = d
    with ThreadPoolExecutor(len(dirs)) as pool:
        futs = {n: pool.submit(build.build_all, ("flash_attention",),
                               d / "csrc", d / "lib")
                for n, d in dirs.items()}
        libs = {n: f.result()["flash_attention"] for n, f in futs.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, kh, hd = 24, 8, 128
    results = {"gpu": gpu, "shapes": {}}
    for label, b, s in (("loss B=2 S=T=2048", 2, 2048),
                        ("B=1 S=T=8192", 1, 8192)):
        sets = []
        for _ in range(4):
            q, k, v = cs.flash_inputs(torch, gen, b, s, s, h, kh, hd,
                                      torch.bfloat16)
            sets.append((q, k, v, torch.empty_like(q)))
        lib_sets = [tuple(x.transpose(1, 2) for x in st[:3]) for st in sets]
        flops = 4 * b * h * hd * s * (s + 1) / 2
        row = {"library_ms": ab.graph_ms(
            torch, lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), lib_sets, reps=30)}
        for name, path in libs.items():
            row[name] = ab.graph_ms(torch, ab.flash_launcher(torch, path),
                                    sets, reps=30)
        results["shapes"][label] = row
        for name, ms in row.items():
            print(f"[{label}] {name:20s} {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.0f} TFLOP/s")
        del sets, lib_sets
        torch.cuda.empty_cache()

    # error against an fp32 reference at the loss's shape
    q, k, v = cs.flash_inputs(torch, gen, 2, 2048, 2048, h, kh, hd,
                              torch.bfloat16)
    qf = q.float().reshape(2, 2048, kh, h // kh, hd)
    sc = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    causal = torch.ones(2048, 2048, dtype=torch.bool, device="cuda").tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    ref = torch.einsum("bkgst,btkh->bskgh", torch.softmax(sc, -1),
                       v.float()).reshape(2, 2048, h, hd)
    del sc
    results["error_vs_fp32"] = {}
    for name in (n for n in ACCURATE if n in libs):
        out = ab.flash_launcher(torch, libs[name])(q, k, v,
                                                   torch.empty_like(q))
        d = out.float() - ref
        err = {"mean_signed": d.mean().item(), "mean_abs": d.abs().mean().item(),
               "max_abs": d.abs().max().item()}
        results["error_vs_fp32"][name] = err
        print(f"[error vs fp32] {name:20s} mean signed "
              f"{err['mean_signed']:+.3e}, mean abs {err['mean_abs']:.4e}, "
              f"max abs {err['max_abs']:.4e}")
    print(gpu)
    print(json.dumps(results))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
