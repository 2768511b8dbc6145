"""The tile and split choices of K3's fp32 body, on one GPU: the body
against variants of its own source, and its split plan against other key
chunks.

    PYTHONPATH=src python benchmarks/bench_torch_flash_f32_sweep.py \
        [--variants base bn64 ...] [--json reports/f32_sweep.json]

Each variant is ``src/repro_torch/csrc/flash_attention_f32.cuh`` with
exact text replacements (the script fails if one no longer applies),
built with the port's ``nvcc`` flags into ``build/f32_sweep/<variant>/``,
all builds at once:

* ``base``: the body as it is (32-key K/V tiles, 64 at hd 32; two blocks
  an SM in ``__launch_bounds__``);
* ``bn64``: 64-key tiles at every head dim (twice the keys a thread scores
  and twice the shared memory a block);
* ``bn16``: half the keys of ``base`` (16, 32 at hd 32);
* ``one_block_an_sm``: ``__launch_bounds__`` asks for one block an SM, so
  ptxas may use up to 255 registers a thread.

Every variant is timed at ``bench_kernels.py``'s shape (B=1, S=T=512,
H=8, K=2, hd=64, causal) and at the loss's shape (B=2, S=T=2048, H=24,
K=8, hd=128, causal), in fp32, with ``split_plan``'s chunk and with the
other key chunks that ``SHAPES`` lists (each a power of two times 64),
through ``flash_attention_f32_launch`` directly, with scratch from
``torch.empty`` where it splits.  Each (variant, chunk) is first held against the plain
version at 2e-5, then timed as ``bench_torch_attention_ab.py`` times a
version: 60 launches over input sets past the L2 captured in a CUDA
graph, its replay timed with CUDA events.  The plain version and
``scaled_dot_product_attention`` (TF32 off) are timed once a shape.  The
ptxas report (registers, spills) of each variant's fp32 kernels is
printed.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# variant -> [(old text, new text)] applied to flash_attention_f32.cuh
PATCHES = {
    "base": [],
    "bn64": [("static constexpr int BN = HD <= 32 ? 64 : 32;",
              "static constexpr int BN = 64;")],
    "bn16": [("static constexpr int BN = HD <= 32 ? 64 : 32;",
              "static constexpr int BN = HD <= 32 ? 32 : 16;")],
    "one_block_an_sm": [("__launch_bounds__(kF32Threads, 2)",
                         "__launch_bounds__(kF32Threads, 1)")],
}
# (label, B, S = T, H, K, hd, input sets, key chunks besides the plan's)
SHAPES = (("bench B=1 S=T=512 H=8 K=2 hd=64", 1, 512, 8, 2, 64, 58,
           (64, 128, 256, 512)),
          ("loss B=2 S=T=2048 H=24 K=8 hd=128", 2, 2048, 24, 8, 128, 4,
           (512, 1024, 2048)))


def variant_source(src: str, name: str) -> str:
    for old, new in PATCHES[name]:
        if src.count(old) < 1:
            raise SystemExit(f"f32 sweep {name}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def f32_launcher(torch, lib_path, chunk):
    """Launch the fp32 body in ``lib_path`` with ``chunk`` keys a task."""
    fn = ctypes.CDLL(str(lib_path)).flash_attention_f32_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

    def launch(q, k, v, out):
        b, s, h, hd = q.shape
        t, kh = k.shape[1], k.shape[2]
        n_rb = -(-s * (h // kh) // 64)
        chunks = -(-t // chunk)
        scratch = torch.empty(b * kh * n_rb * chunks * 64 * (hd + 2)
                              if chunks > 1 else 0, dtype=torch.float32,
                              device="cuda")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), b, s, t, kh, h // kh, hd, 1, chunk,
                chunks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_attention_f32_launch: {rc}")
        return out
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_torch_flash_f32_sweep: needs a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    spec = importlib.util.spec_from_file_location(
        "ab", ROOT / "benchmarks" / "bench_torch_attention_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    src = (build.CSRC / "flash_attention_f32.cuh").read_text()
    dirs = {}
    for name in args.variants:
        d = ROOT / "build" / "f32_sweep" / name
        shutil.rmtree(d / "csrc", ignore_errors=True)
        shutil.copytree(build.CSRC, d / "csrc")
        (d / "csrc" / "flash_attention_f32.cuh").write_text(
            variant_source(src, name))
        dirs[name] = d
    with ThreadPoolExecutor(len(dirs)) as pool:
        futs = {n: pool.submit(build.build_all, ("flash_attention",),
                               d / "csrc", d / "lib")
                for n, d in dirs.items()}
        libs = {n: f.result()["flash_attention"] for n, f in futs.items()}
    for name, path in libs.items():
        for line in cs.ptxas_lines(path.with_suffix(".log").read_text(),
                                   "flash_f32_kernel"):
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"[ptxas] {name}: {line}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"gpu": gpu, "shapes": {}}
    for label, b, s, h, kh, hd, n_sets, chunks in SHAPES:
        sets = []
        for _ in range(n_sets):
            q, k, v = cs.flash_inputs(torch, gen, b, s, s, h, kh, hd,
                                      torch.float32)
            sets.append((q, k, v, torch.empty_like(q)))
        want = fops.flash_attention_plain(*sets[0][:3])
        plan = fops.split_plan(b, s, s, kh, h // kh, hd, True, sms)
        row = {"plan_chunk": plan.chunk,
               "plain_ms": ab.graph_ms(torch, fops.flash_attention_plain,
                                       [st[:3] for st in sets], reps=20),
               "library_ms": ab.graph_ms(
                   torch, lambda q, k, v: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), is_causal=True, enable_gqa=True),
                   [st[:3] for st in sets])}
        for name, path in libs.items():
            for chunk in sorted({plan.chunk, *chunks}):
                launch = f32_launcher(torch, path, chunk)
                out = launch(*sets[0])
                err = float((out - want).abs().max())
                if not err <= cs.TOL["float32"]:
                    raise SystemExit(f"f32 sweep {name} chunk {chunk} at "
                                     f"{label}: max err {err}")
                row[f"{name} chunk{chunk}"] = ms = ab.graph_ms(torch, launch,
                                                               sets)
                print(f"[{label}] {name:16s} chunk {chunk:5d}"
                      f"{' (plan)' if chunk == plan.chunk else '       '}: "
                      f"{ms:.4f} ms, max err {err:.3g}")
        print(f"[{label}] plain {row['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention {row['library_ms']:.4f} ms")
        results["shapes"][label] = row
        del sets, want
        torch.cuda.empty_cache()
    print(gpu)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
