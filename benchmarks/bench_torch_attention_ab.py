"""A/B of the port's decode (K1), paged-decode (K2) and flash-attention (K3)
kernels: a parent commit's CUDA sources against this tree's, on one GPU, in
turns.

Stage the parent's sources first (``build/`` is git-ignored), then run:

    mkdir -p build/parent_csrc
    git archive <parent> src/repro_torch/csrc \
        | tar -x -C build/parent_csrc --strip-components=3
    PYTHONPATH=src python benchmarks/bench_torch_attention_ab.py \
        [--parent build/parent_csrc] [--json reports/ab.json]

The parent's sources are built into ``build/ab_parent/`` with the same
``nvcc`` flags and ``ctypes`` binding as ``repro_torch.kernels.build``;
this tree's go to ``build/kernels/`` as usual; both builds run at once.
Both versions get the shapes and input rotation of ``chip_smoke.py``
phases 2 and 5 (K1: bf16, 4 slots, G = 3, hd = 128, T = 1088, lengths
1041/913/760/577, 8 input sets; K2: the same with W = 68 pages of 16; K3:
bf16, B=2, S=T=2048, H=24, K=8, hd=128, causal, 4 input sets), and K3's
fp32 body at ``bench_kernels.py``'s shape (B=1, S=T=512, H=8, K=2, hd=64,
causal, input sets past the L2) and at the loss's shape (4 sets).  Each is
checked against the plain version on the first set (2e-2 in bf16, 2e-5 in
fp32; and against the other version bit for bit, which is printed), and
timed in the order parent, new, new, parent, each turn in two ways
(the fp32 cases also time the plain version and
``scaled_dot_product_attention`` once, as ``plain_ms`` and ``library_ms``
in graph replays, TF32 off):

* ``graph_ms``: 60 launches rotating over the input sets, captured in one
  CUDA graph, its replay timed with CUDA events (device time, without the
  host's time to issue the calls);
* ``kernel_ms``: the mean device time of a launch's kernels in a
  ``torch.profiler`` trace of 30 launches (K3 fp32: its main kernel and,
  where the launch splits keys, its merge kernel; ``by_kernel`` splits it
  by kernel name).

Both versions are called through the same thin ``ctypes`` launchers with
preallocated outputs, so the Python wrappers' cost is in neither.  The
launchers follow each version's ABI: K1 and K2 with split scratch and
combine counters when the sources hold the split body, else the older
one-block-per-(slot, KV head) ABI; K3 fp32 through
``flash_attention_f32_launch`` with ``split_plan``'s chunks and scratch
when the sources hold ``flash_attention_f32.cuh``, else through
``flash_attention_launch`` with ``dtype`` 0.  Needs a CUDA device, and
fails if the parent's directory is missing.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 60


def graph_ms(torch, fn, sets, reps=REPS):
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(torch, fn, sets, needle, reps=30, per_launch=1):
    """Mean device ms of a launch's kernels whose name holds ``needle`` in
    a profiler trace of ``reps`` launches, each of which must run exactly
    ``per_launch`` of them, and the same split by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    n, by_kernel = 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and needle in e.name:
            name = e.name.split("<")[0].split("(")[0].split("::")[-1]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.time_range.elapsed_us() / reps / 1e3)
            n += 1
    if n != per_launch * reps:
        raise SystemExit(f"bench: {n} '{needle}' kernels traced for {reps} "
                         f"launches of {per_launch}")
    return sum(by_kernel.values()), by_kernel


def bind(lib_path, name, n_ptr_head, n_int, tail):
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr_head + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] + tail)
    return fn


def paged_launcher(torch, lib_path, src_dir, pops):
    """A launcher of the paged kernel in ``lib_path``: the split ABI
    (scratch, counters, splits, pages per split after the stream) when the
    sources hold it, else the one-block-per-(slot, KV head) ABI."""
    split_abi = (Path(src_dir) / "decode_split.cuh").exists()
    tail = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 if split_abi else []
    fn = bind(lib_path, "paged_attention", 6, 8, tail)
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def launch(q, kp, vp, table, lengths, out):
        b, h, hd = q.shape
        n, block, kh, _ = kp.shape
        w = table.shape[1]
        extra = []
        if split_abi:
            plan = pops.split_plan(b, w, block, kh, h // kh, hd)
            partial = torch.empty(plan.partial_shape, dtype=torch.float32,
                                  device="cuda")
            extra = [partial.data_ptr(), counters.data_ptr(), plan.splits,
                     plan.chunk_pages]
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), b, n, block, w, kh,
                h // kh, hd, 1, stream, *extra)
        if rc:
            raise RuntimeError(f"paged_attention launch: {rc}")
        return out
    return launch


def dense_launcher(torch, lib_path, src_dir, chunk):
    """A launcher of the dense kernel in ``lib_path``: the split ABI
    (scratch, counters, splits, keys per split after the stream) when the
    sources hold it, else the stateless one-block-per-(slot, KV head)
    ABI."""
    split_abi = "dense_split_kernel" in (Path(src_dir)
                                         / "decode_attention.cu").read_text()
    tail = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 if split_abi else []
    fn = bind(lib_path, "decode_attention", 5, 6, tail)
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def launch(q, k, v, lengths, out):
        b, h, hd = q.shape
        t, kh = k.shape[1], k.shape[2]
        extra = []
        if split_abi:
            splits = -(-t // chunk)
            partial = torch.empty((b, kh, splits, h // kh * (hd + 2)),
                                  dtype=torch.float32, device="cuda")
            extra = [partial.data_ptr(), counters.data_ptr(), splits, chunk]
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, t, kh, h // kh, hd, 1, stream, *extra)
        if rc:
            raise RuntimeError(f"decode_attention launch: {rc}")
        return out
    return launch


def flash_launcher(torch, lib_path):
    fn = bind(lib_path, "flash_attention", 4, 8, [])

    def launch(q, k, v, out):
        b, s, h, hd = q.shape
        t, kh = k.shape[1], k.shape[2]
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, t, kh, h // kh, hd, 1, 1, stream)
        if rc:
            raise RuntimeError(f"flash_attention launch: {rc}")
        return out
    return launch


def f32_kernels_per_launch(torch, src_dir, fops, q, k):
    """Kernels one launch of K3's fp32 body runs on ``q``, ``k``: the main
    kernel, and the merge where the split ABI's plan cuts keys."""
    if not (Path(src_dir) / "flash_attention_f32.cuh").exists():
        return 1
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1 + (fops.split_plan(b, s, t, kh, h // kh, hd, True, sms).chunks
                > 1)


def flash_f32_launcher(torch, lib_path, src_dir, fops):
    """A launcher of K3's fp32 body in ``lib_path``: the split ABI (scratch,
    chunk, chunks) when the sources hold ``flash_attention_f32.cuh``, else
    ``flash_attention_launch`` with ``dtype`` 0."""
    split_abi = (Path(src_dir) / "flash_attention_f32.cuh").exists()
    if not split_abi:
        fn = bind(lib_path, "flash_attention", 4, 8, [])
    else:
        fn = ctypes.CDLL(str(lib_path)).flash_attention_f32_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(q, k, v, out):
        b, s, h, hd = q.shape
        t, kh = k.shape[1], k.shape[2]
        stream = torch.cuda.current_stream().cuda_stream
        if split_abi:
            plan = fops.split_plan(b, s, t, kh, h // kh, hd, True, sms)
            partial = torch.empty(plan.scratch, dtype=torch.float32,
                                  device="cuda")
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    partial.data_ptr(), b, s, t, kh, h // kh, hd, 1,
                    plan.chunk, plan.chunks, stream)
        else:
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, s, t, kh, h // kh, hd, 1, 0, stream)
        if rc:
            raise RuntimeError(f"flash_attention fp32 launch: {rc}")
        return out
    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent_csrc"))
    ap.add_argument("--json", default=None, help="also write the results here")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_torch_attention_ab: needs a CUDA device", file=sys.stderr)
        return 2
    parent = Path(args.parent)
    if not (parent / "paged_attention.cu").is_file():
        print(f"bench_torch_attention_ab: no parent sources in {parent}; "
              f"stage them with git archive (see the docstring)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    names = ("decode_attention", "paged_attention", "flash_attention")
    jobs = {"parent": (names, parent, ROOT / "build" / "ab_parent"),
            "new": (names, build.CSRC, build.BUILD_DIR)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {v: pool.submit(build.build_all, *job)
                for v, job in jobs.items()}
        libs = {v: f.result() for v, f in futs.items()}
    srcs = {v: job[1] for v, job in jobs.items()}
    for ver, paths in libs.items():
        for name, path in paths.items():
            log = path.with_suffix(".log").read_text()
            for line in cs.ptxas_lines(log, {
                    "decode_attention": "13__nv_bfloat16Li3ELi128E",
                    "paged_attention": "13__nv_bfloat16Li3ELi128E",
                    "flash_attention": ("flash_bf16_kernelILi128E",
                                        "flash_f32_kernelILi64E",
                                        "flash_f32_kernelILi128E")}[name]):
                if "Used" in line or "spill" in line or "arn" in line:
                    print(f"{ver} {name}: {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, kh, hd, n = 24, 8, 128, cs.SLOTS * 68 + 1
    lens = [1041, 913, 760, 577]
    dsets = []
    for _ in range(8):
        q, k, v, lengths = cs.decode_inputs(torch, gen, cs.SLOTS, cs.MAX_LEN,
                                            h, kh, hd, torch.bfloat16, lens)
        dsets.append((q, k, v, lengths, torch.empty_like(q)))
    psets = []
    for _ in range(8):
        q, kp, vp, _, lengths = cs.paged_inputs(torch, gen, cs.SLOTS, n, 68, h,
                                                kh, hd, torch.bfloat16, lens)
        table = (1 + torch.randperm(n - 1, generator=gen, device="cuda")
                 [:cs.SLOTS * 68]).to(torch.int32).reshape(cs.SLOTS, 68)
        psets.append((q, kp, vp, table.contiguous(), lengths,
                      torch.empty_like(q)))
    fsets = []
    for _ in range(4):
        q, k, v = cs.flash_inputs(torch, gen, cs.LOSS_B, cs.LOSS_S, cs.LOSS_S,
                                  h, kh, hd, torch.bfloat16)
        fsets.append((q, k, v, torch.empty_like(q)))
    f32_sets = {}
    for label, (b, s, hq, kq, d, n_sets) in {
            "bench": (1, 512, 8, 2, 64, 58), "loss": (2, 2048, h, kh, hd, 4)
    }.items():
        f32_sets[label] = []
        for _ in range(n_sets):
            q, k, v = cs.flash_inputs(torch, gen, b, s, s, hq, kq, d,
                                      torch.float32)
            f32_sets[label].append((q, k, v, torch.empty_like(q)))

    kernels = {
        "decode_attention": dict(
            sets=dsets, plain=lambda s: dops.decode_attention_plain(*s[:4]),
            make=lambda ver: dense_launcher(torch,
                                            libs[ver]["decode_attention"],
                                            srcs[ver], dops.SPLIT_KEYS),
            needle="dense_"),
        "paged_attention": dict(
            sets=psets, plain=lambda s: pops.paged_attention_plain(*s[:5]),
            make=lambda ver: paged_launcher(torch, libs[ver]["paged_attention"],
                                            srcs[ver], pops),
            needle="paged_"),
        "flash_attention": dict(
            sets=fsets, plain=lambda s: fops.flash_attention_plain(*s[:3]),
            make=lambda ver: flash_launcher(torch,
                                            libs[ver]["flash_attention"]),
            needle="flash_bf16_kernel"),
    }
    for label, sets in f32_sets.items():
        kernels[f"flash_attention_fp32_{label}"] = dict(
            sets=sets, plain=lambda s: fops.flash_attention_plain(*s[:3]),
            make=lambda ver: flash_f32_launcher(
                torch, libs[ver]["flash_attention"], srcs[ver], fops),
            needle="flash_f32_", tol=cs.TOL["float32"],
            per_launch=lambda ver, st=sets[0]: f32_kernels_per_launch(
                torch, srcs[ver], fops, *st[:2]),
            library=lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True))
    results = {"gpu": gpu, "kernels": {}}
    for name, kd in kernels.items():
        launch = {ver: kd["make"](ver) for ver in ("parent", "new")}
        want = kd["plain"](kd["sets"][0]).float()
        errs, outs = {}, {}
        for ver, fn in launch.items():
            outs[ver] = fn(*kd["sets"][0]).clone()
            torch.cuda.synchronize()
            got = outs[ver].float()
            errs[ver] = float((got - want).abs().max())
            if not (errs[ver] <= kd.get("tol", 2e-2)
                    and bool(torch.isfinite(got).all())):
                raise SystemExit(f"bench: {ver} {name} disagrees with the "
                                 f"plain version: max err {errs[ver]}")
        same = bool(torch.equal(outs["new"], outs["parent"]))
        turns = []
        for ver in ("parent", "new", "new", "parent"):
            g_ms = graph_ms(torch, launch[ver], kd["sets"])
            k_ms, by_kernel = kernel_ms(
                torch, launch[ver], kd["sets"], kd["needle"],
                per_launch=kd.get("per_launch", lambda _: 1)(ver))
            turns.append(dict(version=ver, graph_ms=g_ms, kernel_ms=k_ms,
                              by_kernel=by_kernel))
        results["kernels"][name] = dict(max_abs_err=errs, turns=turns,
                                        bit_identical_to_parent=same)
        for t in turns:
            split = ("" if len(t["by_kernel"]) < 2 else " (" + ", ".join(
                f"{k} {v:.4f}" for k, v in t["by_kernel"].items()) + ")")
            print(f"{name} {t['version']:6s}: graph {t['graph_ms']:.4f} ms, "
                  f"kernel {t['kernel_ms']:.4f} ms{split}")
        if "library" in kd:
            sets3 = [st[:3] for st in kd["sets"]]
            yard = dict(
                plain_ms=graph_ms(torch, fops.flash_attention_plain, sets3,
                                  reps=20),
                library_ms=graph_ms(torch, kd["library"], sets3))
            results["kernels"][name].update(yard)
            print(f"{name}: plain {yard['plain_ms']:.4f} ms, "
                  f"scaled_dot_product_attention {yard['library_ms']:.4f} ms")
        print(f"{name} max err vs plain: {errs}; output bit-identical to "
              f"the parent's: {same}")
    print(gpu)
    print(json.dumps(results))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
