#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
Phases, each of which fails the run (exit code 1) if it fails:

1. Build every CUDA kernel of the port from ``src/repro_torch/csrc``.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (fp32 and bf16), and time the kernel, the
   plain version and a PyTorch library call with CUDA events.  Both
   decode kernels' sweeps include lengths at their split boundaries, an
   empty slot beside full windows, and two calls in a row that must agree
   bit for bit.
3. Serve 12 requests through ``DisaggregatedCluster`` on full-width
   Phi-4-mini 3.8B (random weights from a seed), once with the dense decode
   kernel (``decode_impl="pallas"``) and once with the paged one
   (``"paged"``), counting each kernel's launches.
4. A 16-step forced decode walk on the full model: kernel path against
   plain path, within 0.02 x the logit spread.
5. The flash-attention kernel of the teacher-forced loss against its plain
   version over fp32/bf16, G 1..8, hd 32/64/96/128, causal or not and
   ragged S <= T (with S*G off the kernel's 128-row blocks and S = 1 over
   an offset cache), then at the loss's shape (B=2, S=T=2048, H=24, K=8,
   hd=128), timed beside ``scaled_dot_product_attention``.
6. ``Model.train_loss`` on the full model at B=2, S=2048 with
   ``use_flash=True`` (32 flash launches, no decode kernel) and without
   (no kernel at all); the two losses agree within LOSS_BOUND.
7. ``Trainer`` on Phi-4-mini at full width and 16 of its 32 layers (fp32
   params, grads and Adam moments, ~45 GB): 1 warm-up and 3 measured steps
   at B=1, S=2048 with remat; finite losses, a nonzero gradient norm,
   params that moved, and a step with ``use_flash=True`` raises.
8. The scenario registry's two backends on phase 3's full-width model (run
   after phase 4): each ``parity-*`` scenario at its registered length
   through ``build_backend(..., backend="engine")`` with the dense decode
   kernel, and through the analytic simulator; decisions, overlap vectors
   and regime sequences must be equal.  Then ``parity-3d-hetero`` on the
   paged kernel under the coherence sanitizer (decisions equal again,
   every page pool whole), and a sanitized flood of
   ``hetero-decode-mixed`` (24 requests of 128 prompt tokens and 32 new
   ones, not serialized) on the paged kernel.

It prints one JSON line of kernel records, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12           # H100 SXM, float32 outside tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WALK_BOUND = 0.02                  # x logit spread (tests/test_engine_batching.py)
MAX_LEN = 1088                     # 68 pages of 16 tokens
SLOTS = 4
N_LAYERS = 32
LOSS_B, LOSS_S = 2, 2048           # the loss phase's batch
# |loss(flash) - loss(plain)| on a loss near ln(200064) = 12.2, the CPU
# parity tests' bound: the reference's own two paths differ by 9.3e-4 on
# the reduced model; on the card the full model's gap measures 3e-5 (both
# paths round P to bf16 before the product with V)
LOSS_BOUND = 2e-3
TRAIN_LAYERS = 16                  # of 32: fp32 params + grads + moments


# mangled-name parts of the bf16 instantiations on the main paths, whose
# ptxas report phase 1 prints in full
MAIN_KERNELS = {"flash_attention": "flash_bf16_kernel",
                "paged_attention": "paged_split_kernelI13__nv_bfloat16Li3ELi128E",
                "decode_attention": "dense_split_kernelI13__nv_bfloat16Li3ELi128E"}
# each kernel's source files, its own first, as the `kernels` line names them
_CSRC = "src/repro_torch/csrc/"
_SPLIT = ("decode_split.cuh", "decode_attention_common.cuh", "hopper.cuh")
SOURCES = {name: ", ".join(_CSRC + f for f in files) for name, files in {
    "decode_attention": ("decode_attention.cu", *_SPLIT),
    "paged_attention": ("paged_attention.cu", *_SPLIT),
    "flash_attention": ("flash_attention.cu", "hopper.cuh")}.items()}


def ptxas_lines(log: str, needle: str):
    """ptxas's lines for the kernels whose name holds ``needle``, every
    warning, and every note that it serialised ``wgmma``."""
    keep = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = needle in line
        if keep or "warning" in line.lower() or "Performance Loss" in line:
            yield line.strip()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, reps=60):
    """Mean device time of one call: after two eager warm-up calls,
    ``reps`` calls rotating over ``arg_sets`` (together larger than the 50
    MB L2, so each call finds its inputs cold, as a decode step's layers
    do) are captured into one CUDA graph, and its replay is timed with CUDA
    events.  The graph leaves out the host's time to issue each call, which
    at these sizes is as long as the kernels themselves."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def max_err(torch, a, b, dtype):
    """max |a - b|, after checking |a - b| <= tol + tol * |b| elementwise."""
    a, b = a.float(), b.float()
    tol = TOL[str(dtype).split(".")[-1]]
    err = (a - b).abs()
    check(bool(torch.isfinite(a).all()), "kernel output is not finite")
    check(bool((err <= tol + tol * b.abs()).all()),
          f"kernel disagrees with its plain version: max err "
          f"{float(err.max()):.3g} > {tol} ({dtype})")
    return float(err.max())


# ------------------------------------------------------------- phase 2 ---

def decode_inputs(torch, gen, b, t, h, kh, hd, dtype, lengths):
    dev = "cuda"
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def paged_inputs(torch, gen, b, n, w, h, kh, hd, dtype, lengths):
    dev = "cuda"
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n, 16, kh, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n, 16, kh, hd), generator=gen, device=dev).to(dtype)
    table = torch.randint(1, n, (b, w), generator=gen, device=dev,
                          dtype=torch.int32)
    return q, kp, vp, table, torch.tensor(lengths, dtype=torch.int32,
                                          device=dev)


def phase_kernels(torch, F):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.paged_attention import ops as pops

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, kh, hd = 24, 8, 128          # Phi-4-mini: G = 3
    # worst bf16 error at the main path's shapes, per kernel
    errs = {"decode_attention": 0.0, "paged_attention": 0.0}
    # every (G, hd, dtype) the kernels are built for, at a small size
    for dtype in (torch.float32, torch.bfloat16):
        for g in range(1, 9):
            for d in (32, 64, 128):
                args = decode_inputs(torch, gen, 3, 300, 2 * g, 2, d, dtype,
                                     [0, 257, 300])
                max_err(torch, dops.decode_attention(*args),
                        dops.decode_attention_plain(*args), dtype)
    # K1 at the main path's shapes: B = slots, T = max_len, ragged with 0,
    # then lengths at the split boundaries, an empty slot beside full
    # windows and a length past T (clamped); each case called twice on the
    # same combine counters, the two outputs bit-identical
    chunk = dops.split_plan(SLOTS, MAX_LEN, kh, h // kh, hd).chunk
    k1_edges = ([chunk - 1, chunk, chunk + 1, MAX_LEN],
                [0, MAX_LEN, MAX_LEN + 9, 2 * chunk + 1])
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for lens in ([0, 1, 257, MAX_LEN], *k1_edges):
            args = decode_inputs(torch, gen, SLOTS, MAX_LEN, h, kh, hd, dtype,
                                 lens)
            first = dops.decode_attention(*args)
            again = dops.decode_attention(*args)
            check(torch.equal(first, again), f"K1 lengths {lens}: two calls "
                  f"in a row differ")
            worst = max(worst, max_err(torch, first,
                                       dops.decode_attention_plain(*args),
                                       dtype))
        print(f"K1 decode_attention B={SLOTS} T={MAX_LEN} G=3 hd=128 "
              f"{dtype}: max err {worst:.3g} (splits of {chunk} keys; edge "
              f"lengths {k1_edges}; each case called twice, bit-identical)")
        if dtype == torch.bfloat16:
            errs["decode_attention"] = worst
    # K2, every (G, hd, dtype) it is built for, at a small size over a few
    # splits
    for dtype in (torch.float32, torch.bfloat16):
        for g in range(1, 9):
            for d in (32, 64, 128):
                args = paged_inputs(torch, gen, 3, 41, 20, 2 * g, 2, d, dtype,
                                    [0, 257, 320])
                max_err(torch, pops.paged_attention(*args),
                        pops.paged_attention_plain(*args), dtype)
    # K2 over the engine's page-table ladder; N = 4*68 + 1 pages with the
    # trash page 0, shared pages, out-of-range entries (clamped) and
    # lengths past the window (clamped); then, at W = 68, lengths at the
    # split boundaries, an empty slot beside full windows, and two calls in
    # a row on the same combine counters (a counter left unreset, or a
    # combine that depends on which block finishes last, shows there)
    n = SLOTS * 68 + 1
    split = pops.split_plan(SLOTS, 68, 16, kh, h // kh, hd).chunk
    edges = ([split - 1, split, split + 1, 68 * 16],
             [0, 68 * 16, 68 * 16 + 9, 2 * split + 1])
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        cases = [(w, [0, 1, max(1, 16 * w - 5), 16 * w + 7])
                 for w in (1, 2, 4, 8, 16, 32, 64, 68)]
        cases += [(68, lens) for lens in edges]
        for w, lens in cases:
            q, kp, vp, table, lengths = paged_inputs(
                torch, gen, SLOTS, n, w, h, kh, hd, dtype, lens)
            table[0, 0] = 0
            table[1, :] = table[2, :]
            table[3, -1] = n + 5
            table[2, 0] = -3
            want = pops.paged_attention_plain(q, kp, vp, table, lengths)
            first = pops.paged_attention(q, kp, vp, table, lengths)
            again = pops.paged_attention(q, kp, vp, table, lengths)
            check(torch.equal(first, again), f"K2 W={w} lengths {lens}: two "
                  f"calls in a row differ")
            worst = max(worst, max_err(torch, first, want, dtype))
        print(f"K2 paged_attention N={n} W=1..68 G=3 hd=128 {dtype}: "
              f"max err {worst:.3g} (splits of {split} keys; edge lengths "
              f"{edges}; each case called twice, bit-identical)")
        if dtype == torch.bfloat16:
            errs["paged_attention"] = worst
    torch.cuda.synchronize()

    # timing at the main path's shapes: bf16, slot lengths of a decode
    # step in phase 3 (prompts of 512-1024 tokens plus up to 32 generated)
    lens = [1041, 913, 760, 577]
    dt = torch.bfloat16
    item = 2
    kv_bytes = sum(lens) * kh * hd * 2 * item      # K and V below length
    io_bytes = 2 * SLOTS * h * hd * item + SLOTS * 4   # q, out, lengths
    ops_ms = 4 * h * hd * sum(lens) / FP32_FLOPS_PER_S * 1e3
    records = []

    def record(name, kernel, plain, sets, lib_sets, moved):
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        return dict(
            name=name, route="cuda", source=SOURCES[name],
            max_abs_err=errs[name],
            ms=time_ms(torch, kernel, sets),
            plain_ms=time_ms(torch, plain, sets),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=time_ms(torch, sdpa, lib_sets))

    sets = [decode_inputs(torch, gen, SLOTS, MAX_LEN, h, kh, hd, dt, lens)
            for _ in range(8)]
    mask_sets = []
    for q, k, v, lengths in sets:
        mask = (torch.arange(MAX_LEN, device="cuda")[None, None, None, :]
                < lengths[:, None, None, None])
        mask_sets.append((q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                          mask))
    sdpa = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=m, enable_gqa=True)
    records.append(record(
        "decode_attention", dops.decode_attention,
        dops.decode_attention_plain, sets, mask_sets, kv_bytes + io_bytes))
    records[-1]["replaces"] = \
        "src/repro/kernels/decode_attention/decode_attention.py:61"
    del sets, mask_sets

    psets = []
    for _ in range(8):
        q, kp, vp, _, lengths = paged_inputs(torch, gen, SLOTS, n, 68, h, kh,
                                             hd, dt, lens)
        # each slot owns its pages, as the allocator hands them out
        table = (1 + torch.randperm(n - 1, generator=gen, device="cuda")
                 [:SLOTS * 68]).to(torch.int32).reshape(SLOTS, 68)
        psets.append((q, kp, vp, table.contiguous(), lengths))
    gsets = []
    for q, kp, vp, table, lengths in psets:
        kd = pops.gather_pages(kp, table)
        vd = pops.gather_pages(vp, table)
        mask = (torch.arange(kd.shape[1], device="cuda")[None, None, None, :]
                < lengths[:, None, None, None])
        gsets.append((q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                      mask))
    # the library yardstick attends over the pre-gathered view: the gather
    # itself is left out of its time
    records.append(record(
        "paged_attention", pops.paged_attention, pops.paged_attention_plain,
        psets, gsets, kv_bytes + io_bytes + SLOTS * 68 * 4))
    records[-1]["replaces"] = \
        "src/repro/kernels/paged_attention/paged_attention.py:66"
    del psets, gsets
    torch.cuda.empty_cache()
    for r in records:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}"
              f" ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms (bf16, B={SLOTS}, "
              f"lengths {lens})")
    return records


# ------------------------------------------------------------- phase 5 ---

def flash_inputs(torch, gen, b, s, t, h, kh, hd, dtype):
    dev = "cuda"
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_flash(torch, F):
    from repro_torch.kernels.flash_attention import ops as fops

    gen = torch.Generator(device="cuda").manual_seed(1)
    # every (dtype, G, hd) at a small ragged size, causal or not, T - S in
    # {0, 37}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for g in range(1, 9):
            for d in fops.HEAD_DIMS:
                for causal in (True, False):
                    for extra in (0, 37):
                        s = 61 + 17 * g
                        args = flash_inputs(torch, gen, 2, s, s + extra,
                                            2 * g, 2, d, dtype)
                        max_err(torch,
                                fops.flash_attention(*args, causal=causal),
                                fops.flash_attention_plain(*args,
                                                           causal=causal),
                                dtype)
                        n += 1
    # the edges of the 128-row blocks: S*G past or short of a multiple of
    # 128 for G that does not divide it, and a single query over an offset
    # cache
    for dtype in (torch.float32, torch.bfloat16):
        for g in (3, 5, 6, 7):
            for d in fops.HEAD_DIMS:
                for s, extra in ((1, 37), (128 // g + 1, 0), (256 // g, 5)):
                    for causal in (True, False):
                        args = flash_inputs(torch, gen, 2, s, s + extra,
                                            2 * g, 2, d, dtype)
                        max_err(torch,
                                fops.flash_attention(*args, causal=causal),
                                fops.flash_attention_plain(*args,
                                                           causal=causal),
                                dtype)
                        n += 1
    torch.cuda.synchronize()
    print(f"K3 flash_attention: {n} sweep cases agree (G 1..8, hd "
          f"{fops.HEAD_DIMS}, causal and not, T - S in (0, 37); S*G off "
          f"the 128-row blocks for G 3/5/6/7; S = 1 with T - S = 37)")
    b, s, h, kh, hd = LOSS_B, LOSS_S, 24, 8, 128     # the loss's shape
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = flash_inputs(torch, gen, b, s, s, h, kh, hd, dtype)
        err[dtype] = max_err(torch, fops.flash_attention(*args),
                             fops.flash_attention_plain(*args), dtype)
        print(f"K3 flash_attention B={b} S=T={s} H={h} K={kh} hd={hd} "
              f"{dtype}: max err {err[dtype]:.3g}")
        del args
    torch.cuda.synchronize()

    dt = torch.bfloat16
    sets = [flash_inputs(torch, gen, b, s, s, h, kh, hd, dt)
            for _ in range(4)]          # 4 x 42 MB, beyond the 50 MB L2
    lib_sets = [tuple(x.transpose(1, 2) for x in st) for st in sets]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    moved = sum(x.numel() for x in sets[0]) * 2 + sets[0][0].numel() * 2
    pairs = s * (s + 1) // 2                  # causal (query, key) pairs
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * hd * pairs / BF16_FLOPS_PER_S * 1e3
    rec = dict(
        name="flash_attention", route="cuda",
        source=SOURCES["flash_attention"],
        replaces="src/repro/kernels/flash_attention/flash_attention.py:80",
        max_abs_err=err[dt],
        ms=time_ms(torch, fops.flash_attention, sets),
        plain_ms=time_ms(torch, fops.flash_attention_plain, sets, reps=20),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=time_ms(torch, sdpa, lib_sets))
    print(f"flash_attention: kernel {rec['ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; bytes "
          f"{bytes_ms:.4f} ms), plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']:.4f} ms (bf16, B={b}, S=T={s}, H={h}, K={kh},"
          f" hd={hd}, causal)")
    del sets, lib_sets
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------- phase 6 ---

def phase_loss(torch, model, params, cfg, counters):
    from repro_torch.training.data import DataConfig, make_batch

    batch = make_batch(DataConfig(cfg.vocab_size, LOSS_S, LOSS_B, seed=0), 0,
                       device="cuda")
    losses, launches_of = {}, {}
    for flash in (True, False):
        model.use_flash = flash
        with torch.no_grad():
            model.train_loss(params, batch)          # warm-up
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            loss = model.train_loss(params, batch)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            t0 = time.perf_counter()
            for _ in range(3):
                model.train_loss(params, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
        model.use_flash = False
        value = float(loss)
        check(value == value and abs(value) < 1e3,
              f"use_flash={flash}: loss {value}")
        want = {fn.__name__: (N_LAYERS if flash and
                              fn.__name__ == "flash_attention" else 0)
                for fn in counters}
        check(launches == want, f"use_flash={flash}: launches {launches}, "
              f"expected {want}")
        losses[flash] = value
        launches_of.update({k: v for k, v in launches.items() if v})
        print(f"loss use_flash={flash}: {value:.6f} (B={LOSS_B}, "
              f"S={LOSS_S}, {N_LAYERS} layers), {wall * 1e3:.1f} ms per "
              f"call, launches {launches}")
    gap = abs(losses[True] - losses[False])
    check(gap < LOSS_BOUND, f"flash and plain losses differ by {gap:.4g} "
          f">= {LOSS_BOUND}")
    print(f"loss gap |flash - plain| = {gap:.4g} (bound {LOSS_BOUND})")
    return launches_of


# ------------------------------------------------------------- phase 7 ---

def phase_train(torch, cfg, counters):
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer

    tcfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train", LOSS_S, 1, "train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(tcfg, shape, TrainConfig(remat=True), seed=0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(tr.state["params"]))
    print(f"trainer: {tcfg.num_layers} layers, {n_params / 1e9:.3f} B fp32 "
          f"params, init {time.perf_counter() - t0:.1f} s")
    probe = tr.state["params"]["layers"][0]["attn"]["wq"][0, 0].clone()
    for fn in counters:
        fn.launches = 0
    hist = tr.run(4)
    check(all(fn.launches == 0 for fn in counters),
          f"trainer launched kernels: {[fn.launches for fn in counters]}")
    for h in hist:
        check(h["loss"] == h["loss"] and abs(h["loss"]) < 1e3,
              f"step {h['step']}: loss {h['loss']}")
        check(h["grad_norm"] > 0 and h["grad_norm"] == h["grad_norm"],
              f"step {h['step']}: grad norm {h['grad_norm']}")
    moved = tr.state["params"]["layers"][0]["attn"]["wq"][0, 0]
    check(not torch.equal(moved, probe), "the params did not move")
    step = sum(h["step_time"] for h in hist[1:]) / 3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: losses {[round(h['loss'], 4) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}, step "
          f"{step * 1e3:.1f} ms ({[round(h['step_time'] * 1e3, 1) for h in hist[1:]]}"
          f"), {LOSS_S / step:.1f} tokens/s, peak memory {peak:.2f} GiB")
    tr.model.use_flash = True
    try:
        tr.run(1)
    except RuntimeError as e:
        check("no gradient" in str(e), f"use_flash step raised {e!r}")
    else:
        fail("a train step with use_flash=True did not raise")
    check(len(tr.history) == 4, "the raising step was recorded")
    print("train: a step with use_flash=True raises (no gradient)")
    del tr


# ------------------------------------------------------------- phase 3 ---

def template_prompt(template: int, n: int, vocab: int):
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


def serve(torch, model, params, cfg, decode_impl, requests, counters):
    from repro_torch.serving.disagg import DisaggregatedCluster, ServeRequest

    cluster = DisaggregatedCluster(
        model, params, num_decode=2, slots_per_worker=SLOTS, max_len=MAX_LEN,
        adaptive=False, cache_ttl=None, decode_impl=decode_impl,
        device="cuda")
    steps = [0]
    for dec in cluster.decoders:
        inner = dec.step

        def counted(inner=inner):
            out = inner()
            steps[0] += bool(out)       # a tick that ran the model
            return out
        dec.step = counted
    for rid, toks, max_new in requests:
        cluster.submit(ServeRequest(rid, toks, max_new_tokens=max_new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    done = cluster.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    return cluster, done, wall, steps[0], launches


def phase_slice(torch, model, params, cfg, counters):
    rng_lens = [512 + (i * 173) % 513 for i in range(12)]
    requests = [(f"req-{i}", template_prompt(i % 3, rng_lens[i],
                                             cfg.vocab_size), 32)
                for i in range(12)]
    # warm the allocator and the library handles outside the measured runs
    serve(torch, model, params, cfg, "pallas",
          [("warm", template_prompt(7, 520, cfg.vocab_size), 2)], counters)
    logs = {}
    launches_of = {}
    for impl, kernel in (("pallas", "decode_attention"),
                         ("paged", "paged_attention")):
        cluster, done, wall, steps, launches = serve(
            torch, model, params, cfg, impl, requests, counters)
        check(len(done) == 12, f"{impl}: {len(done)} of 12 requests done")
        check(all(len(r.output) == 33 for r in done),
              f"{impl}: output lengths {[len(r.output) for r in done]}")
        check(steps > 0 and launches[kernel] == N_LAYERS * steps,
              f"{impl}: {launches[kernel]} launches of {kernel} for {steps} "
              f"decode steps of {N_LAYERS} layers")
        other = sum(v for k, v in launches.items() if k != kernel)
        check(other == 0, f"{impl}: other kernels launched: {launches}")
        st = cluster.prefill.stats
        check(st.reused_blocks > 0, f"{impl}: no prefix-cache resume ran")
        if impl == "paged":
            for dec in cluster.decoders:
                check(dec.allocator.audit() == [], f"audit {dec.allocator.audit()}")
                check(dec.allocator.free_pages == dec.allocator.num_pages,
                      "pages leaked")
        logs[impl] = [(d.worker, d.overlap) for d in cluster.control.decision_log]
        launches_of[kernel] = launches[kernel]
        ttft = sorted(r.ttft for r in done)
        p50 = ttft[len(ttft) // 2]
        p99 = ttft[min(len(ttft) - 1, int(round(0.99 * (len(ttft) - 1))))]
        gen_tokens = sum(len(r.output) - 1 for r in done)
        print(f"slice {impl}: 12 requests, {steps} decode steps, "
              f"{launches[kernel]} {kernel} launches, "
              f"resumed blocks {st.reused_blocks}/{st.total_blocks}, "
              f"TTFT p50 {p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms, "
              f"decode {gen_tokens / wall:.1f} tokens/s over {wall:.2f} s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
        del cluster, done
        torch.cuda.empty_cache()
    check(logs["pallas"] == logs["paged"],
          "routing decisions differ between the dense and paged runs")
    return launches_of


# ------------------------------------------------------------- phase 8 ---

def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def analytic_record(sim):
    res = sim.run()
    reqs = sorted(res.completed, key=lambda r: r.rid)
    return ([(r.rid, r.decode_worker, round(r.overlap, 12)) for r in reqs],
            [tuple(round(x, 12) for x in r.overlaps_all) for r in reqs],
            [(a, b) for _, a, b in sim.detector.transitions],
            int(sim.detector.regime))


def engine_record(res):
    reqs = sorted(res.requests, key=lambda r: int(r.request_id[1:]))
    return ([(i, w, round(ov, 12)) for i, w, ov in res.decisions],
            [tuple(round(x, 12) for x in r.overlaps) for r in reqs],
            [(a, b) for _, a, b in res.regime_transitions],
            res.final_regime)


def run_counted(torch, runner, counters):
    """The runner's warm-up, then ``runner.run()`` with every kernel count
    set to 0 just before and read just after; returns (result, launches,
    wall seconds of the run alone)."""
    runner._warmup()
    runner.warmup_enabled = False
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, {fn.__name__: fn.launches for fn in counters}, wall


def check_pools(runner, label):
    for dec in runner.cluster.decoders:
        check(dec.allocator.audit() == [],
              f"{label}: audit {dec.allocator.audit()}")
        check(dec.allocator.free_pages == dec.allocator.num_pages,
              f"{label}: pages leaked")


def phase_scenarios(torch, model, params, counters):
    from repro_torch.serving.scenarios import build_backend, parity_scenarios
    runs = [(name, "pallas", False) for name in parity_scenarios()]
    runs.append(("parity-3d-hetero", "paged", True))
    for name, impl, sanitize in runs:
        kernel = {"pallas": "decode_attention", "paged": "paged_attention"}[impl]
        want = analytic_record(build_backend(name, backend="analytic",
                                             seed=0))
        runner = build_backend(name, backend="engine", seed=0, model=model,
                               params=params, decode_impl=impl,
                               sanitize=sanitize)
        check((runner.cluster.sanitizer is not None) == sanitize,
              f"{name}: sanitizer attached {runner.cluster.sanitizer}")
        res, launches, wall = run_counted(torch, runner, counters)
        got = engine_record(res)
        decisions, want_decisions = got[0], want[0]
        agree = sum(a == b for a, b in zip(decisions, want_decisions)) / max(
            len(want_decisions), 1)
        ttft = [r.ttft for r in res.requests]
        print(f"scenario {name} {impl}{' sanitized' if sanitize else ''}: "
              f"{len(res.requests)} requests, decisions agree "
              f"{agree:.3f}, regimes {got[2]} final {got[3]}, launches "
              f"{launches}, TTFT p50 {percentile(ttft, 0.5) * 1e3:.1f} ms "
              f"p99 {percentile(ttft, 0.99) * 1e3:.1f} ms, "
              f"{wall:.2f} s")
        check(len(decisions) == len(want_decisions) == len(runner.specs),
              f"{name}: {len(decisions)} decisions, analytic "
              f"{len(want_decisions)}, {len(runner.specs)} requests")
        for label, a, b in zip(("decisions", "overlap vectors", "regime "
                                "sequence", "final regime"), got, want):
            check(a == b, f"{name} {impl}: {label} differ from the analytic "
                  f"backend: {a} != {b}")
        check(launches[kernel] > 0, f"{name}: no {kernel} launch")
        check(sum(launches.values()) == launches[kernel],
              f"{name}: other kernels launched: {launches}")
        if impl == "paged":
            check_pools(runner, name)
        del runner, res
    # a flood: backpressure, batched prefill and continuous batching on the
    # paged kernel, every tick checked by the sanitizer
    runner = build_backend("hetero-decode-mixed", backend="engine", seed=0,
                           model=model, params=params, serialize=False,
                           num_requests=24, input_tokens=128,
                           output_tokens=32, decode_impl="paged",
                           sanitize=True)
    san = runner.cluster.sanitizer
    check(san is not None, "flood: no sanitizer")
    spent = [0.0, 0]
    inner = san.check_all

    def timed_check(where="tick"):
        t0 = time.perf_counter()
        inner(where)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
    san.check_all = timed_check
    gc.collect()            # earlier phases' clusters hold reference cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = run_counted(torch, runner, counters)
    check(len(res.requests) == 24, f"flood: {len(res.requests)} of 24 done")
    check(all(len(r.output) == 33 for r in res.requests),
          f"flood: output lengths {[len(r.output) for r in res.requests]}")
    check(all(len(s.tokens) == 128 for s in runner.specs),
          "flood: prompts are not 128 tokens")
    check(launches["paged_attention"] > 0 and
          sum(launches.values()) == launches["paged_attention"],
          f"flood: launches {launches}")
    check_pools(runner, "flood")
    occ = runner.cluster.occupancy
    slots = sum(d.num_slots for d in runner.cluster.decoders)
    ttft = [r.ttft for r in res.requests]
    gen_tokens = sum(len(r.output) - 1 for r in res.requests)
    print(f"scenario hetero-decode-mixed paged sanitized flood: 24 requests "
          f"x 128+32 tokens, {len(occ)} ticks, peak occupancy "
          f"{max(map(sum, occ))} of {slots} slots, launches {launches}, TTFT p50 "
          f"{percentile(ttft, 0.5) * 1e3:.1f} ms p99 "
          f"{percentile(ttft, 0.99) * 1e3:.1f} ms, decode "
          f"{gen_tokens / wall:.1f} tokens/s over {wall:.2f} s "
          f"({wall / max(len(occ), 1) * 1e3:.1f} ms a tick), sanitizer "
          f"{spent[0] / max(spent[1], 1) * 1e3:.3f} ms a tick over "
          f"{spent[1]} ticks, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({base:.2f} GiB held before the run, the params among it)")
    del runner, res
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 4 ---

def phase_walk(torch, model, params, cfg):
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine

    toks = template_prompt(0, 624, cfg.vocab_size)
    pre = PrefillEngine(model, params, MAX_LEN, cache_entries=0,
                        device="cuda")
    logits, caches = pre.prefill(toks)
    first = int(logits.argmax())
    # dense: kernel vs plain on two copies of the same cache
    dec = DecodeEngine(model, params, num_slots=1, max_len=MAX_LEN,
                       decode_impl="paged", device="cuda")
    dec.admit(0, "walk", caches, first, prompt_len=len(toks), max_new=16)
    table = torch.as_tensor(dec.page_table, device="cuda")
    pairs = (("pallas", "sdpa", caches,
              {n: t.clone() for n, t in caches.items()}, None),
             ("paged", "paged_sdpa", dec.caches,
              {n: t.clone() for n, t in dec.caches.items()}, table))
    for kern, plain, ck, cp, tbl in pairs:
        tok, worst = first, 0.0
        for step in range(16):
            cur = len(toks) + step
            arr = torch.full((1, 1), tok, dtype=torch.int32, device="cuda")
            lk, _ = model.decode(params, ck, arr, cur, decode_impl=kern,
                                 page_table=tbl)
            lp, _ = model.decode(params, cp, arr, cur, decode_impl=plain,
                                 page_table=tbl)
            check(bool(torch.isfinite(lk).all()), f"{kern}: non-finite logits")
            spread = float(lp.max() - lp.min())
            diff = float((lk - lp).abs().max())
            check(diff < WALK_BOUND * spread,
                  f"walk {kern} vs {plain} step {step}: {diff:.4g} >= "
                  f"{WALK_BOUND} x spread {spread:.4g}")
            worst = max(worst, diff / spread)
            tok = int(lp.argmax())
        print(f"walk {kern} vs {plain}: 16 steps, max |dlogits| / spread "
              f"{worst:.4g} (bound {WALK_BOUND})")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, decode_attention, flash_attention,
                                     paged_attention)
    from repro_torch.models import Model

    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"phase 1: built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in sorted(paths.items()):
        log = path.with_suffix(".log").read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers/thread, {sum(n > 0 for n in spills)} with spills "
              f"(largest {max(spills, default=0)} bytes)")
        for line in ptxas_lines(log, MAIN_KERNELS.get(name, "\0")):
            print(f"    {line}")

    t0 = time.perf_counter()
    records = phase_kernels(torch, F)
    print(f"phase 2: kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    cfg = get_config("phi4-mini-3.8b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"model: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads} K={cfg.num_kv_heads} vocab={cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    counters = (decode_attention, paged_attention, flash_attention)
    t0 = time.perf_counter()
    launches = phase_slice(torch, model, params, cfg, counters)
    print(f"phase 3: slice served ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    phase_walk(torch, model, params, cfg)
    print(f"phase 4: forced walks within bound ({time.perf_counter() - t0:.1f}"
          f" s)")
    t0 = time.perf_counter()
    phase_scenarios(torch, model, params, counters)
    print(f"phase 8: scenario backends agree ({time.perf_counter() - t0:.1f}"
          f" s)")
    t0 = time.perf_counter()
    records.append(phase_flash(torch, F))
    print(f"phase 5: flash kernel agrees with its plain version "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    launches.update(phase_loss(torch, model, params, cfg, counters))
    print(f"phase 6: teacher-forced loss, flash and plain "
          f"({time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_train(torch, cfg, counters)
    print(f"phase 7: trainer steps ({time.perf_counter() - t0:.1f} s)")

    for r in records:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
