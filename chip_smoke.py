#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
Phases, each of which fails the run (exit code 1) if it fails:

1. Build every CUDA kernel of the port from ``src/repro_torch/csrc``.
2. Hold each kernel against its plain PyTorch version on the card, at
   every (G, hd, dtype) it is built for and at the shapes the main path
   gives it (fp32 and bf16), and time the kernel, the plain version and a
   PyTorch library call with CUDA events.  Both
   decode kernels' sweeps include lengths at their split boundaries, an
   empty slot beside full windows, and two calls in a row that must agree
   bit for bit.
3. Serve 12 requests through ``DisaggregatedCluster`` on full-width
   Phi-4-mini 3.8B (random weights from a seed), once with the dense decode
   kernel (``decode_impl="pallas"``) and once with the paged one
   (``"paged"``), counting each kernel's launches: the decode kernel once
   per layer and decode step, K3 once per attention layer and prompt pass
   of more than one query (each attends over its live keys on K3; none
   takes the plain path), and no other kernel.
4. A 16-step forced decode walk on the full model: kernel path against
   plain path, within 0.02 x the logit spread (in an MoE model the kernel
   path takes the plain path's expert ids; see ``phase_walk``).
5. The flash-attention kernel of the teacher-forced loss and the prompt
   pass against its plain version over fp32/bf16, G 1..8, hd 32/64/96/128, causal or not and
   ragged S <= T (with S*G off the kernel's 128-row blocks and S = 1 over
   an offset cache); then its fp32 body at the edges of its tasks (S*G one
   short of, at and one past its 64-row blocks, key ranges one short of,
   at and one past a chunk and two, S = 1 over T - S = 37), each launched
   twice and bit-equal, and one chunk against many on the same inputs;
   then at the prompt passes' shapes (``PROMPT_FLASH_SHAPES``: resumed
   passes of 512 and 1,041 rows over 2.5k keys, a cold ragged pass of
   width 8, Nemotron-H's cold pass at G = 8 over 2,573 keys), each error
   printed; then at the loss's shape (B=2, S=T=2048, H=24, K=8, hd=128), bf16 and
   fp32 each timed beside ``scaled_dot_product_attention``.
6. ``Model.train_loss`` on the full model at B=2, S=2048 with
   ``use_flash=True`` (32 flash launches, no decode kernel; its fp32 flash
   launches, counted apart, are the ``flash_attention_fp32`` record's) and
   without (no kernel at all); the two losses agree within LOSS_BOUND.
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
   ones, not serialized) on the paged kernel; each run launches its decode
   kernel, K3 once per layer and prompt pass, and no other kernel.
9. The MoE slice, after every earlier tensor is freed: K1 and K2
   held and timed as in phase 2 at Qwen3-30B-A3B's attention shape (G =
   8, hd = 64, K = 4), then full-width ``qwen3-moe-30b-a3b`` (48 layers,
   128 experts top-8, ~30.1 B params, bf16 drawn on the card) served as in
   phase 3 (48 kernel launches a decode step, 48 K3 launches a prompt
   pass) and walked as in phase 4.
10. The SSM and hybrid slice, last, after phase 9's params are freed: K1
   held and timed at Jamba's attention shape (G = 4, hd = 128, K = 8; K2
   is not on this path), then ``jamba-v0.1-52b`` at full width and 16 of
   its 32 layers (7 Mamba and 1 attention layer a period, MoE on every
   second layer, ~26.0 B params) and ``xlstm-125m`` at full size, each
   serving phase 3's requests on the dense decode kernel (K1 launched once
   per attention layer and decode step, K3 once per attention layer and
   prompt pass: 2 on Jamba, none on xLSTM), with
   no prefix resumed, no prompt right-padded and a paged decoder refused,
   then walked as in phase 4 (``"pallas"`` against ``"sdpa"``).
11. The encoder-decoder and VLM slice, last, after phase 10's params are
   freed: K1 and K2 held and timed at Phi-3-vision's attention shape (G =
   1, hd = 96, K = 32, T = 1664), K1 at SeamlessM4T-medium's (G = 1, hd =
   64, K = 16) and K3 at the VLM loss's (B = 1, S = 2048, H = K = 32, hd =
   96); then ``phi-3-vision-4.2b`` (32 layers, ~3.8 B params) and
   ``seamless-m4t-medium`` (12 encoder and 12 decoder layers, ~0.9 B) at
   full size, each serving 12 requests with ``extras`` (576 x 1024 patches,
   or 1024-2048 x 160 frames) on the dense decode kernel (K1 launched once
   per self-attention layer and decode step, K3 once per self-attention
   layer and prompt pass; every prompt its own pass, no
   prefix resumed or stored; the cached cross attention plain) and walked
   as in phase 4 from a prefill with those inputs; and the VLM's loss at
   S = 2048 (576 patches) with K3 (32 launches) and without.
12. The lint pass and the q-chunk flag (run after phase 8, on phase 3's
   model): ``python -m repro_torch.analysis`` over the port's package, its
   tests, benchmarks and examples and this script must exit 0 with no
   allowlist, and over each bad fixture (staged under a path its rule
   scopes) with ``--select`` its code must exit 1 with at least
   LINT_MIN_BAD findings; one line ``{"lint": {...}}``.  Then one prompt
   pass of 1,041 tokens with fp32 compute (the plain path, which the flag
   blocks; a bf16 pass attends on K3, which it does not reach) at the
   default query block (1,024) and with
   ``runtime_flags.Q_CHUNK_OVERRIDE`` at 256 and 2048: timed, last logits
   within 2e-3 of the default's; the flags are restored.
13. The sharding layer (run after phase 12, on phase 3's model): a
   one-rank NCCL world from a ``FileStore`` in a temporary directory, a
   (1, 1) ("data", "model") mesh from ``make_test_mesh``, and the params
   distributed by ``param_shardings``.  Phase 4's forced walk (624-token
   prompt, 16 steps, ``"pallas"``) runs under ``use_policy`` on the
   DTensor params and without it on the plain ones, fed the same tokens:
   max|dlogits| within WALK_BOUND x spread, K1 launched on local shards
   exactly once per attention layer and step (32 x 16 = 512), and K3 once
   per attention layer in the prompt pass, on local shards too (32).
   ``compressed_psum`` over the NCCL group on two layers' fp32 gradients
   must equal ``compress_grads`` bit for bit.  The prompt pass is timed
   with and without the policy (DTensor's host cost); the process group
   is destroyed before the next phase.
14. The launch tooling, last: ``python -m repro_torch.launch.dryrun
   --mesh single`` on a fake 256-rank group for DRYRUN_CELLS (one process
   a cell, started together; each must exit 0, hold every key
   ``roofline.fmt_row`` reads and count its collectives as
   ``CommDebugMode`` does), then ``python -m repro_torch.launch.roofline``
   over their records.  Then the measured cell: a fresh full-width
   Phi-4-mini in bf16 on a one-rank NCCL (1, 1) mesh, as phase 13 starts
   it, with caches of CELL_B x CELL_T: ``bytes_per_device`` of params and
   caches within CELL_BYTES_TOL of ``memory_allocated`` after placing
   them; one ``"sdpa"`` decode step (no kernel launched) counted by the
   cost counter, its roofline terms printed beside the step's CUDA-event
   time under the policy and without it and its device busy time, and the
   counter's eager-peak temps beside ``max_memory_allocated``.
15. The engine fast-path benches (run after phase 13, on phase 3's model):
   ``benchmarks/bench_torch_kernels.py`` holds K1-K3 at
   ``bench_kernels.py``'s fp32 shapes (H = 8, K = 2, hd = 64; K3 at B 1,
   S = T = 512, causal; K1 at B 8, T 2048; K2 over 8 x 8 pages of 16 from a
   128-page pool) within TOL of their plain versions and times each beside
   its plain version and SDPA; then every row of
   ``benchmarks/bench_torch_engine_throughput.py`` runs on the model
   (batched against sequential prefill, decode tokens/s for ``sdpa``,
   ``pallas``, ``paged_sdpa`` and ``paged``, paged capacity with both rate
   ratios and a flood, occupancy) with every kernel count set to 0 just
   before: K1 and K2 launched once per layer and ``"pallas"`` / ``"paged"``
   decode pass the card ran (each eager pass and each replay of a
   recorded decode graph; a capture runs none), K3 once per layer and
   prompt pass (its fp32 launches, counted apart, are the
   ``flash_attention_bench_fp32`` record's; the rows launch none), no
   decode window short of a
   live slot, and the
   24-page pool admitting PAGED_ADMITTED requests, at least
   MIN_PAGED_CAPACITY x the dense slots.  The timing gates are printed
   beside their values; the bench's ``--check`` enforces them.

It prints one JSON line of kernel records, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WALK_BOUND = 0.02                  # x logit spread (tests/test_engine_batching.py)
MAX_LEN = 1088                     # 68 pages of 16 tokens
SLOTS = 4
LOSS_B, LOSS_S = 2, 2048           # the loss phase's batch
# |loss(flash) - loss(plain)| on a loss near ln(200064) = 12.2, the CPU
# parity tests' bound: the reference's own two paths differ by 9.3e-4 on
# the reduced model; on the card the full model's gap measures 3e-5 (both
# paths round P to bf16 before the product with V)
LOSS_BOUND = 2e-3
TRAIN_LAYERS = 16                  # of 32: fp32 params + grads + moments
# requests the engine bench's 24-page pool admits (16-token prompts, 4 new
# tokens): a count of lengths and pages only, pinned against the reference
# bench by tests/test_torch_engine_bench.py
PAGED_ADMITTED = 12


# mangled-name parts of the kernels whose ptxas report phase 1 prints in
# full: the bf16 instantiations on the main paths, and K3's fp32 body
MAIN_KERNELS = {"flash_attention": ("flash_bf16_kernel", "flash_f32_"),
                "paged_attention": "paged_split_kernelI13__nv_bfloat16Li3ELi128E",
                "decode_attention": "dense_split_kernelI13__nv_bfloat16Li3ELi128E",
                "ssd_step": "ssd_step_kernel"}
# each kernel's source files, its own first, as the `kernels` line names them
_CSRC = "src/repro_torch/csrc/"
_SPLIT = ("decode_split.cuh", "decode_attention_common.cuh", "hopper.cuh")
SOURCES = {name: ", ".join(_CSRC + f for f in files) for name, files in {
    "decode_attention": ("decode_attention.cu", *_SPLIT),
    "paged_attention": ("paged_attention.cu", *_SPLIT),
    "flash_attention": ("flash_attention.cu", "flash_attention_f32.cuh",
                        "hopper.cuh"),
    "ssd_step": ("ssd_step.cu",)}.items()}
REPLACES = {
    "decode_attention":
        "src/repro/kernels/decode_attention/decode_attention.py:61",
    "paged_attention": "src/repro/kernels/paged_attention/paged_attention.py:66",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:80",
    "ssd_step": "none (the JAX package's _ssd_step is plain jnp)"}


def ptxas_lines(log: str, needle):
    """ptxas's lines for the kernels whose name holds ``needle`` (a string
    or a tuple of them), every warning, and every note that it serialised
    ``wgmma``."""
    needles = (needle,) if isinstance(needle, str) else needle
    keep = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(n in line for n in needles)
        if keep or "warning" in line.lower() or "Performance Loss" in line:
            yield line.strip()


def spill_stores(log: str, needle: str):
    """{kernel: bytes of spill stores} for the kernels of a ptxas report
    whose mangled name holds ``needle``."""
    out, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name = hit.group(1) if needle in hit.group(1) else None
        stores = re.search(r"(\d+) bytes spill stores", line)
        if name and stores:
            out[name] = int(stores.group(1))
    return out


def peaks():
    """The H100 SXM's peaks, from the port's roofline constants
    (``repro_torch.launch.hlo_analysis``: ``PEAK_FLOPS`` bf16 dense,
    ``FP32_FLOPS``, ``HBM_BW``, ``LINK_BW``), imported once ``main`` has put
    ``src`` on the path."""
    from repro_torch.launch import hlo_analysis
    return hlo_analysis


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
    # every (G, hd, dtype) the kernels are built for, at a small size
    for dtype in (torch.float32, torch.bfloat16):
        for g in range(1, 9):
            for d in dops.HEAD_DIMS:
                args = decode_inputs(torch, gen, 3, 300, 2 * g, 2, d, dtype,
                                     [0, 257, 300])
                max_err(torch, dops.decode_attention(*args),
                        dops.decode_attention_plain(*args), dtype)
    # K2, every (G, hd, dtype) it is built for, at a small size over a few
    # splits
    for dtype in (torch.float32, torch.bfloat16):
        for g in range(1, 9):
            for d in dops.HEAD_DIMS:
                args = paged_inputs(torch, gen, 3, 41, 20, 2 * g, 2, d, dtype,
                                    [0, 257, 320])
                max_err(torch, pops.paged_attention(*args),
                        pops.paged_attention_plain(*args), dtype)
    torch.cuda.synchronize()
    print(f"K1, K2: every (G 1..8, hd {dops.HEAD_DIMS}, fp32/bf16) agrees "
          f"at a small size")
    return hold_decode_kernels(torch, F, gen, 24, 8, 128)  # Phi-4-mini


def hold_decode_kernels(torch, F, gen, h, kh, hd, suffix="", paged=True,
                        max_len=MAX_LEN, lens=(1041, 913, 760, 577)):
    """K1 and K2 at a main path's shape (B = SLOTS, T = ``max_len``, W =
    T / 16 pages of 16; ``h`` query heads over ``kh`` KV heads of ``hd``):
    edge lengths held against the plain versions in fp32 and bf16, each
    case called twice and bit-identical, then bf16 timed at the slot
    lengths ``lens`` beside the plain version and SDPA.  Returns the kernel
    records, named with ``suffix``: K1's, and K2's unless ``paged`` is
    False (a path without paged KV)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.paged_attention import ops as pops

    t, pages = max_len, max_len // 16
    g = h // kh
    shape = f"G={g} hd={hd}"
    errs = {}
    # K1 at the main path's shapes: B = slots, T = max_len, ragged with 0,
    # then lengths at the split boundaries, an empty slot beside full
    # windows and a length past T (clamped); each case called twice on the
    # same combine counters, the two outputs bit-identical
    chunk = dops.split_plan(SLOTS, t, kh, g, hd).chunk
    k1_edges = ([chunk - 1, chunk, chunk + 1, t],
                [0, t, t + 9, 2 * chunk + 1])
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for case in ([0, 1, 257, t], *k1_edges):
            args = decode_inputs(torch, gen, SLOTS, t, h, kh, hd, dtype,
                                 case)
            first = dops.decode_attention(*args)
            again = dops.decode_attention(*args)
            check(torch.equal(first, again), f"K1 lengths {case}: two calls "
                  f"in a row differ")
            worst = max(worst, max_err(torch, first,
                                       dops.decode_attention_plain(*args),
                                       dtype))
        print(f"K1 decode_attention B={SLOTS} T={t} {shape} "
              f"{dtype}: max err {worst:.3g} (splits of {chunk} keys; edge "
              f"lengths {k1_edges}; each case called twice, bit-identical)")
        if dtype == torch.bfloat16:
            errs["decode_attention"] = worst
    # K2 over the engine's page-table ladder; N = 4 * pages + 1 pages with
    # the trash page 0, shared pages, out-of-range entries (clamped) and
    # lengths past the window (clamped); then, at the full width W = pages,
    # lengths at the split boundaries, an empty slot beside full windows,
    # and two calls in a row on the same combine counters (a counter left
    # unreset, or a combine that depends on which block finishes last,
    # shows there)
    n = SLOTS * pages + 1
    split = pops.split_plan(SLOTS, pages, 16, kh, g, hd).chunk
    edges = ([split - 1, split, split + 1, pages * 16],
             [0, pages * 16, pages * 16 + 9, 2 * split + 1])
    for dtype in (torch.float32, torch.bfloat16) if paged else ():
        worst = 0.0
        ladder = sorted({min(1 << i, pages)
                         for i in range(pages.bit_length() + 1)})
        cases = [(w, [0, 1, max(1, 16 * w - 5), 16 * w + 7])
                 for w in ladder]
        cases += [(pages, case) for case in edges]
        for w, case in cases:
            q, kp, vp, table, lengths = paged_inputs(
                torch, gen, SLOTS, n, w, h, kh, hd, dtype, case)
            table[0, 0] = 0
            table[1, :] = table[2, :]
            table[3, -1] = n + 5
            table[2, 0] = -3
            want = pops.paged_attention_plain(q, kp, vp, table, lengths)
            first = pops.paged_attention(q, kp, vp, table, lengths)
            again = pops.paged_attention(q, kp, vp, table, lengths)
            check(torch.equal(first, again), f"K2 W={w} lengths {case}: two "
                  f"calls in a row differ")
            worst = max(worst, max_err(torch, first, want, dtype))
        print(f"K2 paged_attention N={n} W=1..{pages} {shape} {dtype}: "
              f"max err {worst:.3g} (splits of {split} keys; edge lengths "
              f"{edges}; each case called twice, bit-identical)")
        if dtype == torch.bfloat16:
            errs["paged_attention"] = worst
    torch.cuda.synchronize()

    # timing at the main path's shapes: bf16, slot lengths of a decode
    # step (phase 3: prompts of 512-1024 tokens plus up to 32 generated)
    lens = list(lens)
    dt = torch.bfloat16
    item = 2
    kv_bytes = sum(lens) * kh * hd * 2 * item      # K and V below length
    io_bytes = 2 * SLOTS * h * hd * item + SLOTS * 4   # q, out, lengths
    ops_ms = 4 * h * hd * sum(lens) / peaks().FP32_FLOPS * 1e3
    records = []

    def record(name, kernel, plain, sets, lib_sets, moved):
        bytes_ms = moved / peaks().HBM_BW * 1e3
        return dict(
            name=name + suffix, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], max_abs_err=errs[name],
            ms=time_ms(torch, kernel, sets),
            plain_ms=time_ms(torch, plain, sets),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=time_ms(torch, sdpa, lib_sets))

    sets = [decode_inputs(torch, gen, SLOTS, t, h, kh, hd, dt, lens)
            for _ in range(8)]
    mask_sets = []
    for q, k, v, lengths in sets:
        mask = (torch.arange(t, device="cuda")[None, None, None, :]
                < lengths[:, None, None, None])
        mask_sets.append((q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                          mask))
    sdpa = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=m, enable_gqa=True)
    records.append(record(
        "decode_attention", dops.decode_attention,
        dops.decode_attention_plain, sets, mask_sets, kv_bytes + io_bytes))
    del sets, mask_sets
    if not paged:
        torch.cuda.empty_cache()
        return report(records, lens, h, kh, hd, t)

    psets = []
    for _ in range(8):
        q, kp, vp, _, lengths = paged_inputs(torch, gen, SLOTS, n, pages, h,
                                             kh, hd, dt, lens)
        # each slot owns its pages, as the allocator hands them out
        table = (1 + torch.randperm(n - 1, generator=gen, device="cuda")
                 [:SLOTS * pages]).to(torch.int32).reshape(SLOTS, pages)
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
        psets, gsets, kv_bytes + io_bytes + SLOTS * pages * 4))
    del psets, gsets
    torch.cuda.empty_cache()
    return report(records, lens, h, kh, hd, t)


def report(records, lens, h, kh, hd, t):
    for r in records:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}"
              f" ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms (bf16, B={SLOTS}, T={t}, "
              f"H={h}, K={kh}, hd={hd}, lengths {lens})")
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
    hold_f32_split(torch, fops, gen)
    hold_prompt_flash(torch, fops, gen)
    return time_flash(torch, F, gen, LOSS_B, LOSS_S, 24, 8, 128,
                      timed=(torch.bfloat16, torch.float32))


# the prompt passes' shapes (B, S, T, H, K, hd), causal with the diagonal
# shifted by T - S: a resumed pass of width 4 and ragged length over its
# donor's keys, a resumed chat turn, a cold ragged pass of width 8, and
# Nemotron-H's cold pass (G = 8)
PROMPT_FLASH_SHAPES = ((4, 1041, 2577, 24, 8, 128),
                       (1, 512, 2560, 24, 8, 128),
                       (8, 1541, 1541, 24, 8, 128),
                       (1, 2573, 2573, 64, 8, 128))


def hold_prompt_flash(torch, fops, gen):
    """K3 against its plain version, in bf16 (the prompt pass's) and fp32,
    at PROMPT_FLASH_SHAPES: long offsets T - S and many key tiles past
    them, row counts off the 128-row blocks."""
    for b, s, t, h, kh, hd in PROMPT_FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = flash_inputs(torch, gen, b, s, t, h, kh, hd, dtype)
            err = max_err(torch, fops.flash_attention(*args, causal=True),
                          fops.flash_attention_plain(*args, causal=True),
                          dtype)
            print(f"K3 flash_attention prompt shape B={b} S={s} T={t} "
                  f"H={h} K={kh} hd={hd} {str(dtype)[6:]}: max err "
                  f"{err:.3g}")
            del args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def hold_f32_split(torch, fops, gen):
    """K3's fp32 body at the edges of its tasks, each case launched twice
    (bit-equal: the body keeps no state between calls) and held to the
    plain version: S*G one short of, at and one past its 64-row blocks
    (and two), key ranges one short of, at and one past a chunk (and two)
    in a split launch, S = 1 over T - S = 37; then one chunk of all the
    keys (``flash_attention_f32_launch`` with one slot a row block and no
    scratch) against the plan's many on the same inputs at
    ``bench_kernels.py``'s shape."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = torch.float32
    rows = fops.F32_ROWS
    cases = [(1, s, s + extra, g, 64)                # (B, S, T, G, hd)
             for g, s in ((1, rows - 1), (1, rows), (1, rows + 1),
                          (3, rows // 3), (3, rows // 3 + 1),
                          (1, 2 * rows - 1), (1, 2 * rows),
                          (1, 2 * rows + 1))
             for extra in (0, 37)]
    # one 64-row block (S = 16, G = 4) over T keys: a split of chunk keys
    s, g = rows // 4, 4
    chunk = fops.split_plan(1, s, 4 * rows, 2, g, 64, True, sms).chunk
    for t in (chunk - 1, chunk, chunk + 1, 2 * chunk - 1, 2 * chunk,
              2 * chunk + 1):
        plan = fops.split_plan(1, s, t, 2, g, 64, True, sms)
        check(plan.chunk == chunk and plan.chunks == -(-t // chunk),
              f"fp32 split of {t} keys: chunk {plan.chunk} x "
              f"{plan.chunks}, expected chunks of {chunk}")
        cases += [(1, s, t, g, d) for d in fops.HEAD_DIMS]
    cases += [(2, 1, 38, g, d) for g in (1, 4, 8) for d in (64, 128)]
    n = 0
    for b, s, t, g, d in cases:
        for causal in (True, False):
            q, k, v = flash_inputs(torch, gen, b, s, t, 2 * g, 2, d, f32)
            first = fops.flash_attention(q, k, v, causal=causal)
            again = fops.flash_attention(q, k, v, causal=causal)
            check(torch.equal(first, again),
                  f"fp32 K3 B={b} S={s} T={t} G={g} hd={d}: two launches "
                  f"differ")
            max_err(torch, first, fops.flash_attention_plain(
                q, k, v, causal=causal), f32)
            n += 1
    # one chunk against many on the same inputs
    q, k, v = flash_inputs(torch, gen, 1, 512, 512, 8, 2, 64, f32)
    plan = fops.split_plan(1, 512, 512, 2, 4, 64, True, sms)
    check(plan.chunks > 1, f"bench shape not split: {plan}")
    want = fops.flash_attention_plain(q, k, v)
    many = fops.flash_attention(q, k, v)
    one = torch.empty_like(q)
    lib, fn = fops._f32_launcher()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), one.data_ptr(), None,
            1, 512, 512, 2, 4, 64, 1, 512, 1,
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"fp32 K3 in one chunk: launch returned {rc}")
    err_many, err_one = (max_err(torch, x, want, f32) for x in (many, one))
    torch.cuda.synchronize()
    print(f"K3 fp32 split edges: {n} cases agree and repeat bit for bit "
          f"(S*G around {rows}-row blocks, keys around chunks of {chunk}, "
          f"S = 1 over 38 keys); one chunk against {plan.chunks} of "
          f"{plan.chunk} keys at B=1 S=T=512 H=8 K=2 hd=64: max err "
          f"{err_one:.3g} and {err_many:.3g}, max difference "
          f"{float((one - many).abs().max()):.3g}")


def time_flash(torch, F, gen, b, s, h, kh, hd, suffix="", timed=None):
    """K3 at a loss's shape (B = ``b``, S = T = ``s``, ``h`` query heads over
    ``kh`` KV heads of ``hd``, causal): held against its plain version in
    fp32 and bf16, then each dtype in ``timed`` (bf16 by default) timed
    beside the plain version and SDPA (TF32 off, as ``main`` sets it).
    Returns a kernel record a timed dtype, named ``flash_attention`` (bf16)
    or ``flash_attention_fp32``, with ``suffix``; the caller adds its
    launches."""
    from repro_torch.kernels.flash_attention import ops as fops

    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = flash_inputs(torch, gen, b, s, s, h, kh, hd, dtype)
        err[dtype] = max_err(torch, fops.flash_attention(*args),
                             fops.flash_attention_plain(*args), dtype)
        print(f"K3 flash_attention B={b} S=T={s} H={h} K={kh} hd={hd} "
              f"{dtype}: max err {err[dtype]:.3g}")
        del args
    torch.cuda.synchronize()

    sdpa = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    pairs = s * (s + 1) // 2                  # causal (query, key) pairs
    records = []
    for dt in timed or (torch.bfloat16,):
        size = torch.finfo(dt).bits // 8
        # sets of q, k and v together beyond the 50 MB L2
        per_set = (2 * b * s * h * hd + 2 * b * s * kh * hd) * size
        sets = [flash_inputs(torch, gen, b, s, s, h, kh, hd, dt)
                for _ in range(max(4, -(-150_000_000 // per_set)))]
        lib_sets = [tuple(x.transpose(1, 2) for x in st) for st in sets]
        moved = (sum(x.numel() for x in sets[0]) + sets[0][0].numel()) * size
        bytes_ms = moved / peaks().HBM_BW * 1e3
        peak = peaks().FP32_FLOPS if dt == torch.float32 else \
            peaks().PEAK_FLOPS
        ops_ms = 4 * b * h * hd * pairs / peak * 1e3
        fp32 = dt == torch.float32
        rec = dict(
            name="flash_attention" + ("_fp32" if fp32 else "") + suffix,
            route="cuda", source=SOURCES["flash_attention"],
            replaces=REPLACES["flash_attention"],
            max_abs_err=err[dt],
            ms=time_ms(torch, fops.flash_attention, sets),
            plain_ms=time_ms(torch, fops.flash_attention_plain, sets,
                             reps=20),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=time_ms(torch, sdpa, lib_sets))
        print(f"{rec['name']}: kernel {rec['ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; bytes "
              f"{bytes_ms:.4f} ms), plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']:.4f} ms ({str(dt)[6:]}, B={b}, S=T={s}, "
              f"H={h}, K={kh}, hd={hd}, causal)")
        records.append(rec)
        del sets, lib_sets
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------- phase 6 ---

def phase_loss(torch, model, params, cfg, counters, batch):
    """``model.train_loss`` on ``batch`` with and without the flash kernel:
    K3 launched once per layer with it, no kernel without it, the losses
    within LOSS_BOUND.  Returns the kernels' launches, with the fp32 flash
    launches of the ``use_flash=True`` run as ``flash_attention_fp32``."""
    from repro_torch.kernels import flash_attention

    shape = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
    losses, launches_of = {}, {}
    for flash in (True, False):
        model.use_flash = flash
        with torch.no_grad():
            model.train_loss(params, batch)          # warm-up
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            flash_attention.launches_f32 = 0
            loss = model.train_loss(params, batch)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            f32_launches = flash_attention.launches_f32
            t0 = time.perf_counter()
            for _ in range(3):
                model.train_loss(params, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
        model.use_flash = False
        value = float(loss)
        check(value == value and abs(value) < 1e3,
              f"use_flash={flash}: loss {value}")
        want = {fn.__name__: (cfg.num_layers if flash and
                              fn.__name__ == "flash_attention" else 0)
                for fn in counters}
        check(launches == want, f"use_flash={flash}: launches {launches}, "
              f"expected {want}")
        losses[flash] = value
        launches_of.update({k: v for k, v in launches.items() if v})
        if flash:
            launches_of["flash_attention_fp32"] = f32_launches
        print(f"loss {cfg.name} use_flash={flash}: {value:.6f} ({shape}, "
              f"{cfg.num_layers} layers), {wall * 1e3:.1f} ms per call, "
              f"launches {launches}, of them fp32 flash {f32_launches}")
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

def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def template_prompt(template: int, n: int, vocab: int):
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


@contextlib.contextmanager
def prompt_passes(model):
    """While open, the model's prompt passes of more than one query (its
    ``_run_stack`` calls with a cache and S > 1: every prompt pass goes
    through it, a decode step has S = 1, the loss has no cache) counted
    under ``"passes"`` of the yielded dict (a one-token pass, a resume
    whose whole prompt but its last token was cached, attends as a decode
    step does) and, on leaving, the prompt attention calls that took the
    plain path on the card under ``"plain"``."""
    from repro_torch.models import layers

    run_stack, seen = model._run_stack, {"passes": 0}

    def counted(params, x, caches, **kw):
        seen["passes"] += caches is not None and x.shape[1] > 1
        return run_stack(params, x, caches, **kw)
    model._run_stack = counted
    plain = layers.attention.plain_prompt_calls
    try:
        yield seen
    finally:
        seen["plain"] = layers.attention.plain_prompt_calls - plain
        del model._run_stack


def check_prompt_kernel(label, model, launches, seen):
    """K3 launched once per attention layer and prompt pass of more than
    one query (the pass attends over its live keys on the card), and no
    such prompt attention on the plain path."""
    want = model.mixers.count("attn") * seen["passes"]
    check(seen["passes"] > 0 and launches["flash_attention"] == want,
          f"{label}: {launches['flash_attention']} K3 launches for "
          f"{seen['passes']} prompt passes of {model.mixers.count('attn')} "
          f"attention layers")
    check(seen["plain"] == 0, f"{label}: {seen['plain']} prompt attention "
          f"calls took the plain path")


def serve(torch, model, params, cfg, decode_impl, requests, counters,
          max_len=MAX_LEN):
    """``requests`` — (id, tokens, max new tokens[, extras]) — through a
    cluster of 2 decoders x SLOTS slots, every kernel count set to 0 just
    before the run, K3's held to its prompt passes
    (:func:`check_prompt_kernel`); returns (cluster, done, wall seconds,
    decode steps that ran the model, each kernel's launches)."""
    from repro_torch.serving.disagg import DisaggregatedCluster, ServeRequest

    cluster = DisaggregatedCluster(
        model, params, num_decode=2, slots_per_worker=SLOTS, max_len=max_len,
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
    for rid, toks, max_new, *extras in requests:
        cluster.submit(ServeRequest(rid, toks, max_new_tokens=max_new,
                                    extras=extras[0] if extras else None))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    with prompt_passes(model) as seen:
        t0 = time.perf_counter()
        done = cluster.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    check_prompt_kernel(f"{cfg.name} {decode_impl}", model, launches, seen)
    return cluster, done, wall, steps[0], launches


def slice_requests(vocab: int):
    """The serving slice's 12 requests: prompts of 512-1024 tokens over 3
    templates, 32 new tokens each; and a short one that warms the
    allocator and the library handles outside the measured runs."""
    lens = [512 + (i * 173) % 513 for i in range(12)]
    return ([(f"req-{i}", template_prompt(i % 3, lens[i], vocab), 32)
             for i in range(12)],
            [("warm", template_prompt(7, 520, vocab), 2)])


def serving_line(torch, done, wall):
    ttft = sorted(r.ttft for r in done)
    gen_tokens = sum(len(r.output) - 1 for r in done)
    return (f"TTFT p50 {percentile(ttft, 0.5) * 1e3:.1f} ms p99 "
            f"{percentile(ttft, 0.99) * 1e3:.1f} ms, decode "
            f"{gen_tokens / wall:.1f} tokens/s over {wall:.2f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_slice(torch, model, params, cfg, counters):
    requests, warm = slice_requests(cfg.vocab_size)
    serve(torch, model, params, cfg, "pallas", warm, counters)
    logs = {}
    launches_of = {}
    for impl, kernel in (("pallas", "decode_attention"),
                         ("paged", "paged_attention")):
        cluster, done, wall, steps, launches = serve(
            torch, model, params, cfg, impl, requests, counters)
        check(len(done) == 12, f"{impl}: {len(done)} of 12 requests done")
        check(all(len(r.output) == 33 for r in done),
              f"{impl}: output lengths {[len(r.output) for r in done]}")
        check(steps > 0 and launches[kernel] == cfg.num_layers * steps,
              f"{impl}: {launches[kernel]} launches of {kernel} for {steps} "
              f"decode steps of {cfg.num_layers} layers")
        other = sum(v for k, v in launches.items()
                    if k not in (kernel, "flash_attention"))
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
        replays = sum(d.graph_replays for d in cluster.decoders)
        captures = sum(d.graph_captures for d in cluster.decoders)
        print(f"slice {cfg.name} {impl}: 12 requests, {steps} decode "
              f"steps ({replays} replayed, {captures} graphs recorded), "
              f"{launches[kernel]} {kernel} launches, "
              f"{launches['flash_attention']} K3 launches, "
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


def run_counted(torch, runner, counters, label):
    """The runner's warm-up, then ``runner.run()`` with every kernel count
    set to 0 just before and read just after, K3's held to the run's
    prompt passes (:func:`check_prompt_kernel`); returns (result,
    launches, wall seconds of the run alone)."""
    runner._warmup()
    runner.warmup_enabled = False
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    model = runner.cluster.prefill.model
    with prompt_passes(model) as seen:
        t0 = time.perf_counter()
        res = runner.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    check_prompt_kernel(label, model, launches, seen)
    return res, launches, wall


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
        res, launches, wall = run_counted(torch, runner, counters, name)
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
        check(sum(launches.values())
              == launches[kernel] + launches["flash_attention"],
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
    res, launches, wall = run_counted(torch, runner, counters, "flood")
    check(len(res.requests) == 24, f"flood: {len(res.requests)} of 24 done")
    check(all(len(r.output) == 33 for r in res.requests),
          f"flood: output lengths {[len(r.output) for r in res.requests]}")
    check(all(len(s.tokens) == 128 for s in runner.specs),
          "flood: prompts are not 128 tokens")
    check(launches["paged_attention"] > 0 and sum(launches.values())
          == launches["paged_attention"] + launches["flash_attention"],
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

def phase_walk(torch, model, params, cfg, paged=True, n_prompt=624,
               extras=None, offset=0, max_len=MAX_LEN, plain="sdpa",
               watch=()):
    """16 forced decode steps on the kernel path and on the plain path
    (each fed the plain path's argmax), from two copies of one prefill of
    ``n_prompt`` tokens (with ``extras``, the request's frontend inputs):
    ``"pallas"`` against ``plain``, and unless ``paged`` is False (a model
    without paged KV) ``"paged"`` against ``"paged_sdpa"``.  Decode step i
    runs at position ``offset + n_prompt + i``: a VLM's prefill holds its
    ``offset`` patch positions before the tokens.  Returns the worst
    max|dlogits| / spread.

    ``plain`` is ``"sdpa"`` (the masked softmax with bf16 probabilities,
    as the reference's ``_sdpa``) or ``"k1_plain"``: the ``"pallas"`` path
    with K1's plain version, ``decode_attention_plain``, in the kernel's
    place (the kernel's own arithmetic: fp32 softmax and products).
    ``watch`` names more paths, from ``"sdpa"`` and ``"k1_plain"``, that
    take the same tokens on copies of their own; their distances to the
    two compared paths are printed, not bounded (models without MoE).

    In an MoE model the two paths' bf16 hidden states differ in the last
    bit, so where a router's k-th and (k+1)-th logits nearly tie the paths
    may pick different experts, and a flipped choice moves the logits by
    more than any smooth bound.  So each step runs the plain path first and
    the kernel path takes its expert ids, layer by layer (with gate weights
    from its own logits at those ids).  How far the kernel path's router
    logits drift from the plain path's, and how many of its own choices
    differ (its near-tie flips), are printed: the router itself is held
    against the reference on the CPU (tests/test_torch_moe*.py)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine

    check(not (watch and cfg.moe), "watched paths need a model without MoE")

    def decode(impl, caches, arr, cur, table):
        if impl != "k1_plain":
            return model.decode(params, caches, arr, cur, decode_impl=impl,
                                page_table=table)[0]
        inner = L.decode_attention
        L.decode_attention = dops.decode_attention_plain
        try:
            return model.decode(params, caches, arr, cur,
                                decode_impl="pallas")[0]
        finally:
            L.decode_attention = inner

    toks = template_prompt(0, n_prompt, cfg.vocab_size)
    pre = PrefillEngine(model, params, max_len, cache_entries=0,
                        device="cuda")
    logits, caches = pre.prefill(toks, extras)
    first = int(logits.argmax())
    # dense: kernel vs plain on two copies of the same cache
    watched = {w: {n: t.clone() for n, t in caches.items()} for w in watch}
    pairs = [("pallas", plain, caches,
              {n: t.clone() for n, t in caches.items()}, None)]
    if paged:
        dec = DecodeEngine(model, params, num_slots=1, max_len=max_len,
                           decode_impl="paged", device="cuda")
        dec.admit(0, "walk", caches, first, prompt_len=len(toks), max_new=16)
        table = torch.as_tensor(dec.page_table, device="cuda")
        pairs.append(("paged", "paged_sdpa", dec.caches,
                      {n: t.clone() for n, t in dec.caches.items()}, table))
    recorded, flips, following = [], [], [False]
    route = moe_lib._route

    def routed(p, xn, k):
        logits, w, idx = route(p, xn, k)
        if not following[0]:                    # the plain path records
            recorded.append((logits, idx))
            return logits, w, idx
        want, ids = recorded[len(flips)]        # the kernel path follows
        flips.append((torch.any(torch.sort(idx, -1).values
                                != torch.sort(ids, -1).values, -1).sum(),
                      (logits - want).abs().max()))
        return logits, torch.softmax(torch.gather(logits, 1, ids), -1), ids
    moe_lib._route = routed
    overall = 0.0
    try:
        for kern, plain, ck, cp, tbl in pairs:
            tok, worst, n_flips, choices, router = first, 0.0, 0, 0, 0.0
            far = {(w, side): 0.0 for w in watched if tbl is None
                   for side in (kern, plain)}
            for step in range(16):
                cur = offset + len(toks) + step
                arr = torch.full((1, 1), tok, dtype=torch.int32,
                                 device="cuda")
                recorded.clear()
                flips.clear()
                following[0] = False
                lp = decode(plain, cp, arr, cur, tbl)
                following[0] = True
                lk = decode(kern, ck, arr, cur, tbl)
                check(len(flips) == len(recorded),
                      f"walk {kern}: the paths made different MoE calls")
                for n, dmax in flips:
                    n_flips += int(n)
                    router = max(router, float(dmax))
                choices += len(flips)
                check(bool(torch.isfinite(lk).all()),
                      f"{kern}: non-finite logits")
                spread = float(lp.max() - lp.min())
                diff = float((lk - lp).abs().max())
                check(diff < WALK_BOUND * spread,
                      f"walk {kern} vs {plain} step {step}: {diff:.4g} >= "
                      f"{WALK_BOUND} x spread {spread:.4g}")
                worst = max(worst, diff / spread)
                for w in watched if tbl is None else ():
                    lw = decode(w, watched[w], arr, cur, None)
                    sw = float(lw.max() - lw.min())
                    for side, ls in ((kern, lk), (plain, lp)):
                        far[w, side] = max(far[w, side],
                                           float((ls - lw).abs().max()) / sw)
                tok = int(lp.argmax())
            note = (f"; router logits within {router:.4g} of the plain "
                    f"path's, {n_flips} of {choices} expert sets of its own "
                    f"differ from them (near-ties)") if choices else ""
            print(f"walk {cfg.name} {kern} vs {plain}: 16 steps from "
                  f"position {offset + len(toks)}, max |dlogits| / spread "
                  f"{worst:.4g} (bound {WALK_BOUND}){note}")
            for (w, side), d in far.items():
                print(f"walk {cfg.name} {side} vs {w} (watched, same "
                      f"tokens): max |dlogits| / spread {d:.4g}")
            overall = max(overall, worst)
    finally:
        moe_lib._route = route
    return overall


# ------------------------------------------------------------- phase 9 ---

MOE_ARCH = "qwen3-moe-30b-a3b"


def init_on_card(torch, cfg):
    """``cfg``'s model with bf16 weights drawn on the card from seed 0, one
    leaf at a time; prints its shape, size and init time."""
    from repro_torch.models import Model

    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    check(all(t.dtype == torch.bfloat16 and t.is_cuda for t in leaves),
          "params are not all bf16 on the card")
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    mixers = {m: model.mixers.count(m) for m in sorted(set(model.mixers))}
    m = cfg.moe
    moe = (f" experts={m.num_experts} top-{m.top_k} d_ff_expert="
           f"{m.d_ff_expert}" if m else "")
    print(f"model: {cfg.name} {cfg.num_layers}L {mixers} d={cfg.d_model} "
          f"H={cfg.num_heads} K={cfg.num_kv_heads} "
          f"hd={cfg.resolved_head_dim}{moe} vocab={cfg.vocab_size}, "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params bf16 "
          f"({n_bytes / 2**30:.2f} GiB), init {time.perf_counter() - t0:.1f} s")
    return model, params


def phase_moe(torch, F, counters):
    """The MoE slice at full width: K1 and K2 held and timed at the model's
    attention shape, then the model (bf16, drawn on the card one leaf at a
    time) served through the cluster with both kernels and walked against
    the plain paths, as phases 3 and 4 do for Phi-4-mini."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    suffix = f"_g{h // kh}_hd{hd}"
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = hold_decode_kernels(torch, F, gen, h, kh, hd, suffix)

    model, params = init_on_card(torch, cfg)
    launches = phase_slice(torch, model, params, cfg, counters)
    phase_walk(torch, model, params, cfg)
    for r in records:
        r["launches"] = launches[r["name"][:-len(suffix)]]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ phase 10 ---

HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 16   # two periods of 8
SSM_ARCH = "xlstm-125m"


def serve_gated(torch, model, params, cfg, counters, requests, warm,
                max_len=MAX_LEN):
    """``requests`` through the cluster with the dense decode kernel on a
    model whose engine gates are off (recurrent mixers, an
    encoder-decoder, a VLM), after the ``warm`` ones: every request done
    with 33 tokens; K1 launched once per self-attention layer and decode
    step, ``ssd_step`` once per Mamba layer and decode step, K3 once per
    self-attention layer and prompt pass (:func:`serve`), and no other
    kernel; no prefix resumed or stored; every cold
    bucket one exact length (no right-padding), and every request with
    ``extras`` its own single-request prompt pass; a cross layer's
    attention on the plain path, once a layer per prompt pass and decode
    step; a paged decoder refused; every request routed.  Returns (each
    kernel's launches, the serving line)."""
    from repro_torch.serving.engine import DecodeEngine

    n_attn = model.mixers.count("attn")
    n_mamba = model.mixers.count("mamba")
    serve(torch, model, params, cfg, "pallas", warm, counters, max_len)
    buckets, passes, cross = [], [], [0]
    inner_b, inner_p = model.prefill_batched, model.prefill
    inner_x = model._cross_cached

    def batched(params, tokens, lengths, max_len=None):
        buckets.append((tokens.shape[1], lengths.tolist()))
        return inner_b(params, tokens, lengths, max_len)

    def single(params, batch, max_len=None):
        passes.append({k: tuple(v.shape) for k, v in batch.items()})
        return inner_p(params, batch, max_len)

    def cross_cached(*args):
        cross[0] += 1
        return inner_x(*args)
    model.prefill_batched, model.prefill = batched, single
    model._cross_cached = cross_cached
    try:
        cluster, done, wall, steps, launches = serve(
            torch, model, params, cfg, "pallas", requests, counters, max_len)
    finally:
        del model.prefill_batched, model.prefill, model._cross_cached
    k4 = launches["ssd_step"]
    check(k4 == n_mamba * steps, f"{cfg.name}: {k4} ssd_step launches for "
          f"{steps} decode steps of {n_mamba} Mamba layers")
    check(len(done) == 12, f"{cfg.name}: {len(done)} of 12 requests done")
    check(all(len(r.output) == 33 for r in done),
          f"{cfg.name}: output lengths {[len(r.output) for r in done]}")
    check(steps > 0 and launches["decode_attention"] == n_attn * steps,
          f"{cfg.name}: {launches['decode_attention']} K1 launches for "
          f"{steps} decode steps of {n_attn} attention layers")
    check(sum(launches.values()) == launches["decode_attention"] + k4
          + launches["flash_attention"],
          f"{cfg.name}: other kernels launched: {launches}")
    st = cluster.prefill.stats
    check(st.reused_blocks == 0, f"{cfg.name}: a prefix was resumed")
    check(not cluster.prefill._cache, f"{cfg.name}: a prefix was stored")
    n_extras = sum(len(r) > 3 for r in requests)
    check(all(set(lens) == {plen} for plen, lens in buckets)
          and len(buckets) + len(passes) > 0,
          f"{cfg.name}: a cold bucket right-padded a row: {buckets}")
    check(len(passes) == n_extras
          and all(p["tokens"][0] == 1 for p in passes),
          f"{cfg.name}: {len(passes)} single-request passes for {n_extras} "
          f"requests with extras: {passes}")
    check(st.padded_tokens == 0, f"{cfg.name}: {st.padded_tokens} pad tokens")
    check(cross[0] == model.n_cross * (steps + len(passes) + len(buckets)),
          f"{cfg.name}: {cross[0]} cached cross attentions for {steps} "
          f"steps and {len(passes) + len(buckets)} prompt passes of "
          f"{model.n_cross} cross layers")
    check(len(cluster.control.decision_log) == 12,
          f"{cfg.name}: {len(cluster.control.decision_log)} routing decisions")
    try:
        DecodeEngine(model, params, num_slots=1, max_len=64,
                     decode_impl="paged", device="cuda")
    except ValueError as e:
        check("paged KV" in str(e), f"{cfg.name}: paged decoder: {e!r}")
    else:
        fail(f"{cfg.name}: a paged decoder was built")
    line = serving_line(torch, done, wall)
    print(f"slice {cfg.name} pallas: 12 requests, {steps} decode steps, "
          f"{launches['decode_attention']} decode_attention launches "
          f"({n_attn} attention layers), {k4} ssd_step launches ({n_mamba} "
          f"Mamba layers), {launches['flash_attention']} K3 launches, no "
          f"other kernel, resumed blocks "
          f"{st.reused_blocks}/{st.total_blocks}, {len(buckets)} exact-length "
          f"prompt passes, {len(passes)} single-request passes with extras, "
          f"{cross[0]} plain cached cross attentions, paged decoder refused, "
          f"{line}")
    del cluster, done
    gc.collect()
    torch.cuda.empty_cache()
    return launches, line


# K4 at Nemotron-H's Mamba layer (B 32 slots, H 256, G 8, N 256, P 64), at
# Jamba's (G 1, N 16, P 64) and at the tiny test configs' (N 4, P 16)
SSD_SHAPES = {"nemotron_h": (32, 256, 8, 256, 64), "jamba": (4, 128, 1, 16, 64),
              "tiny": (4, 4, 2, 4, 16)}


def ssd_inputs(torch, gen, b, h, g, n, p, dtype):
    """The Mamba step's inputs as the cached block hands them over: x, B
    and C slices of one projection row, dt > 0 in fp32, A_log = log(1..H)
    in bf16 and a random fp32 state."""
    dev = "cuda"
    proj = torch.randn((b, h * p + 2 * g * n + 8), generator=gen,
                       device=dev).to(dtype)
    x = proj[:, :h * p].view(b, h, p)
    b_in = proj[:, h * p:h * p + g * n].view(b, g, n)
    c_in = proj[:, h * p + g * n:h * p + 2 * g * n].view(b, g, n)
    dt = torch.rand((b, h), generator=gen, device=dev) * 0.1 + 1e-3
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=dev)).to(torch.bfloat16)
    state = torch.randn((b, h, n, p), generator=gen, device=dev)
    return x, dt, a_log, b_in, c_in, state


def hold_ssd_step(torch):
    """K4, the Mamba decode step's kernel, at every shape of SSD_SHAPES in
    bf16 and fp32: the new state bit for bit the plain step's, written in
    place; y within twice the fp32 summation-order error of N terms of the
    plain step's; two runs from one state bit-identical.  Then timed at
    Nemotron-H's shape in bf16 over states past the L2, beside the plain
    step with its copy back into the cache (what the path ran before K4)
    and the bound: the state read once and written once.  Returns K4's
    record; phase 10 adds its launches on Jamba's serving path."""
    from repro_torch.kernels.ssd_step import ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = 0.0
    for shape, (b, h, g, n, p) in SSD_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_inputs(torch, gen, b, h, g, n, p, dtype)
            start = args[-1].clone()
            want_y, want = ops.ssd_step_plain(*args)
            y, got = ops.ssd_step(*args)
            check(got is args[-1], f"K4 {shape}: state not updated in place")
            check(torch.equal(got, want), f"K4 {shape} {dtype}: state differs "
                  f"from the plain step's")
            c = args[4].float().reshape(b, g, 1, n, 1)
            mag = (c.abs() * want.abs().view(b, g, h // g, n, p)).sum(3)
            bound = (2 * n * torch.finfo(torch.float32).eps
                     * mag.reshape(b, h, p))
            err = (y - want_y).abs()
            check(bool((err <= bound).all()), f"K4 {shape} {dtype}: y off by "
                  f"{float(err.max()):.3g}, past the summation bound")
            worst = max(worst, float(err.max()))
            args[-1].copy_(start)
            y2, again = ops.ssd_step(*args)
            check(torch.equal(y2, y) and torch.equal(again, want),
                  f"K4 {shape} {dtype}: two runs differ")
            del args, start, want, want_y, y, y2, got, again
    torch.cuda.synchronize()
    print(f"K4 ssd_step {list(SSD_SHAPES)}, bf16 and fp32: state bit-equal "
          f"to the plain step's, in place; y max err {worst:.3g}; repeated "
          f"runs bit-identical")

    b, h, g, n, p = SSD_SHAPES["nemotron_h"]
    sets = [ssd_inputs(torch, gen, b, h, g, n, p, torch.bfloat16)
            for _ in range(2)]                  # 1.07 GB of state
    state_bytes = b * h * n * p * 4
    moved = (2 * state_bytes + b * h * p * (2 + 4)    # x in, y out
             + b * h * 4 + h * 2 + 2 * b * g * n * 2)  # dt, A_log, B, C
    bound_ms = moved / peaks().HBM_BW * 1e3

    def plain(*args):
        args[-1].copy_(ops.ssd_step_plain(*args)[1])
    rec = dict(name="ssd_step", route="cuda", source=SOURCES["ssd_step"],
               replaces=REPLACES["ssd_step"], max_abs_err=worst,
               ms=time_ms(torch, ops.ssd_step, sets),
               plain_ms=time_ms(torch, plain, sets), bound_ms=bound_ms,
               bound_by="bytes", library_ms=None)
    del sets
    torch.cuda.empty_cache()
    print(f"ssd_step: kernel {rec['ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes: {moved / 1e9:.4f} GB), {bound_ms / rec['ms']:.1%} of it; "
          f"plain with the cache copy {rec['plain_ms']:.4f} ms (bf16, B={b}, "
          f"H={h}, G={g}, N={n}, P={p}; no library call computes it)")
    return rec


def phase_recurrent(torch, F, counters):
    """The SSM and hybrid families at full width: K1 held and timed at
    Jamba's attention shape (G = 4, hd = 128, K = 8; Jamba has no paged
    path) and K4 (``hold_ssd_step``), then jamba-v0.1-52b at 16 of its 32
    layers and xlstm-125m at full size, each served as phase 3 serves (K1
    and K4 only) and walked as phase 4 walks (``"pallas"`` against
    ``"sdpa"``); K4's launches are Jamba's."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              num_layers=HYBRID_LAYERS)
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    suffix = f"_g{h // kh}_hd{hd}"
    gen = torch.Generator(device="cuda").manual_seed(3)
    records = hold_decode_kernels(torch, F, gen, h, kh, hd, suffix,
                                  paged=False)
    records.append(hold_ssd_step(torch))
    for arch_cfg in (cfg, get_config(SSM_ARCH)):
        t0 = time.perf_counter()
        model, params = init_on_card(torch, arch_cfg)
        requests, warm = slice_requests(arch_cfg.vocab_size)
        launches, _ = serve_gated(torch, model, params, arch_cfg, counters,
                                  requests, warm)
        if arch_cfg is cfg:
            records[0]["launches"] = launches["decode_attention"]
            records[1]["launches"] = launches["ssd_step"]
        else:
            check(launches["decode_attention"] == 0,
                  f"{arch_cfg.name}: {launches} K1 launches")
        phase_walk(torch, model, params, arch_cfg, paged=False)
        print(f"{arch_cfg.name}: served and walked in "
              f"{time.perf_counter() - t0:.1f} s")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ phase 11 ---

VLM_ARCH, ENCDEC_ARCH = "phi-3-vision-4.2b", "seamless-m4t-medium"
# 576 patches + 1,024 tokens + 33 = 1,633 positions, in 128-key splits
VLM_MAX_LEN = 1664
VLM_LENS = (1617, 1489, 1336, 1153)    # 576 + phase 3's timed lengths
VLM_LOSS_S = 2048                      # 576 patches + 1,472 tokens
ENCDEC_MAX_LEN = 128                   # decoder prompts of 16-64 + 33
ENCDEC_LENS = (96, 81, 62, 47)         # prompts of 64-15 + 32 generated


def vlm_requests(cfg):
    """Phase 3's 12 prompts and its warm-up one, each with (576, 1024)
    patches drawn from a numpy seed."""
    import numpy as np

    def patches(i):
        return np.random.default_rng([18, i]).standard_normal(
            (cfg.num_patches, cfg.frontend_dim), dtype=np.float32)
    requests, warm = slice_requests(cfg.vocab_size)
    return ([(rid, t, m, {"patches": patches(i)})
             for i, (rid, t, m) in enumerate(requests)],
            [(rid, t, m, {"patches": patches(99)}) for rid, t, m in warm],
            patches(100))


def encdec_requests(cfg):
    """12 decoder prompts of 16-64 tokens over 3 templates, 32 new tokens
    each, each with (n, 160) frames, n drawn in 1,024-2,048 from a numpy
    seed; a warm-up one; and the walk's frames."""
    import numpy as np

    rng = np.random.default_rng(18)

    def frames(n):
        return rng.standard_normal((n, cfg.frontend_dim), dtype=np.float32)
    lens = rng.integers(16, 65, size=12)
    n_frames = rng.integers(1024, 2049, size=12)
    requests = [(f"req-{i}", template_prompt(i % 3, int(lens[i]),
                                             cfg.vocab_size), 32,
                 {"frames": frames(int(n_frames[i]))}) for i in range(12)]
    warm = [("warm", template_prompt(7, 20, cfg.vocab_size), 2,
             {"frames": frames(1024)})]
    return requests, warm, frames(1536)


def phase_multimodal(torch, F, counters, gpu):
    """The encoder-decoder and VLM families at full size: K1 and K2 held
    and timed at Phi-3-vision's attention shape (G = 1, hd = 96, K = 32:
    the new instantiations; K2 is off the path, paged decode being refused
    for these families), K1 at SeamlessM4T-medium's (G = 1, hd = 64, K =
    16) and K3 at the VLM loss's (B = 1, S = 2,048, H = K = 32, hd = 96);
    then each model served with ``extras`` on every request and walked, and
    the VLM's loss with and without K3."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training.data import batch_for_model

    vlm, encdec = get_config(VLM_ARCH), get_config(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(4)
    k1_vlm, k2_vlm = hold_decode_kernels(
        torch, F, gen, vlm.num_heads, vlm.num_kv_heads, vlm.resolved_head_dim,
        "_g1_hd96", max_len=VLM_MAX_LEN, lens=VLM_LENS)
    k1_encdec, = hold_decode_kernels(
        torch, F, gen, encdec.num_heads, encdec.num_kv_heads,
        encdec.resolved_head_dim, "_g1_hd64", paged=False,
        max_len=ENCDEC_MAX_LEN, lens=ENCDEC_LENS)
    k3_vlm, = time_flash(torch, F, gen, 1, VLM_LOSS_S, vlm.num_heads,
                         vlm.num_kv_heads, vlm.resolved_head_dim, "_g1_hd96")
    print(f"{k2_vlm['name']}: not on a path (paged decode is refused for "
          f"the VLM), held and timed only")

    t0 = time.perf_counter()
    model, params = init_on_card(torch, vlm)
    requests, warm, walk_patches = vlm_requests(vlm)
    launches, line = serve_gated(
        torch, model, params, vlm, counters, requests, warm, VLM_MAX_LEN)
    k1_vlm["launches"] = launches["decode_attention"]
    # With its random patches the VLM amplifies last-bit differences: two
    # plain paths with fp32 attention that differ only in summation order
    # land 0.008-0.014 x spread apart, and the bf16 probabilities of
    # "sdpa" 0.014-0.022 from either (an H100).  So the kernel path is held
    # to K1's plain version in its place, and "sdpa" is watched.
    walk = phase_walk(torch, model, params, vlm, paged=False,
                      extras={"patches": walk_patches},
                      offset=vlm.num_patches, max_len=VLM_MAX_LEN,
                      plain="k1_plain", watch=("sdpa",))
    print(f"phase 11 {vlm.name}: {line}, {k1_vlm['launches']} K1 launches, "
          f"walk {walk:.4g} x spread; {gpu}")
    batch = batch_for_model(vlm, ShapeConfig("vlm-loss", VLM_LOSS_S, 1,
                                             "train"), 0, device="cuda")
    k3_vlm["launches"] = phase_loss(torch, model, params, vlm, counters,
                                    batch)["flash_attention"]
    print(f"{vlm.name}: served, walked and its loss run in "
          f"{time.perf_counter() - t0:.1f} s")
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, params = init_on_card(torch, encdec)
    requests, warm, walk_frames = encdec_requests(encdec)
    launches, line = serve_gated(
        torch, model, params, encdec, counters, requests, warm,
        ENCDEC_MAX_LEN)
    k1_encdec["launches"] = launches["decode_attention"]
    walk = phase_walk(torch, model, params, encdec, paged=False, n_prompt=48,
                      extras={"frames": walk_frames}, max_len=ENCDEC_MAX_LEN,
                      watch=("k1_plain",))
    print(f"phase 11 {encdec.name}: {line}, {k1_encdec['launches']} K1 "
          f"launches, walk {walk:.4g} x spread; {gpu}")
    print(f"{encdec.name}: served and walked in "
          f"{time.perf_counter() - t0:.1f} s")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return [k1_vlm, k1_encdec, k3_vlm]


# ------------------------------------------------------------ phase 12 ---

# what the port's lint pass checks: its package, its tests, benchmarks and
# examples, and this script
LINT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
              "benchmarks/bench_torch_*.py", "examples/torch_*.py",
              "chip_smoke.py")
# findings each bad fixture must give under its own rule: the reference's
# minima for the rules it shares, one per finding shape for the others
LINT_MIN_BAD = {"RA001": 4, "RA002": 3, "RA003": 5, "RA004": 4, "RA005": 8,
                "RA006": 3, "RA007": 3, "RA008": 1, "RA009": 3, "RA010": 4,
                "RA011": 5}
LINT_FIXTURES = ROOT / "src" / "repro_torch" / "analysis" / "fixtures"
QCHUNK_PROMPT = 1041       # > 1024: 2 query blocks by default, 5 of 256, 1
QCHUNK_OVERRIDES = (None, 256, 2048)
PROMPT_TOL = 2e-3          # rtol and atol (tests/test_engine_batching.py:88)


def lint_paths_here():
    """LINT_PATHS with their globs expanded, relative to the repo root."""
    out = []
    for pattern in LINT_PATHS:
        out += sorted(str(p.relative_to(ROOT)) for p in ROOT.glob(pattern))
    return out


def stage_bad_fixtures(stage: Path):
    """Each bad fixture (``.py.txt``, which no tree walk takes) copied to a
    ``.py`` path under ``stage`` that its rule scopes: RA009's as an
    event-clock module, the rest under the port's fixture directory.
    Returns {code: path}."""
    out = {}
    for code in sorted(LINT_MIN_BAD):
        rel = ("serving/simulator.py" if code == "RA009"
               else f"analysis/fixtures/{code.lower()}_bad.py")
        dst = stage / code / "src" / "repro_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((LINT_FIXTURES / f"{code.lower()}_bad.py.txt")
                       .read_text())
        out[code] = dst
    return out


def lint_cli(*args):
    """``python -m repro_torch.analysis *args`` from the repo root, started
    (not waited for)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_lint():
    """The port's lint pass from its CLI: exit 0 over LINT_PATHS with no
    allowlist, and exit 1 with at least LINT_MIN_BAD findings on each bad
    fixture under ``--select`` its code, all processes started at once."""
    import shutil

    from repro_torch.analysis.lint import RULES, iter_python_files

    check(sorted(r.code for r in RULES) == sorted(LINT_MIN_BAD),
          f"lint rules {[r.code for r in RULES]}")
    paths = lint_paths_here()
    n_files = len(iter_python_files([str(ROOT / p) for p in paths]))
    stage = ROOT / "build" / "lint_fixtures"
    shutil.rmtree(stage, ignore_errors=True)
    staged = stage_bad_fixtures(stage)
    t0 = time.perf_counter()
    tree = lint_cli(*paths)
    bad = {code: lint_cli("--select", code, str(path))
           for code, path in staged.items()}
    out, _ = tree.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    check(tree.returncode == 0, f"lint: exit {tree.returncode} over the "
          f"port's tree:\n{out}")
    counts = {}
    for code, proc in bad.items():
        text, _ = proc.communicate(timeout=600)
        counts[code] = sum(f": {code} " in line for line in text.splitlines())
        check(proc.returncode == 1 and counts[code] >= LINT_MIN_BAD[code],
              f"lint {code} bad fixture: exit {proc.returncode}, "
              f"{counts[code]} findings (need >= {LINT_MIN_BAD[code]}):\n"
              f"{text}")
    shutil.rmtree(stage, ignore_errors=True)
    print(json.dumps({"lint": {"files": n_files, "rules": len(RULES),
                               "findings": 0, "seconds": seconds,
                               "bad_fixture_findings": counts}}))


def phase_q_chunk(torch, model, params, cfg, gpu):
    """One prompt pass of QCHUNK_PROMPT tokens on the full model with
    ``COMPUTE_DTYPE`` at fp32 (restored after), at the default query block
    (Q_CHUNK = 1024) and with ``runtime_flags.Q_CHUNK_OVERRIDE`` at 256
    and 2048 (restored after): each pass's CUDA-event ms (stream time, so
    the host's gaps between launches count), peak memory and distance to
    the default's last logits, within PROMPT_TOL.  An fp32 pass attends on
    the plain ``_sdpa_chunked``, which the flag blocks; a bf16 one attends
    on K3, which it does not reach."""
    from repro_torch.models import layers
    from repro_torch.models import runtime_flags as flags

    toks = torch.tensor([template_prompt(5, QCHUNK_PROMPT, cfg.vocab_size)],
                        dtype=torch.long, device="cuda")

    def prompt_pass(chunk):
        flags.Q_CHUNK_OVERRIDE = chunk
        with torch.no_grad():
            model.prefill(params, {"tokens": toks})           # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, caches = model.prefill(params, {"tokens": toks})
            end.record()
            torch.cuda.synchronize()
        del caches
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(logits).all()), f"q_chunk {chunk}: "
              f"logits not finite")
        return (logits.float(), start.elapsed_time(end),
                (peak - base) / 2**30, peak / 2**30)

    prev, dtype = flags.Q_CHUNK_OVERRIDE, layers.COMPUTE_DTYPE
    plain = layers.attention.plain_prompt_calls
    try:
        layers.COMPUTE_DTYPE = torch.float32
        runs = {chunk: prompt_pass(chunk) for chunk in QCHUNK_OVERRIDES}
    finally:
        flags.Q_CHUNK_OVERRIDE, layers.COMPUTE_DTYPE = prev, dtype
    check(flags.Q_CHUNK_OVERRIDE == prev and layers.COMPUTE_DTYPE == dtype,
          "Q_CHUNK_OVERRIDE or COMPUTE_DTYPE not restored")
    plain = layers.attention.plain_prompt_calls - plain
    want_plain = 2 * len(QCHUNK_OVERRIDES) * model.mixers.count("attn")
    check(plain == want_plain, f"q_chunk: {plain} plain prompt attention "
          f"calls, expected {want_plain} (every fp32 pass's)")
    want = runs[None][0]
    spread = float(want.max() - want.min())
    for chunk, (got, ms, extra, peak) in runs.items():
        block = chunk or layers.Q_CHUNK
        err = float((got - want).abs().max())
        check(bool(((got - want).abs()
                    <= PROMPT_TOL + PROMPT_TOL * want.abs()).all()),
              f"q_chunk {block} (fp32): last logits differ from the "
              f"default's by {err:.4g} (rtol = atol = {PROMPT_TOL})")
        print(f"q_chunk {block} ({-(-QCHUNK_PROMPT // block)} query blocks; "
              f"override {chunk}) fp32: prompt pass {QCHUNK_PROMPT} tokens "
              f"{cfg.name} {ms:.2f} ms (CUDA events), peak {peak:.3f} GiB "
              f"({extra:.3f} GiB over what was held), max |logit - default| "
              f"{err:.4g} ({err / spread:.4g} x spread; bound {PROMPT_TOL}) "
              f"[{gpu}]")


# ------------------------------------------------------------ phase 13 ---

SHARD_PROMPT, SHARD_STEPS = 624, 16      # phase 4's walk
SHARD_GRAD_TOKENS = 256                  # the compressed gradients' batch


def phase_sharded(torch, F, model, params, cfg, gpu, counters):
    """Phase 13 (module docstring).  Returns the ``kernels`` record of K1
    on the policy walk's local shards: held against its plain version and
    timed on the inputs of the walk's last call, with its launches."""
    import contextlib
    import tempfile

    import torch.distributed as dist
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding import ShardingPolicy, use_policy
    from repro_torch.sharding.specs import device_put, param_shardings
    from repro_torch.training.compression import (compress_grads,
                                                  compressed_psum,
                                                  init_error_feedback)

    toks = torch.tensor([template_prompt(0, SHARD_PROMPT, cfg.vocab_size)],
                        dtype=torch.long, device="cuda")

    def prompt_ms(p, ctx):
        with torch.no_grad(), ctx():
            model.prefill(p, {"tokens": toks})                # warm-up
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model.prefill(p, {"tokens": toks})
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        return times

    def walk(p, ctx, feed=None):
        """16 decode steps from one prefill; each step takes ``feed[i]``,
        or its own argmax.  Returns (logits per step, tokens fed)."""
        out, fed = [], []
        with torch.no_grad(), ctx():
            logits, caches = model.prefill(p, {"tokens": toks},
                                           max_len=MAX_LEN)
            tok = int(_local(logits).argmax())
            for i in range(SHARD_STEPS):
                tok = tok if feed is None else feed[i]
                fed.append(tok)
                arr = torch.full((1, 1), tok, dtype=torch.int32,
                                 device="cuda")
                logits, caches = model.decode(p, caches, arr,
                                              SHARD_PROMPT + i,
                                              decode_impl="pallas")
                logits = _local(logits).float()
                out.append(logits)
                tok = int(logits.argmax())
        return out, fed

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_test_mesh((1, 1))
            policy = ShardingPolicy(mesh)
            sharded = device_put(params, param_shardings(params, policy))
            under = functools.partial(use_policy, policy)
            plain_logits, fed = walk(params, contextlib.nullcontext)
            seen = []

            def spy(*args):
                seen[:] = [a.clone() for a in args]    # the last call's
                return dops.decode_attention(*args)
            for fn in counters:
                fn.launches = 0
            L.decode_attention = spy
            try:
                shard_logits, _ = walk(sharded, under, feed=fed)
            finally:
                L.decode_attention = dops.decode_attention
            launches = {fn.__name__: fn.launches for fn in counters}
            k1 = launches["decode_attention"]
            n_attn = model.mixers.count("attn")
            want = n_attn * SHARD_STEPS
            check(launches == {"decode_attention": want,
                               "paged_attention": 0,
                               "flash_attention": n_attn, "ssd_step": 0},
                  f"phase 13: launches {launches} under the policy, "
                  f"expected {want} of K1, {n_attn} of K3 (the prompt "
                  f"pass) and no other kernel")
            check(all(type(a) is torch.Tensor for a in seen),
                  "phase 13: K1 took a DTensor")
            worst = ratio = 0.0
            for step, (a, b) in enumerate(zip(shard_logits, plain_logits)):
                check(bool(torch.isfinite(a).all()),
                      f"phase 13 step {step}: non-finite logits")
                spread = float(b.max() - b.min())
                diff = float((a - b).abs().max())
                check(diff <= WALK_BOUND * spread,
                      f"phase 13 step {step}: {diff:.4g} > {WALK_BOUND} x "
                      f"spread {spread:.4g}")
                worst, ratio = max(worst, diff), max(ratio, diff / spread)
            print(f"phase 13 walk {cfg.name}: {SHARD_STEPS} steps "
                  f"\"pallas\" from position {SHARD_PROMPT} under a "
                  f"{tuple(mesh.mesh.shape)} mesh policy against the plain "
                  f"params: max|dlogits| {worst:.4g} ({ratio:.4g} x spread; "
                  f"bound {WALK_BOUND}); {k1} K1 launches on local shards "
                  f"(= {n_attn} layers x {SHARD_STEPS}), {n_attn} of K3 "
                  f"(the prompt pass)")
            plain_ms = prompt_ms(params, contextlib.nullcontext)
            shard_ms = prompt_ms(sharded, under)
            print(f"phase 13 prompt pass {SHARD_PROMPT} tokens {cfg.name} "
                  f"(CUDA events, 3 each): plain "
                  f"{', '.join(f'{t:.2f}' for t in plain_ms)} ms, under the "
                  f"policy {', '.join(f'{t:.2f}' for t in shard_ms)} ms "
                  f"[{gpu}]")
            del sharded
            record = hold_local_k1(torch, F, seen, k1)
            # two layers' fp32 gradients of a short loss
            leaves = list(_leaves(params["layers"][:2]))
            for t in leaves:
                t.requires_grad_(True)
            try:
                loss = model.train_loss(
                    params, {"tokens": toks[:, :SHARD_GRAD_TOKENS]})
                grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
            finally:
                for t in leaves:
                    t.requires_grad_(False)
            err = init_error_feedback(grads)
            got, got_err = compressed_psum(grads, None, err)
            comp, comp_err = compress_grads(grads, err)
            same = all(torch.equal(a, b) for a, b in
                       zip(got + got_err, comp + comp_err))
            check(same, "phase 13: compressed_psum over the one-rank NCCL "
                  "group differs from compress_grads")
            print(f"phase 13 compressed_psum: {len(grads)} fp32 gradient "
                  f"leaves of 2 layers ({sum(g.numel() for g in grads)} "
                  f"values) over the NCCL group equal compress_grads bit "
                  f"for bit")
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "phase 13: process group left open")
    paper_topologies()
    return record


def hold_local_k1(torch, F, args, launches):
    """K1 against its plain version on the local shards of the policy
    walk's last call (``args``: q, k, v, lengths), then timed on 16 copies
    of them (together past the L2) beside its plain version and
    ``scaled_dot_product_attention``."""
    from repro_torch.kernels.decode_attention import ops as dops

    q, k, v, lengths = args
    err = max_err(torch, dops.decode_attention(q, k, v, lengths),
                  dops.decode_attention_plain(q, k, v, lengths), q.dtype)
    b, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    sets = [tuple(a.clone() for a in args) for _ in range(16)]
    mask = (torch.arange(t, device="cuda")[None, None, None, :]
            < lengths[:, None, None, None])
    lib_sets = [(sq[:, :, None], sk.transpose(1, 2), sv.transpose(1, 2), mask)
                for sq, sk, sv, _ in sets]
    sdpa = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=m, enable_gqa=True)
    valid = int(lengths.sum())
    item = q.element_size()
    bytes_ms = (valid * kh * hd * 2 * item + 2 * b * h * hd * item
                + 4 * b) / peaks().HBM_BW * 1e3
    ops_ms = 4 * h * hd * valid / peaks().FP32_FLOPS * 1e3
    rec = dict(name="decode_attention_sharded", route="cuda",
               source=SOURCES["decode_attention"],
               replaces=REPLACES["decode_attention"], launches=launches,
               max_abs_err=err,
               ms=time_ms(torch, dops.decode_attention, sets),
               plain_ms=time_ms(torch, dops.decode_attention_plain, sets),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=time_ms(torch, sdpa, lib_sets))
    print(f"{rec['name']}: kernel {rec['ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), plain "
          f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
          f"max err {err:.3g} ({q.dtype}, local shards B={b}, T={t}, H={h}, "
          f"K={kh}, hd={hd}, lengths {lengths.tolist()}), {launches} "
          f"launches")
    return rec


# the paper's tensor-parallel degrees for its own models, as spec tables
# over a stub mesh (one card cannot hold them)
PAPER_TP = {"llama-3.1-70b": 4, "nemotron-4-340b": 8}


class _StubMesh:
    """A mesh's axis names and shape: all a sharding policy reads."""
    def __init__(self, shape, names=("data", "model")):
        import numpy as np
        self.mesh = np.empty(shape, dtype=object)
        self.mesh_dim_names = names


def paper_topologies():
    """Bytes a device of each paper model's bf16 params (``init_abstract``
    on the meta device) under ``param_shardings`` at (1, TP)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.sharding import ShardingPolicy
    from repro_torch.sharding.specs import bytes_per_device, param_shardings

    for arch, tp in PAPER_TP.items():
        params = Model(get_config(arch)).init_abstract(torch.bfloat16)
        total = sum(t.numel() * t.element_size() for t in _leaves(params))
        per = bytes_per_device(params, param_shardings(
            params, ShardingPolicy(_StubMesh((1, tp)))))
        check(total / tp <= per < 1.01 * total / tp,
              f"{arch}: {per} bytes a device of {total} at TP = {tp}")
        print(f"phase 13 {arch} at (data, model) = (1, {tp}): {total} bytes "
              f"of bf16 params, {per} bytes a device "
              f"({per / 2**30:.3f} GiB; spec tables on meta tensors)")


# ------------------------------------------------------------ phase 15 ---

BENCH_SUFFIX = "_bench_fp32"             # bench_kernels.py's shapes


def phase_engine_bench(torch, model, params, cfg, gpu, counters):
    """Phase 15 (module docstring).  Returns the ``kernels`` records of
    K1-K3 at ``bench_torch_kernels``'s shapes, each with its launches in
    the engine rows (K3's in their prompt passes)."""
    import collections

    from benchmarks import bench_torch_engine_throughput as bench
    from benchmarks import bench_torch_kernels
    from repro_torch.kernels import flash_attention

    print(f"phase 15 on {gpu}")
    held = bench_torch_kernels.run()
    records = []
    for name in ("decode_attention", "paged_attention", "flash_attention"):
        r = held[name]
        check(r["agrees"] and r["max_abs_err"] <= TOL["float32"],
              f"{name} at {r['shape']}: max err {r['max_abs_err']:.3g} "
              f"past {TOL['float32']} of its plain version")
        records.append(dict(
            name=name + BENCH_SUFFIX, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        print(f"{name}{BENCH_SUFFIX}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"max err {r['max_abs_err']:.3g} (fp32, {r['shape']})")

    # the engine rows, with every decode pass the card ran counted by its
    # impl: each eager call (a capture's call runs nothing) and each replay
    from repro_torch.serving.engine import DecodeEngine
    passes = collections.Counter()
    inner = model.decode
    queue = DecodeEngine._queue

    def counted(*args, decode_impl="sdpa", **kw):
        if not torch.cuda.is_current_stream_capturing():
            passes[decode_impl] += 1
        return inner(*args, decode_impl=decode_impl, **kw)

    def replays(dec):
        before = dec.graph_replays
        out = queue(dec)
        passes[dec.decode_impl] += dec.graph_replays - before
        return out
    model.decode = counted
    DecodeEngine._queue = replays
    for fn in counters:
        fn.launches = 0
    flash_attention.launches_f32 = 0
    try:
        with prompt_passes(model) as seen:
            out = bench.rows(model, params, cfg, "cuda")
    finally:
        del model.decode
        DecodeEngine._queue = queue
    launches = {fn.__name__: fn.launches for fn in counters}
    f32_launches = flash_attention.launches_f32
    layers = cfg.num_layers
    for impl, kernel in (("pallas", "decode_attention"),
                         ("paged", "paged_attention")):
        check(passes[impl] > 0
              and launches[kernel] == layers * passes[impl],
              f"{impl}: {launches[kernel]} launches of {kernel} for "
              f"{passes[impl]} decode passes of {layers} layers")
        print(f"phase 15 {impl}: {launches[kernel]} {kernel} launches = "
              f"{layers} layers x {passes[impl]} decode passes")
    check_prompt_kernel("phase 15", model, launches, seen)
    print(f"phase 15: {launches['flash_attention']} flash_attention launches "
          f"= {layers} layers x {seen['passes']} prompt passes")

    pre, paged, occ = out["prefill"], out["paged"], out["occupancy"]
    check(paged["paged_admitted"] == PAGED_ADMITTED,
          f"the 24-page pool admitted {paged['paged_admitted']}, not "
          f"{PAGED_ADMITTED}")
    check(paged["capacity_ratio"] >= bench.MIN_PAGED_CAPACITY,
          f"paged capacity {paged['capacity_ratio']:.2f}x < "
          f"{bench.MIN_PAGED_CAPACITY}x")
    for label, point in (("short_d16", pre["gated"]),
                         ("parity_d8", pre["parity_scale"])):
        print(f"phase 15 prefill {label}: batched "
              f"{point['batched_tokens_per_s']:.1f} tokens/s, sequential "
              f"{point['sequential_tokens_per_s']:.1f}, speedup "
              f"{point['batched_speedup']:.3f}x"
              + (f" (gate >= {bench.MIN_PREFILL_SPEEDUP}x)"
                 if label == "short_d16" else " (not gated)")
              + f", {point['batches']} batches, {point['padded_tokens']} "
              f"padded tokens")
    print("phase 15 decode tokens/s at 4 slots: " + ", ".join(
        f"{impl} {r['tokens_per_s']:.1f}" for impl, r in out["decode"].items()))
    print(f"phase 15 paged rate at matched width: paged_sdpa/sdpa "
          f"{paged['rate_ratio']:.3f} (gate >= {bench.MIN_PAGED_RATE}), "
          f"paged/pallas {paged['kernel_rate_ratio']:.3f} (kernels, not "
          f"gated); tokens/s " + ", ".join(
              f"{k} {v:.1f}" for k, v in paged["decode_tokens_per_s"].items()))
    print(f"phase 15 paged capacity: {paged['paged_admitted']} requests in "
          f"{paged['pool_pages']} pages against {paged['dense_slots']} dense "
          f"slots = {paged['capacity_ratio']:.2f}x (gate >= "
          f"{bench.MIN_PAGED_CAPACITY}x); KV bytes a request "
          f"{paged['kv_hbm_bytes_per_active_request']:.0f} against "
          f"{paged['dense_kv_hbm_bytes_per_request']}; pool utilization at "
          f"capacity {paged['pool_utilization_at_capacity']:.3f}")
    flood = paged["flood"]
    print(f"phase 15 flood ({flood['requests']} requests, "
          f"{flood['pool_pages']} pages): utilization histogram "
          f"{flood['utilization_histogram']}, mean "
          f"{flood['mean_pool_utilization']:.3f}, peak "
          f"{flood['peak_pool_utilization']:.3f}")
    print(f"phase 15 occupancy ({occ['requests']} requests, 2 x 2 slots): "
          f"active-slot histogram {occ['histogram']} over {occ['ticks']} "
          f"ticks, mean busy fill {occ['mean_busy_fill']:.3f}, prefill "
          f"{occ['prefill_batches']} batches / "
          f"{occ['prefill_batched_requests']} batched requests, "
          f"{occ['wall_s']:.3f} s")
    records[0]["launches"] = launches["decode_attention"]
    records[1]["launches"] = launches["paged_attention"]
    records[2]["launches"] = f32_launches      # fp32 K3 in the engine rows
    return records


# ------------------------------------------------------------ phase 14 ---

# the dry run's cells: (arch, shape) on the fake 256-rank (16, 16) mesh
DRYRUN_CELLS = (("phi4-mini-3.8b", "decode_32k"),
                ("phi4-mini-3.8b", "prefill_32k"),
                ("llama-3.1-70b", "decode_32k"),
                ("nemotron-4-340b", "decode_32k"))
DRYRUN_TIMEOUT = 600
# what roofline.fmt_row reads of a record
FMT_ROW_KEYS = {"arch": (), "shape": (), "mesh": (), "useful_flops_ratio": (),
                "roofline": ("compute_s", "memory_s", "collective_s",
                             "bottleneck", "roofline_fraction"),
                "memory": ("argument_size_in_bytes", "temp_size_in_bytes")}
CELL_B, CELL_T = 8, 8192                 # the measured decode step
CELL_BYTES_TOL = 0.01


def phase_dryrun(gpu):
    """Phase 14 (a): the dry-run CLI on a fake 256-rank group, one
    process a cell, all started together; then the roofline report over
    their records.  Returns the records."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for arch, shape in DRYRUN_CELLS:
            out = Path(tmp) / f"{arch}_{shape}.jsonl"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--mesh", "single", "--arch", arch, "--shape", shape,
                   "--out", str(out)]
            procs.append((arch, shape, out, subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        try:
            logs = [(a, s, o, p.communicate(timeout=DRYRUN_TIMEOUT)[0],
                     p.returncode) for a, s, o, p in procs]
        finally:
            for *_, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        records = []
        for arch, shape, out, log, rc in logs:
            lines = [ln for ln in log.splitlines()
                     if "alltoall yet" not in ln]
            print("\n".join(f"  {ln}" for ln in lines[-6:]))
            check(rc == 0, f"phase 14: dry run of {arch} {shape} exited {rc}")
            rec, = [json.loads(ln) for ln in out.read_text().splitlines()
                    if ln.strip()]
            for key, sub in FMT_ROW_KEYS.items():
                check(key in rec and all(k in rec[key] for k in sub),
                      f"phase 14: {arch} {shape} record lacks {key} {sub}")
            coll = rec["collectives"]
            check(coll["counts"] == coll["comm_debug_counts"],
                  f"phase 14: {arch} {shape} collectives {coll['counts']} "
                  f"against CommDebugMode's {coll['comm_debug_counts']}")
            mem = rec["memory"]
            print(f"phase 14 dry run {arch} {shape} on {rec['mesh']} "
                  f"({rec['devices']} fake ranks, traced in "
                  f"{rec['trace_s']} s): {rec['cost']['flops']:.6g} FLOPs "
                  f"and {rec['cost']['bytes_accessed']:.6g} bytes a device, "
                  f"args {mem['argument_size_in_bytes']} bytes "
                  f"({mem['argument_size_in_bytes'] / 2**30:.3f} GiB) a "
                  f"device, eager-peak temps "
                  f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB, "
                  f"collectives {coll['counts']} "
                  f"({coll['total_bytes']:.6g} bytes), "
                  f"= CommDebugMode's")
            records.append(rec)
        report = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.roofline",
             *(str(o) for _, _, o, _, _ in logs)], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=120)
    check(report.returncode == 0,
          f"phase 14: roofline report failed: {report.stderr[-2000:]}")
    print(report.stdout.rstrip())
    print(f"phase 14 roofline constants are the H100 SXM's; card: [{gpu}]")
    return records


def phase_measured_cell(torch, gpu, counters):
    """Phase 14 (b): one decode step of full-width Phi-4-mini (bf16, B =
    CELL_B, a cache of CELL_T positions, ``"sdpa"``) on a one-rank NCCL
    (1, 1) mesh, as phase 13 starts it: the counter's FLOPs, bytes and
    roofline terms beside the step's CUDA-event time, the spec tables'
    bytes a device beside ``memory_allocated``, and the eager-peak
    estimate beside ``max_memory_allocated``."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import get_config
    from repro_torch.launch import hlo_analysis, jaxpr_cost
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import ShardingPolicy, use_policy
    from repro_torch.sharding.specs import (bytes_per_device,
                                            cache_shardings, device_put,
                                            param_shardings)

    cfg = get_config("phi4-mini-3.8b")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_test_mesh((1, 1))
            policy = ShardingPolicy(mesh)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            model, params = init_on_card(torch, cfg)
            p_sh = param_shardings(params, policy)
            sharded = device_put(params, p_sh)
            del params
            with use_policy(policy):
                caches = model.cache_init(CELL_B, CELL_T, "cuda")
            torch.cuda.synchronize()
            placed = torch.cuda.memory_allocated() - before
            c_sh = cache_shardings(caches, policy)
            predicted = (bytes_per_device(sharded, p_sh)
                         + bytes_per_device(caches, c_sh))
            gap = abs(placed - predicted) / predicted
            print(f"phase 14 cell {cfg.name} B={CELL_B} T={CELL_T}: "
                  f"bytes_per_device(params + caches) {predicted} "
                  f"({predicted / 2**30:.3f} GiB), memory_allocated after "
                  f"placing them {placed} ({placed / 2**30:.3f} GiB): "
                  f"{gap:.3%} apart (bound {CELL_BYTES_TOL:.0%})")
            check(gap <= CELL_BYTES_TOL,
                  f"phase 14: {placed} bytes placed against {predicted} "
                  f"predicted")
            tokens = torch.full((CELL_B, 1), 7, dtype=torch.int32,
                                device="cuda")
            cur = CELL_T - 1

            def step():
                logits, _ = model.decode(sharded, caches, tokens, cur,
                                         decode_impl="sdpa")
                return logits

            with torch.no_grad(), use_policy(policy):
                step()                                     # warm-up
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                for fn in counters:
                    fn.launches = 0
                logits = step()
                torch.cuda.synchronize()
                launches = {fn.__name__: fn.launches for fn in counters}
                peak = torch.cuda.max_memory_allocated() - base
                check(not any(launches.values()),
                      f"phase 14: the sdpa step launched kernels {launches}")
                check(bool(torch.isfinite(logits.full_tensor()).all()),
                      "phase 14: non-finite logits")
                times = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step()
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                with CommDebugMode() as comm, \
                        jaxpr_cost.counting() as counter:
                    step()
                torch.cuda.synchronize()
            coll = hlo_analysis.collective_bytes(counter.collectives, 1)
            comm_counts = hlo_analysis.comm_debug_counts(comm)
            check(dict(coll.counts) == comm_counts,
                  f"phase 14: collectives {dict(coll.counts)} against "
                  f"CommDebugMode's {comm_counts}")
            cost = counter.cost
            terms = hlo_analysis.roofline_terms(
                {"flops": cost.flops, "bytes accessed": cost.bytes}, coll)
            bound_ms = 1e3 * max(terms["compute_s"], terms["memory_s"],
                                 terms["collective_s"])
            print(f"phase 14 cell counter: {cost.flops:.6g} FLOPs "
                  f"({cost.contraction_flops():.6g} in contractions), "
                  f"{cost.bytes:.6g} bytes; roofline compute "
                  f"{terms['compute_s'] * 1e3:.4f} ms, memory "
                  f"{terms['memory_s'] * 1e3:.4f} ms, collective "
                  f"{terms['collective_s'] * 1e3:.4f} ms -> "
                  f"{terms['bottleneck']}, bound {bound_ms:.4f} ms; "
                  f"collectives {dict(coll.counts)} = CommDebugMode's")
            print(f"phase 14 cell step under the (1, 1) policy, CUDA events "
                  f"(3): {', '.join(f'{t:.2f}' for t in times)} ms "
                  f"[{gpu}]")
            plain_ms, busy_ms = time_plain_step(
                torch, model, sharded, caches, tokens, cur)
            print(f"phase 14 cell step on the same tensors without the "
                  f"policy, CUDA events (3): "
                  f"{', '.join(f'{t:.2f}' for t in plain_ms)} ms; device "
                  f"busy (profiler, sum of kernel times) {busy_ms:.4f} ms "
                  f"= {bound_ms / busy_ms:.3f} of it the roofline bound "
                  f"[{gpu}]")
            print(f"phase 14 cell temps: eager-peak estimate "
                  f"{counter.peak_bytes} bytes "
                  f"({counter.peak_bytes / 2**30:.4f} GiB), "
                  f"max_memory_allocated over the step {peak} bytes "
                  f"({peak / 2**30:.4f} GiB)")
            del sharded, caches, logits
        finally:
            dist.destroy_process_group()
    check(not dist.is_initialized(), "phase 14: process group left open")


def time_plain_step(torch, model, sharded, caches, tokens, cur):
    """The measured cell's step on the DTensors' local tensors with no
    policy: CUDA-event ms of 3 steps, and the device busy ms of one (the
    sum of its kernels' times, ``torch.profiler``)."""
    def local(tree):
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [local(v) for v in tree]
        return tree.to_local()

    params, cache = local(sharded), local(caches)
    times = []
    with torch.no_grad():
        model.decode(params, cache, tokens, cur)            # warm-up
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.decode(params, cache, tokens, cur)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model.decode(params, cache, tokens, cur)
            torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return times, busy_us / 1e3


def _local(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


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
                                     paged_attention, ssd_step)

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
    # K3's fp32 body and its merge at hd 32/64/96/128: none may spill
    f32 = spill_stores(paths["flash_attention"].with_suffix(".log")
                       .read_text(), "flash_f32_")
    check(len(f32) == 8 and not any(f32.values()),
          f"fp32 flash kernels: spill stores {f32}")
    print(f"  flash_attention fp32: {len(f32)} kernels, 0 bytes of spill "
          f"stores")
    # K4 at P 16-128, bf16 and fp32: its state lives in registers
    k4 = spill_stores(paths["ssd_step"].with_suffix(".log").read_text(),
                      "ssd_step_kernel")
    check(len(k4) == 8 and not any(k4.values()),
          f"ssd_step kernels: spill stores {k4}")
    print(f"  ssd_step: {len(k4)} kernels, 0 bytes of spill stores")

    t0 = time.perf_counter()
    records = phase_kernels(torch, F)
    print(f"phase 2: kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    cfg = get_config("phi4-mini-3.8b")
    model, params = init_on_card(torch, cfg)
    counters = (decode_attention, paged_attention, flash_attention, ssd_step)
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
    phase_lint()
    phase_q_chunk(torch, model, params, cfg, gpu)
    print(f"phase 12: lint pass and q-chunk flag "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    records.append(phase_sharded(torch, F, model, params, cfg, gpu,
                                 counters))
    print(f"phase 13: sharded walk and compressed all-reduce on a one-rank "
          f"mesh ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    records += phase_engine_bench(torch, model, params, cfg, gpu, counters)
    print(f"phase 15: kernel and engine fast-path benches "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    records += phase_flash(torch, F)
    print(f"phase 5: flash kernel agrees with its plain version "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    from repro_torch.training.data import DataConfig, make_batch
    batch = make_batch(DataConfig(cfg.vocab_size, LOSS_S, LOSS_B, seed=0), 0,
                       device="cuda")
    launches.update(phase_loss(torch, model, params, cfg, counters, batch))
    del batch
    print(f"phase 6: teacher-forced loss, flash and plain "
          f"({time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_train(torch, cfg, counters)
    print(f"phase 7: trainer steps ({time.perf_counter() - t0:.1f} s)")
    # phase 9 needs ~56 GiB of params: nothing of the earlier phases stays
    # (their clusters hold reference cycles)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"before phase 9: {held:.3f} GiB held")
    check(held < 4.0, f"{held:.2f} GiB still held before phase 9")
    t0 = time.perf_counter()
    records += phase_moe(torch, F, counters)
    print(f"phase 9: {MOE_ARCH} served and walked at full width "
          f"({time.perf_counter() - t0:.1f} s)")
    # phase 10 needs ~48 GiB of params: phase 9's are freed
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"before phase 10: {held:.3f} GiB held")
    check(held < 4.0, f"{held:.2f} GiB still held before phase 10")
    t0 = time.perf_counter()
    records += phase_recurrent(torch, F, counters)
    print(f"phase 10: {HYBRID_ARCH} ({HYBRID_LAYERS} layers) and {SSM_ARCH} "
          f"served and walked at full width ({time.perf_counter() - t0:.1f} "
          f"s)")

    # phase 11 needs ~7 GiB of params and ~6 GiB of KV: phase 10's are
    # freed
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"before phase 11: {held:.3f} GiB held")
    check(held < 4.0, f"{held:.2f} GiB still held before phase 11")
    t0 = time.perf_counter()
    records += phase_multimodal(torch, F, counters, gpu)
    print(f"phase 11: {VLM_ARCH} and {ENCDEC_ARCH} served and walked at full "
          f"size ({time.perf_counter() - t0:.1f} s)")

    # phase 14 places a fresh full-width Phi-4-mini and 8.6 GB of caches
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    print(f"before phase 14: {held:.3f} GiB held")
    check(held < 4.0, f"{held:.2f} GiB still held before phase 14")
    t0 = time.perf_counter()
    phase_dryrun(gpu)
    phase_measured_cell(torch, gpu, counters)
    print(f"phase 14: dry runs on a fake 256-rank group and the measured "
          f"decode cell ({time.perf_counter() - t0:.1f} s)")

    for r in records:
        if "launches" not in r:             # phases 9-11 counted their own
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
