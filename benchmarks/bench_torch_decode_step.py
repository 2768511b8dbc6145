"""Where a decode step of the PyTorch port spends its time, on one GPU.

Builds a full-width model (``--arch``, Phi-4-mini 3.8B by default; random
bf16 weights from a seed, drawn on the card), admits 4 requests into one
``DecodeEngine`` with 4 slots (prompts of 577-1041 tokens, prefilled by the
port's ``PrefillEngine``; the slice's decoder shape in ``chip_smoke.py``;
a VLM's requests each carry 576 x 1024 patches, an encoder-decoder's are
decoder prompts of 16-64 tokens with 1,024-2,048 x 160 frames, drawn from
numpy seeds), and then:

* times 8 decode ticks on the host clock (each tick ends in the argmax's
  copy to the host, so the device has finished);
* traces the same number of ticks with ``torch.profiler`` and prints the
  device-busy time per tick (the sum of kernel times), the idle share, the
  kernel launches per tick, the device time of each layer kind (attention,
  MLP, MoE, the Mamba, mLSTM and sLSTM blocks, the cached cross attention
  ``xattn`` and the whole ``encoder``, whose range holds its own attention
  and MLP ranges; summed over the profiler's ``record_function`` range
  around each) and the kernels that take the most device time;
* times one warm prompt pass of the longest prompt (with its frontend
  inputs) on the host clock and traces it the same way.

An engine that replays its step as a CUDA graph (``serving.engine.
graphs_decode``: attention and Mamba stacks without MoE) records it in the
first tick, before the ranges are added, so its traced ticks hold the
kernels but no layer-kind ranges; models decoded eagerly hold both.

    PYTHONPATH=src python benchmarks/bench_torch_decode_step.py \
        [--impl pallas|sdpa|paged|paged_sdpa] [--arch qwen3-moe-30b-a3b] \
        [--layers N]

Any architecture of the port's registry that fits one card serves here
(``qwen3-moe-30b-a3b`` holds ~56 GiB of bf16 params); ``--layers`` cuts
the depth to N layers at full width, a multiple of the layer period
(``--arch jamba-v0.1-52b --layers 16``: ~48 GiB; ``--arch xlstm-125m``,
``--arch phi-3-vision-4.2b`` and ``--arch seamless-m4t-medium`` run
whole).  Models with recurrent mixers, encoders or frontends take
``pallas`` or ``sdpa``.

Needs a CUDA device; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

STEPS = 8
LENGTHS = (1041, 913, 760, 577)    # one prompt per slot
ENCDEC_LENGTHS = (64, 48, 32, 16)  # decoder prompts (DEC_PREFIX is 64)
ENCDEC_FRAMES = (2048, 1792, 1536, 1024)


KINDS = ("attn", "mlp", "moe", "mamba", "mlstm", "slstm", "xattn", "encoder")


def requests(cfg):
    """(prompt lengths, each request's frontend inputs or None, max_len)
    of ``cfg``'s model: a VLM's patches, an encoder-decoder's frames."""
    import numpy as np

    def draw(slot, n):
        return np.random.default_rng([18, slot]).standard_normal(
            (n, cfg.frontend_dim), dtype=np.float32)
    if cfg.family == "encdec":
        return (ENCDEC_LENGTHS, [{"frames": draw(i, n)} for i, n in
                                 enumerate(ENCDEC_FRAMES)], 128)
    if cfg.family == "vlm":
        # 576 patches + 1041 tokens + 33, in 128-key splits
        return (LENGTHS, [{"patches": draw(i, cfg.num_patches)}
                          for i in range(len(LENGTHS))], 1664)
    return LENGTHS, [None] * len(LENGTHS), 1088


def _range_layer_kinds(torch):
    """Wrap each layer kind's function of the port in a profiler range of
    its name, so the trace sums device time by kind."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_lib

    def ranged(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    for kind, mixer in M.RECURRENT.items():
        M.RECURRENT[kind] = mixer._replace(block=ranged(kind, mixer.block))
    moe_lib.moe = ranged("moe", moe_lib.moe)
    L.attention = ranged("attn", L.attention)
    L.mlp = ranged("mlp", L.mlp)
    M.Model._cross_cached = ranged("xattn", M.Model._cross_cached)
    M.Model._run_encoder = ranged("encoder", M.Model._run_encoder)


def _profiled(torch, fn):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _summarise(torch, label, calls, host_ms, prof):
    """Print a traced run's device busy time, idle share and launches per
    call, the device time of each layer kind, and the top kernels."""
    # device-side events (kernels, copies, sets): their time range is on
    # the device's clock; the ranges' own device-side spans are left out
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in KINDS]
    by_name = {}
    for e in kernels:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + e.time_range.elapsed_us())
    busy_ms = sum(t for _, t in by_name.values()) / 1e3 / calls
    print(f"{label}: host {host_ms:.2f} ms; device busy {busy_ms:.2f} ms; "
          f"idle share {max(0.0, 1 - busy_ms / host_ms):.3f}; "
          f"{len(kernels) / calls:.0f} kernel launches")
    # the host-side ranges: their device time is their kernels' (the
    # device-side span of each range, idle gaps included, is left out)
    for e in prof.key_averages():
        if e.key in KINDS and e.device_type == torch.autograd.DeviceType.CPU:
            ms = e.device_time_total / 1e3 / calls
            print(f"  {e.key:6s} {ms:8.3f} ms device ({ms / busy_ms:.3f} of "
                  f"busy), {e.count // calls} calls")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, tot) in top:
        print(f"  {tot / 1e3 / calls:8.3f} ms  {n // calls:6d} launches  "
              f"{name[:90]}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", default="pallas",
                    choices=["pallas", "sdpa", "paged", "paged_sdpa"])
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    help="a config name of repro_torch.configs")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers (full width)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_decode_step: needs a CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16, device="cuda")
    lengths, extras, max_len = requests(cfg)
    pre = PrefillEngine(model, params, max_len, cache_entries=0,
                        device="cuda")
    dec = DecodeEngine(model, params, num_slots=len(lengths),
                       max_len=max_len, decode_impl=args.impl, device="cuda")
    for slot, n in enumerate(lengths):
        toks = [(slot * 1_000_003 + 7 * i) % cfg.vocab_size for i in range(n)]
        logits, caches = pre.prefill(toks, extras[slot])
        dec.admit(slot, f"r{slot}", caches, int(logits.argmax()),
                  prompt_len=n, max_new=10 * STEPS)
    for _ in range(3):                       # warm the allocator and handles
        dec.step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(STEPS):
        dec.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    _range_layer_kinds(torch)
    gpu = torch.cuda.get_device_name(0)
    print(f"{gpu}; {cfg.name} full width, {cfg.num_layers} layers, "
          f"decode_impl={args.impl}, {len(lengths)} slots, {STEPS} ticks")
    _summarise(torch, "decode tick", STEPS, step_ms,
               _profiled(torch, lambda: [dec.step() for _ in range(STEPS)]))

    # one prompt pass of the longest prompt, warm, on the host clock (its
    # logits' copy to the host ends it) and then traced the same way
    toks = [(7 * i) % cfg.vocab_size for i in range(lengths[0])]
    pre.prefill(toks, extras[0])
    t0 = time.perf_counter()
    pre.prefill(toks, extras[0])
    pass_ms = (time.perf_counter() - t0) * 1e3
    inputs = ", ".join(f"{k} {v.shape}" for k, v in (extras[0] or {}).items())
    _summarise(torch, f"prompt pass of {lengths[0]} tokens"
               + (f" with {inputs}" if inputs else ""), 1, pass_ms,
               _profiled(torch, lambda: pre.prefill(toks, extras[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
