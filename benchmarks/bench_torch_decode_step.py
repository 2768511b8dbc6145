"""Where a decode step of the PyTorch port spends its time, on one GPU.

Builds a full-width model (``--arch``, Phi-4-mini 3.8B by default; random
bf16 weights from a seed, drawn on the card), admits 4 requests into one
``DecodeEngine`` with 4 slots (prompts of 577-1041 tokens, prefilled by the
port's ``PrefillEngine``; the slice's decoder shape in ``chip_smoke.py``),
and then:

* times 8 decode ticks on the host clock (each tick ends in the argmax's
  copy to the host, so the device has finished);
* traces the same number of ticks with ``torch.profiler`` and prints the
  device-busy time per tick (the sum of kernel times), the idle share, the
  kernel launches per tick, the device time of each layer kind (attention,
  MLP, MoE, the Mamba, mLSTM and sLSTM blocks; summed over the
  profiler's ``record_function`` range around each) and the kernels that
  take the most device time;
* times one warm prompt pass of the longest prompt on the host clock and
  traces it the same way.

    PYTHONPATH=src python benchmarks/bench_torch_decode_step.py \
        [--impl pallas|sdpa|paged|paged_sdpa] [--arch qwen3-moe-30b-a3b] \
        [--layers N]

Any architecture of the port's registry that fits one card serves here
(``qwen3-moe-30b-a3b`` holds ~56 GiB of bf16 params); ``--layers`` cuts
the depth to N layers at full width, a multiple of the layer period
(``--arch jamba-v0.1-52b --layers 16``: ~48 GiB; ``--arch xlstm-125m``
runs whole).  Models with recurrent mixers take ``pallas`` or ``sdpa``.

Needs a CUDA device; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

STEPS = 8
LENGTHS = (1041, 913, 760, 577)    # one prompt per slot


KINDS = ("attn", "mlp", "moe", "mamba", "mlstm", "slstm")


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
    max_len = 1088
    pre = PrefillEngine(model, params, max_len, cache_entries=0,
                        device="cuda")
    dec = DecodeEngine(model, params, num_slots=len(LENGTHS),
                       max_len=max_len, decode_impl=args.impl, device="cuda")
    for slot, n in enumerate(LENGTHS):
        toks = [(slot * 1_000_003 + 7 * i) % cfg.vocab_size for i in range(n)]
        logits, caches = pre.prefill(toks)
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
          f"decode_impl={args.impl}, {len(LENGTHS)} slots, {STEPS} ticks")
    _summarise(torch, "decode tick", STEPS, step_ms,
               _profiled(torch, lambda: [dec.step() for _ in range(STEPS)]))

    # one prompt pass of the longest prompt, warm, on the host clock (its
    # logits' copy to the host ends it) and then traced the same way
    toks = [(7 * i) % cfg.vocab_size for i in range(LENGTHS[0])]
    pre.prefill(toks)
    t0 = time.perf_counter()
    pre.prefill(toks)
    pass_ms = (time.perf_counter() - t0) * 1e3
    _summarise(torch, f"prompt pass of {LENGTHS[0]} tokens", 1, pass_ms,
               _profiled(torch, lambda: pre.prefill(toks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
