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
  kernel launches per tick, and the kernels that take the most device
  time.

    PYTHONPATH=src python benchmarks/bench_torch_decode_step.py \
        [--impl pallas|sdpa|paged|paged_sdpa] [--arch qwen3-moe-30b-a3b]

Any architecture of the port's registry that fits one card serves here
(``qwen3-moe-30b-a3b`` holds ~56 GiB of bf16 params).

Needs a CUDA device; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import sys
import time

STEPS = 8
LENGTHS = (1041, 913, 760, 577)    # one prompt per slot


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", default="pallas",
                    choices=["pallas", "sdpa", "paged", "paged_sdpa"])
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    help="a config name of repro_torch.configs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_decode_step: needs a CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine

    cfg = get_config(args.arch)
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

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            dec.step()
        torch.cuda.synchronize()
    # device-side events (kernels, copies, sets): their time range is on
    # the device's clock
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + e.time_range.elapsed_us())
    busy_ms = sum(t for _, t in by_name.values()) / 1e3 / STEPS
    gpu = torch.cuda.get_device_name(0)
    print(f"{gpu}; {cfg.name} full width, decode_impl={args.impl}, "
          f"{len(LENGTHS)} slots, {STEPS} ticks")
    print(f"host step {step_ms:.2f} ms; device busy {busy_ms:.2f} ms/step; "
          f"idle share {max(0.0, 1 - busy_ms / step_ms):.3f}; "
          f"{len(kernels) / STEPS:.0f} kernel launches/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, tot) in top:
        print(f"  {tot / 1e3 / STEPS:8.3f} ms/step  {n // STEPS:5d}"
              f" launches/step  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
