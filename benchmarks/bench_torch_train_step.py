"""Where a train step of the PyTorch port spends its time, on one GPU.

Builds the ``Trainer`` of ``chip_smoke.py`` phase 7: Phi-4-mini 3.8B at
full width and ``--layers`` of its 32 layers (fp32 params, grads and Adam
moments from seed 0), B=1, S=2048, remat on, the plain attention path.
After 2 warm-up steps it

* times 3 steps on the host clock (each ends in a device sync), and the two
  halves of a step apart: loss + backward, and the AdamW update;
* traces 2 steps with ``torch.profiler`` and prints the device-busy time
  per step (the sum of kernel times), the idle share, the kernel launches
  per step, the device time by kind of kernel, and the kernels that take
  the most device time.

    PYTHONPATH=src python benchmarks/bench_torch_train_step.py [--layers 16]

Needs a CUDA device; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

SEQ = 2048
KINDS = (("matmul", ("gemm", "cutlass", "sm90_", "nvjet", "cublas")),
         ("copy / cast", ("copy", "memcpy", "to_copy")),
         ("reduce", ("reduce", "norm", "softmax", "logsumexp")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_train_step: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.data import make_batch
    from repro_torch.training.train_loop import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"),
                              num_layers=args.layers)
    tr = Trainer(cfg, ShapeConfig("train", SEQ, 1, "train"),
                 TrainConfig(remat=True), seed=0, device="cuda")
    tr.run(2)

    def timed(fn, n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    step_ms = timed(lambda: tr.run(1))
    params, opt = tr.state["params"], tr.state["opt"]
    leaves = list(opt_lib.leaves(params))
    batch = make_batch(tr.data_cfg, 0, device="cuda")
    grads = []

    def loss_backward():
        loss = tr.model.train_loss(params, batch, remat=True)
        grads[:] = torch.autograd.grad(loss, leaves)

    back_ms = timed(loss_backward)
    update_ms = timed(lambda: opt_lib.update(tr.cfg.opt, params, grads, opt))
    del grads[:]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_steps = 2
    with torch.profiler.profile(activities=acts) as prof:
        tr.run(n_steps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_kind = {}, {}
    for e in kernels:
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + e.time_range.elapsed_us())
        k = kind_of(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(t for _, t in by_name.values()) / 1e3 / n_steps
    n_params = sum(t.numel() for t in leaves)
    print(f"{torch.cuda.get_device_name(0)}; {cfg.name} full width, "
          f"{cfg.num_layers} layers, {n_params / 1e9:.3f} B fp32 params, "
          f"B=1 S={SEQ}, remat")
    print(f"host step {step_ms:.2f} ms ({SEQ / step_ms * 1e3:.1f} tokens/s): "
          f"loss + backward {back_ms:.2f} ms, AdamW update {update_ms:.2f} ms")
    print(f"device busy {busy_ms:.2f} ms/step; idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}; "
          f"{len(kernels) / n_steps:.0f} kernel launches/step")
    for k, t in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {t / 1e3 / n_steps:9.2f} ms/step  {k}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]
    for name, (n, tot) in top:
        print(f"  {tot / 1e3 / n_steps:9.2f} ms/step  {n // n_steps:5d}"
              f" launches/step  {name[:90]}")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
