"""End-to-end training with the PyTorch port: train a ~100M-parameter
dense LM for a few hundred steps on synthetic data with checkpointing (the
port's counterpart of examples/train_100m.py).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 200]

Runs on ``cuda`` unless ``--device cpu`` is given; checkpoints go to
``build/torch_train_100m`` under the repository unless ``--ckpt`` names
another directory.
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainConfig, Trainer

CKPT = Path(__file__).resolve().parents[1] / "build" / "torch_train_100m"


def model_100m() -> ModelConfig:
    """~100M params: a scaled-down member of the stablelm family."""
    base = get_config("stablelm-3b")
    return dataclasses.replace(
        base, name="stablelm-100m", num_layers=8, d_model=640, num_heads=10,
        num_kv_heads=10, head_dim=64, d_ff=1_664, vocab_size=32_000)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    cfg = model_100m()
    n = cfg.param_count() / 1e6
    print(f"model: {cfg.name} ≈ {n:.0f}M params")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    trainer = Trainer(cfg, shape, TrainConfig(
        opt=OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        remat=True, ckpt_dir=args.ckpt, ckpt_every=50, log_every=10),
        device=args.device)
    hist = trainer.run(args.steps, log=lambda s: print(
        f"step {s['step']:4d} loss={s['loss']:.4f} "
        f"gnorm={s['grad_norm']:.3f} lr={s['lr']:.2e} "
        f"({s['step_time']*1000:.0f} ms)"))
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    print(f"\nloss: {first:.3f} → {last:.3f} over {args.steps} steps "
          f"on {trainer.device}")


if __name__ == "__main__":
    main()
