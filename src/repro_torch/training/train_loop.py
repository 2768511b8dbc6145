"""The train loop: port of ``src/repro/training/train_loop.py``, a train
step with gradient accumulation and checkpoint/restart on one device.

Params are fp32 (as the reference's ``Trainer``); the step updates them and
the optimizer state in place (see ``optimizer.update``).  The reference
jits the step; here it runs eagerly.  Attention runs the plain path: the
flash kernel has no gradient (``Model.use_flash`` makes a step raise).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.data import DataConfig, make_batch


@dataclass
class TrainConfig:
    opt: opt_lib.OptimizerConfig = field(default_factory=opt_lib.OptimizerConfig)
    grad_accum: int = 1
    remat: bool = True
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10


def make_train_step(model: Model, cfg: TrainConfig):
    """``train_step(state, batch) -> (state, stats)``; ``state`` is
    {"params", "opt"} and is updated in place.  With ``grad_accum`` > 1 the
    batch is split into that many microbatches along its first axis, and
    their fp32 losses and gradients are summed and divided."""
    def value_and_grad(params, batch):
        leaves = list(opt_lib.leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss = model.train_loss(params, batch, remat=cfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def train_step(state, batch):
        params = state["params"]
        n = max(cfg.grad_accum, 1)
        if n == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            per = batch["tokens"].shape[0] // n
            loss, grads = None, None
            for i in range(n):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                l, g = value_and_grad(params, mb)
                if grads is None:
                    loss, grads = l.float(), [x.float() for x in g]
                else:
                    loss = loss + l
                    for acc, x in zip(grads, g):
                        acc.add_(x)
            loss = loss / n
            for acc in grads:
                acc.div_(n)
        _, _, stats = opt_lib.update(cfg.opt, params, grads, state["opt"])
        return state, dict(stats, loss=loss)

    return train_step


class Trainer:
    """Trains ``model_cfg`` on the synthetic stream of ``shape`` from fp32
    params drawn from ``seed``, on ``device`` (``cuda`` unless the caller
    names another).  Restores the latest checkpoint of ``cfg.ckpt_dir`` on
    start and saves one every ``cfg.ckpt_every`` steps."""

    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 cfg: Optional[TrainConfig] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.shape = shape
        self.cfg = cfg or TrainConfig()
        self.model = Model(model_cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, torch.float32, device=self.device)
        self.state = {"params": params, "opt": opt_lib.init(params)}
        self.step_fn = make_train_step(self.model, self.cfg)
        self.step = 0
        self.history: list = []
        self.data_cfg = DataConfig(vocab_size=model_cfg.vocab_size,
                                   seq_len=shape.seq_len,
                                   global_batch=shape.global_batch, seed=seed)
        if self.cfg.ckpt_dir:
            with contextlib.suppress(FileNotFoundError):
                self.state, self.step = ckpt_lib.restore(
                    self.cfg.ckpt_dir, self.state)
                print(f"restored checkpoint at step {self.step}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int, log: Optional[Callable[[dict], None]] = None):
        """``num_steps`` steps; each appends {"loss", "grad_norm", "lr",
        "step", "step_time"} to ``history`` (step_time on the host clock,
        after a device sync)."""
        for _ in range(num_steps):
            batch = make_batch(self.data_cfg, self.step, device=self.device)
            self._sync()
            t0 = time.perf_counter()
            self.state, stats = self.step_fn(self.state, batch)
            stats = {k: float(v) for k, v in stats.items()}
            self._sync()
            stats.update(step=self.step, step_time=time.perf_counter() - t0)
            self.history.append(stats)
            if log and self.step % self.cfg.log_every == 0:
                log(stats)
            self.step += 1
            if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                ckpt_lib.save(self.cfg.ckpt_dir, self.step, self.state)
        return self.history
