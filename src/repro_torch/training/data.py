"""Deterministic synthetic data pipeline: port of ``src/repro/training/
data.py``.

Token streams are drawn per (seed, step, host-shard) with numpy's
counter-mode generator exactly as the reference draws them, so a batch is
bit-identical to the reference's; only the last step differs, which puts
the tokens on a torch device (``cuda`` unless the caller names another).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structured synthetic text: Zipf unigrams + short-range copy structure so
    # the LM loss has signal to descend (pure-uniform tokens are unlearnable)
    zipf_a: float = 1.2
    copy_period: int = 7


def _host_slice(global_batch: int, host_id: int, num_hosts: int):
    per = global_batch // num_hosts
    return host_id * per, per


def make_batch(cfg: DataConfig, step: int, host_id: int = 0,
               num_hosts: int = 1, device=None) -> dict:
    """{"tokens": (per-host batch, seq_len) int32} on ``device``."""
    start, per = _host_slice(cfg.global_batch, host_id, num_hosts)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, start]))
    ranks = rng.zipf(cfg.zipf_a, size=(per, cfg.seq_len)).astype(np.int64)
    tokens = (ranks % (cfg.vocab_size - 1)) + 1
    # inject copy structure: token[t] = token[t - period] for a random subset
    mask = rng.random((per, cfg.seq_len)) < 0.5
    mask[:, :cfg.copy_period] = False
    shifted = np.roll(tokens, cfg.copy_period, axis=1)
    tokens = np.where(mask, shifted, tokens).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens).to(resolve_device(device))}


def batch_iterator(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
                   num_hosts: int = 1, device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield make_batch(cfg, step, host_id, num_hosts, device=device)
        step += 1


def to_bf16(draw: np.ndarray) -> torch.Tensor:
    """A float64 array as a bf16 tensor on the CPU, rounded as
    ``jnp.asarray(draw, jnp.bfloat16)`` rounds it: to float32 first, then
    to bf16, each to nearest even.  A value just above a bf16 halfway point
    that float32 rounds onto it then rounds to even, as it does there."""
    return torch.from_numpy(np.asarray(draw, np.float32)).to(torch.bfloat16)


def batch_for_model(model_cfg: ModelConfig, shape: ShapeConfig, step: int,
                    seed: int = 0, device=None) -> dict:
    """The full model-input batch of a train step, frontend stubs included
    (data.py:61-78 there): a VLM's ``patches`` (B, num_patches,
    frontend_dim) take ``num_patches`` of the sequence from the tokens; an
    encoder-decoder's ``frames`` are (B, seq_len, frontend_dim).  Both are
    standard normal draws of ``SeedSequence([seed, step, 777])`` in bf16,
    bit-equal to the reference's (:func:`to_bf16`)."""
    seq_len = shape.seq_len
    if model_cfg.family == "vlm":
        seq_len -= model_cfg.num_patches
    dc = DataConfig(vocab_size=model_cfg.vocab_size, seq_len=seq_len,
                    global_batch=shape.global_batch, seed=seed)
    batch = make_batch(dc, step, device=device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 777]))
    stub = {"vlm": ("patches", model_cfg.num_patches),
            "encdec": ("frames", shape.seq_len)}.get(model_cfg.family)
    if stub is not None:
        name, n = stub
        draw = rng.normal(size=(shape.global_batch, n, model_cfg.frontend_dim))
        batch[name] = to_bf16(draw).to(batch["tokens"].device)
    return batch
