"""Checkpointing: port of ``src/repro/training/checkpoint.py``, with the
same on-disk layout.

Layout:  <dir>/step_<n>/shard_<host>.npz  + manifest.json
Save is crash-safe (write to ``.tmp`` then ``os.replace``); ``restore``
returns the latest complete step; the three newest steps are kept.
``AsyncCheckpointer`` overlaps serialization with training (one background
thread, depth-1 queue).

Keys are the tree paths of the port's own trees of dicts and lists,
written as ``jax.tree_util.keystr`` writes them (``['params']['layers'][0]
['attn']['wq']``).  A bf16 tensor is stored as float32 (numpy has no
bfloat16; the round trip is exact) and restored in the dtype of ``like``.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import tree_map


def _paths(tree, prefix=""):
    """(keystr path, leaf) pairs, dict keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, node in enumerate(tree):
            yield from _paths(node, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view of a tensor that training goes
    on updating in place)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {path: _to_numpy(leaf) for path, leaf in _paths(tree)}


def save(ckpt_dir: str, step: int, tree: Any, host_id: int = 0,
         num_hosts: int = 1, keep: int = 3):
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"shard_{host_id}.npz.tmp"
    flat = _flatten(tree)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, d / f"shard_{host_id}.npz")
    if host_id == 0:
        manifest = {"step": step, "num_hosts": num_hosts,
                    "keys": sorted(flat.keys())}
        mtmp = d / "manifest.json.tmp"
        mtmp.write_text(json.dumps(manifest))
        os.replace(mtmp, d / "manifest.json")
        _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(pathlib.Path(ckpt_dir).glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    best = None
    for d in sorted(pathlib.Path(ckpt_dir).glob("step_*")):
        if (d / "manifest.json").exists():
            best = int(d.name.split("_")[1])
    return best


def _rebuild(like, data, prefix=""):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], data, f"{prefix}[{k!r}]") for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    return torch.from_numpy(np.asarray(data[prefix])).to(
        device=like.device, dtype=like.dtype)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            host_id: int = 0) -> Tuple[Any, int]:
    """Restore into the structure, dtypes and devices of ``like``; returns
    (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(d / f"shard_{host_id}.npz") as data:
        return _rebuild(like, data), step


class AsyncCheckpointer:
    """Depth-1 background saver: training never blocks on serialization
    (the previous save is awaited before a new one is queued)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self._error: Optional[BaseException] = None

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save(self.ckpt_dir, step, tree, keep=self.keep)
            except BaseException as e:  # surfaced on next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any):
        if self._error:
            raise self._error
        # snapshot to host memory before queueing: training goes on
        # updating the tensors in place
        host_tree = tree_map(_to_numpy, tree)
        self._q.join()
        self._q.put((step, host_tree))

    def wait(self):
        self._q.join()
        if self._error:
            raise self._error

    def close(self):
        self._q.join()
        self._q.put(None)
        self._worker.join()
