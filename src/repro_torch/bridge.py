"""Carry the JAX package's weights into the port.

The reference ``Model.init`` returns a pytree whose per-layer leaves are
stacked per period (``stack/p0/attn/wq`` has a leading ``n_periods`` axis).
A caller turns it to float32 numpy first, e.g.
``jax.tree.map(lambda a: np.asarray(a, np.float32), params)``, so this
module needs neither ``jax`` nor ``ml_dtypes``.  bf16 -> fp32 -> bf16 is
exact, so bridged bf16 weights are bit-identical to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a, dtype, device):
    # a copy: the port updates params in place, and a numpy view of a JAX
    # array shares the reference's buffer
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                         dtype=dtype)


def tree_from_numpy(node, *, dtype, device, index=None):
    """A nested dict of float32 numpy leaves as the same dict of tensors on
    ``device`` in ``dtype``; with ``index``, each leaf's entry ``index``
    along its first axis."""
    if isinstance(node, dict):
        return {k: tree_from_numpy(v, dtype=dtype, device=device, index=index)
                for k, v in node.items()}
    return _tensor(node if index is None else node[index], dtype, device)


def params_from_numpy(tree, cfg: ModelConfig, *, dtype, device):
    """The reference params ``tree`` (float32 numpy leaves) as the port's
    params on ``device`` in ``dtype``: the stacked periods are split into
    the port's flat list of layers, in layer order, and an encoder's
    ``enc_stack`` (period 1, stacked over the encoder layers) into the
    list ``enc_layers``; ``frontend_proj`` and ``enc_final_norm`` carry
    over as they are."""
    def conv(node, index=None):
        return tree_from_numpy(node, dtype=dtype, device=device, index=index)

    stack = tree["stack"]
    period = len(stack)
    n_periods = cfg.num_layers // period
    layers = [conv(stack[f"p{j}"], i)
              for i in range(n_periods) for j in range(period)]
    params = {"embed": conv(tree["embed"]), "unembed": conv(tree["unembed"]),
              "final_norm": conv(tree["final_norm"]), "layers": layers}
    for name in ("frontend_proj", "enc_final_norm"):
        if name in tree:
            params[name] = conv(tree[name])
    if "enc_stack" in tree:
        params["enc_layers"] = [conv(tree["enc_stack"]["p0"], i)
                                for i in range(cfg.num_encoder_layers)]
    return params


def opt_state_from_numpy(tree, cfg: ModelConfig, *, device):
    """The reference optimizer state ``tree`` ({"m", "v": params-shaped
    float32 numpy trees, "step": int}) as the port's: fp32 moments in the
    port's layout and an int32 0-d step on ``device``."""
    return {"m": params_from_numpy(tree["m"], cfg, dtype=torch.float32,
                                   device=device),
            "v": params_from_numpy(tree["v"], cfg, dtype=torch.float32,
                                   device=device),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=device)}
