"""Concrete sharding specs for params, step inputs and KV caches: port of
``src/repro/sharding/specs.py``.

Baseline policy (the reference's):

* **Parameters / optimizer state** — fully sharded (FSDP+TP): for every
  >= 2-D leaf, the largest non-stack dim over ``model`` and the next largest
  over ``data`` (each subject to divisibility); attention projections on
  their heads dim.
* **Step inputs** — batch over ``(pod, data)``.
* **KV caches** — batch over ``(pod, data)``; KV heads over ``model`` when
  divisible, else head_dim over ``model``; with ``long_context`` (batch 1)
  the cache sequence dim takes the batch axes instead.

The reference's rules read a leaf's ``jax.tree_util.keystr`` path and its
stacked shape.  The port's params hold a flat ``layers`` list with no
period axis, and its caches stack each leaf over the layers of its kind
(``repro_torch.models.model``), so :func:`param_shardings` and
:func:`cache_shardings` give each leaf the reference's path and a leading
stack dim, and drop that dim's ``None`` from the spec: every port leaf gets
the reference's spec for its stacked counterpart.  Kept as the reference has
it: the embedding branch of :func:`param_spec` tests ``path.endswith
("embed")``, which a keystr path (``"['embed']"``) never does, so embedding
tables take the generic largest-dim branch.

:func:`device_put` distributes a tree of tensors by a tree of shardings (the
port's ``jax.device_put``); :func:`bytes_per_device` counts what one device
holds under them.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.sharding.policy import (NamedSharding, ShardingPolicy,
                                         mesh_sizes)


def _mesh_size(policy: ShardingPolicy, axis: str) -> int:
    return mesh_sizes(policy.mesh).get(axis, 1)


def _data_axes(policy: ShardingPolicy):
    return tuple(a for a in ("pod", "data") if a in policy.mesh.mesh_dim_names)


def _fits(policy, size, axes):
    prod = 1
    for a in axes:
        prod *= _mesh_size(policy, a)
    return size % prod == 0 and prod > 1


def param_spec(path: str, shape, policy: ShardingPolicy) -> tuple:
    """Heuristic FSDP+TP spec for a parameter leaf at keystr ``path``
    (specs.py:39-99).

    Rule knob ``_no_fsdp`` (truthy) switches to TP-only parameter sharding
    (no data-axis shard -> no per-step parameter all-gathers).
    """
    ndim = len(shape)
    parts: list = [None] * ndim
    if ndim <= 1:
        return tuple(parts)  # scalars / vectors (norm scales, biases): replicated
    no_fsdp = bool(policy.rules.get("_no_fsdp"))
    is_stacked = ("stack" in path)
    start = 1 if (is_stacked and ndim >= 2) else 0
    da = _data_axes(policy)
    dspec = da if len(da) > 1 else (da[0] if da else None)

    # Megatron-style attention TP: Q/K/V projections on the heads dim, the
    # output projection on its contracting heads dim; K/V fall back to
    # head_dim when kv_heads don't divide, matching the KV-cache layout.
    if ndim - start == 3 and any(t in path for t in
                                 ("'wq'", "'wk'", "'wv'", "'wo'")):
        if "'wo'" in path:
            h_dim, hd_dim, d_dim = start, start + 1, start + 2
        else:
            d_dim, h_dim, hd_dim = start, start + 1, start + 2
        if _fits(policy, shape[h_dim], ("model",)):
            parts[h_dim] = "model"
        elif _fits(policy, shape[hd_dim], ("model",)):
            parts[hd_dim] = "model"
        if not no_fsdp and _fits(policy, shape[d_dim], da):
            parts[d_dim] = dspec
        return tuple(parts)
    if path.endswith("embed") and ndim == 2:
        # (vocab, d) or (d, vocab); never reached by a keystr path (module
        # docstring)
        v_dim = 0 if shape[0] > shape[1] else 1
        d_dim = 1 - v_dim
        if _fits(policy, shape[v_dim], ("model",)):
            parts[v_dim] = "model"
        da = _data_axes(policy)
        if not no_fsdp and _fits(policy, shape[d_dim], da):
            parts[d_dim] = da if len(da) > 1 else da[0]
        return tuple(parts)
    dims = sorted(range(start, ndim), key=lambda i: -shape[i])
    used = []
    for i in dims:
        if _fits(policy, shape[i], ("model",)) and "model" not in used:
            parts[i] = "model"
            used.append("model")
            break
    if not no_fsdp:
        da = _data_axes(policy)
        for i in dims:
            if parts[i] is None and _fits(policy, shape[i], da):
                parts[i] = da if len(da) > 1 else da[0]
                break
    return tuple(parts)


def _keys(keys):
    return "".join(f"[{k!r}]" for k in keys)


def _map(fn, node, keys=()):
    """``fn(keys, leaf)`` over a tree of dicts and lists, keeping its
    structure; ``keys`` is the leaf's path of dict keys and list indices."""
    if isinstance(node, dict):
        return {k: _map(fn, v, keys + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v, keys + (i,)) for i, v in enumerate(node)]
    return fn(keys, node)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _stacked_spec(path, shape, policy):
    """The spec of a per-layer leaf: the reference's for the leaf stacked
    over periods, with the stack dim's ``None`` dropped."""
    return param_spec(path, (1, *shape), policy)[1:]


def param_shardings(params, policy: ShardingPolicy):
    """A ``NamedSharding`` per leaf of the port's params.  Each of
    ``layers`` takes the reference's path under ``['stack']['p0']`` and
    each of ``enc_layers`` under ``['enc_stack']['p0']``: the rules read
    only the leaf's own keys and the stack mark, never the period
    position."""
    def leaf(keys, x):
        if keys[0] in ("layers", "enc_layers"):
            stack = "stack" if keys[0] == "layers" else "enc_stack"
            path = _keys((stack, "p0") + keys[2:])
            spec = _stacked_spec(path, tuple(x.shape), policy)
        else:
            spec = param_spec(_keys(keys), tuple(x.shape), policy)
        return NamedSharding(policy.mesh, spec)

    return _map(leaf, params)


def input_shardings(specs, policy: ShardingPolicy, *, long_context=False):
    """Batch-shard every array input; scalars replicated (specs.py:
    108-122)."""
    da = _data_axes(policy)
    dspec = da if len(da) > 1 else (da[0] if da else None)

    def leaf(_, x):
        if x.dim() == 0:
            return NamedSharding(policy.mesh, ())
        parts = [None] * x.dim()
        if _fits(policy, x.shape[0], da):
            parts[0] = dspec
        return NamedSharding(policy.mesh, tuple(parts))

    return _map(leaf, specs)


# The port's cache leaves as the reference's rule reads them: K/V leaves by
# their own names, every recurrent state under ``['state']``.
_KV_LEAVES = ("k", "v", "xk", "xv")


def cache_spec(name: str, shape, policy: ShardingPolicy, *,
               long_context=False) -> tuple:
    """The spec of the port's cache leaf ``name`` of shape ``shape`` (P, B,
    ...), stacked over the layers of its kind: the reference's rule for a
    leaf stacked over periods (specs.py:125-168); dim 0 is never sharded."""
    da = _data_axes(policy)
    dspec = da if len(da) > 1 else (da[0] if da else None)
    ndim = len(shape)
    parts: list = [None] * ndim
    if ndim == 0:
        return ()
    if name in _KV_LEAVES and ndim == 5:
        # (periods, B, T, K, hd)
        if long_context and _fits(policy, shape[2], da):
            parts[2] = dspec            # sequence-sharded KV
        elif _fits(policy, shape[1], da):
            parts[1] = dspec
        if policy.rules.get("_kv_seq_model") and \
                _fits(policy, shape[2], ("model",)):
            # flash-decoding layout: KV sequence over the model axis
            parts[2] = "model" if parts[2] is None else parts[2]
        elif _fits(policy, shape[3], ("model",)):
            parts[3] = "model"
        elif _fits(policy, shape[4], ("model",)):
            parts[4] = "model"
        return tuple(parts)
    # generic state: (periods, B, ...) — batch over data, largest feature
    # dim over model
    if ndim >= 2 and _fits(policy, shape[1], da):
        parts[1] = dspec
    feat = sorted(range(2, ndim), key=lambda i: -shape[i])
    for i in feat:
        if _fits(policy, shape[i], ("model",)):
            parts[i] = "model"
            break
    return tuple(parts)


def cache_shardings(cache, policy: ShardingPolicy, *, long_context=False):
    """A ``NamedSharding`` per leaf of the port's cache dict (dense caches
    and paged pools alike: a pool's page dim stands where the batch is)."""
    return {name: NamedSharding(policy.mesh, cache_spec(
                name, tuple(x.shape), policy, long_context=long_context))
            for name, x in cache.items()}


def device_put(tree, shardings):
    """Each leaf of ``tree`` distributed by its ``NamedSharding`` in
    ``shardings`` (a tree of the same structure): the port's
    ``jax.device_put``.  A plain tensor must hold the same full value on
    every rank; a ``DTensor`` is gathered on its own mesh first (a
    collective over that mesh).  Every rank of the world calls it; ranks
    outside a sharding's mesh get an empty local shard."""
    shard_leaves = iter(list(_leaves(shardings)))

    def leaf(_, x):
        sh = next(shard_leaves)
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(x, sh.mesh, sh.placements)

    return _map(leaf, tree)


def bytes_per_device(tree, shardings) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta tensors included)
    under ``shardings``: each leaf's dims divided by the mesh axes of its
    spec entry."""
    total = 0
    for x, sh in zip(_leaves(tree), _leaves(shardings)):
        sizes = mesh_sizes(sh.mesh)
        n = 1
        for dim, entry in zip(x.shape, sh.spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * x.element_size()
    return total
