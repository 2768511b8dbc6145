"""Logical-axis sharding policy with divisibility fallbacks: port of
``src/repro/sharding/policy.py`` onto ``torch.distributed``.

Tensors are annotated with *logical* axis names; a ``ShardingPolicy`` maps
them to the axes of a ``DeviceMesh``, dropping any assignment whose
dimension is not divisible by the mesh-axis product (the MaxText-style
fallback), so one set of annotations holds for every configuration.

A spec is a plain tuple with one entry per tensor dimension: ``None``, a
mesh axis name, or a tuple of names that shard that dimension together
(the reference's ``PartitionSpec`` entries).  :func:`placements` turns it
into DTensor placements, one per mesh dimension.

The policy is installed with :func:`use_policy` and consulted by the model
through :func:`shard`, the reference's ``with_sharding_constraint``: it
redistributes a ``DTensor`` to the spec's placements and returns anything
else as it is (with no policy the model runs on plain tensors).  The
policy reads only ``mesh.mesh_dim_names`` and ``mesh.mesh.shape``, so a
stub with those two attributes serves the spec tables.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

AxisAssign = Union[None, str, Tuple[str, ...]]

# Default logical -> mesh-axis rules (the reference's, policy.py:24-53).
# Order within a tuple matters only for readability; divisibility is checked
# against the product.
LOGICAL_RULES: Mapping[str, AxisAssign] = {
    # data-like axes
    "batch": ("pod", "data"),
    "decode_batch": ("pod", "data"),
    "seq": None,
    "long_seq": ("pod", "data"),     # long_500k: batch=1, shard KV sequence
    # activation feature axes
    "act_embed": None,               # d_model of activations — replicated
    "act_mlp": ("model",),           # TP'd FFN intermediate activations
    "heads": ("model",),
    "head_dim": None,
    # parameter axes
    "embed": ("data",),              # FSDP axis for the non-TP param dim
    "vocab": ("model",),
    "kv_heads": ("model",),
    "kv_head_dim": ("model",),       # fallback when kv_heads % model != 0
    "kv_feature": ("model",),        # fallback axis: flattened K*hd or hd
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": None,
    "ssm_inner": ("model",),
    "ssm_state": None,
    "stack": None,                   # scanned layer dim — never sharded
    "expert_batch": ("data",),       # capacity dim of the MoE dispatch buffer
}


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or a stub with the same two
    attributes)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where tensor dim d names that mesh axis,
    ``Replicate()`` elsewhere.  A tuple entry shards its dimension over its
    mesh axes in mesh order, as ``PartitionSpec`` does; another order has no
    placement form and raises."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec bound to its mesh: the port's ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


class ShardingPolicy:
    def __init__(self, mesh, rules: Optional[Mapping[str, AxisAssign]] = None):
        self.mesh = mesh
        self.rules = dict(LOGICAL_RULES)
        if rules:
            self.rules.update(rules)

    def spec(self, logical_axes: Sequence[Optional[str]],
             dim_sizes: Optional[Sequence[int]] = None) -> tuple:
        """Spec for the given logical axes, with divisibility fallback; each
        mesh axis is used at most once (policy.py:70-102)."""
        sizes = mesh_sizes(self.mesh)
        parts = []
        used: set = set()
        for i, name in enumerate(logical_axes):
            assign = self.rules.get(name) if name else None
            if assign is None:
                parts.append(None)
                continue
            if isinstance(assign, str):
                assign = (assign,)
            # only mesh axes that exist, are unused, and divide the dim
            assign = tuple(a for a in assign if a in sizes and a not in used)
            if not assign:
                parts.append(None)
                continue
            if dim_sizes is not None:
                size = dim_sizes[i]
                keep = []
                prod = 1
                for a in assign:
                    if size % (prod * sizes[a]) == 0:
                        keep.append(a)
                        prod *= sizes[a]
                assign = tuple(keep)
            if not assign:
                parts.append(None)
                continue
            used.update(assign)
            parts.append(assign if len(assign) > 1 else assign[0])
        return tuple(parts)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 dim_sizes: Optional[Sequence[int]] = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes, dim_sizes))


_POLICY: contextvars.ContextVar[Optional[ShardingPolicy]] = \
    contextvars.ContextVar("sharding_policy", default=None)


def current_policy() -> Optional[ShardingPolicy]:
    return _POLICY.get()


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    """Install ``policy`` for the block.  Over a ``DeviceMesh`` the params
    and caches are DTensors, while the inputs (tokens, positions) and what
    is built from them (RoPE tables, masks) are plain tensors with the same
    value on every rank: inside the block they enter DTensor ops as
    replicated, backward passes included."""
    token = _POLICY.set(policy)
    try:
        if policy is not None and isinstance(policy.mesh, DeviceMesh):
            with implicit_replication():
                yield policy
        else:
            yield policy
    finally:
        _POLICY.reset(token)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint (policy.py:124-134).  Returns
    ``x`` itself with no policy, when its rank does not match the axes, or
    when it is a plain tensor (a local value: a constraint never changes
    values); a ``DTensor`` is redistributed to the spec's placements."""
    policy = _POLICY.get()
    if policy is None or x.dim() != len(logical_axes) \
            or not isinstance(x, DTensor):
        return x
    spec = policy.spec(logical_axes, x.shape)
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))
