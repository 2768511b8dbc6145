"""Device-mesh construction: port of ``src/repro/launch/mesh.py`` over
``torch.distributed.device_mesh``.

Functions, not module-level constants, so importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the ranks of the default
process group, which the caller starts first
(``torch.distributed.init_process_group`` with its address, world size and
rank); every rank calls it.  The shapes and axis names are the reference's:
one pod as (data=16, model=16), two as (pod=2, data=16, model=16).  The
port is measured on one H100, where a mesh is (1, 1); the tests run
(2, 2) on four CPU processes.  ``device_type`` is ``"cuda"`` unless the
caller names another, and with no CUDA device the call raises.
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device_type).type, shape,
                            mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type="cuda"):
    """Small mesh for tests (needs a world of prod(shape) ranks)."""
    return init_device_mesh(resolve_device(device_type).type, tuple(shape),
                            mesh_dim_names=axes)
