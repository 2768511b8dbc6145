"""Elastic scaling, fault tolerance and straggler mitigation: port of
``src/repro/training/elastic.py``.

* ``HeartbeatMonitor`` — lease-backed liveness: hosts that miss
  ``timeout`` are declared failed.
* ``ElasticMesh`` — given the surviving ranks, picks the largest valid
  (data, model) mesh (the model-parallel degree is fixed; the data axis
  shrinks or grows), builds its ``DeviceMesh`` and reshards a train state
  onto it: checkpoint -> remesh -> restore -> continue.
* ``StragglerMitigator`` — per-step host durations are tracked; hosts
  slower than ``factor`` x the median of the hosts' medians are flagged,
  and microbatch shares go as 1 / median duration.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device
from repro_torch.sharding import ShardingPolicy
from repro_torch.sharding.policy import NamedSharding
from repro_torch.sharding.specs import device_put, param_shardings


@dataclass
class HeartbeatMonitor:
    timeout: float = 30.0
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, host_id: int, now: Optional[float] = None):
        self._last[host_id] = time.monotonic() if now is None else now

    def failed_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items() if now - t > self.timeout]

    def alive_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items() if now - t <= self.timeout]


class ElasticMesh:
    """Rebuild the mesh when the healthy rank set changes."""

    def __init__(self, model_parallel: int, axis_names=("data", "model")):
        self.model_parallel = model_parallel
        self.axis_names = axis_names

    def best_shape(self, num_devices: int) -> Tuple[int, int]:
        mp = self.model_parallel
        if num_devices < mp:
            raise RuntimeError(
                f"need >= {mp} devices for model parallelism, have {num_devices}")
        data = num_devices // mp
        return (data, mp)

    def make_mesh(self, ranks=None, device_type="cuda") -> DeviceMesh:
        """A ``DeviceMesh`` of :meth:`best_shape` over the first data x
        model of ``ranks`` (default: every rank of the world).  Every rank
        of the world calls it, those left out too: building the mesh's
        process groups is collective."""
        device_type = resolve_device(device_type).type
        ranks = list(range(dist.get_world_size())) if ranks is None \
            else list(ranks)
        shape = self.best_shape(len(ranks))
        n = shape[0] * shape[1]
        return DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(shape),
                          mesh_dim_names=tuple(self.axis_names))

    def reshard_state(self, state, old_mesh: DeviceMesh,
                      new_mesh: DeviceMesh):
        """Move a train state ``{"params", "opt": {"m", "v", "step"}}`` onto
        ``new_mesh`` with the policy's specs recomputed for it.  Its DTensor
        leaves are gathered on ``old_mesh`` first, so every rank of both
        meshes calls it."""
        policy = ShardingPolicy(new_mesh)
        p_sh = param_shardings(state["params"], policy)
        sh = {"params": p_sh,
              "opt": {"m": p_sh, "v": p_sh,
                      "step": NamedSharding(new_mesh, ())}}
        return device_put(state, sh)


@dataclass
class StragglerMitigator:
    factor: float = 1.5
    window: int = 16
    _durations: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, host_id: int, step_duration: float):
        buf = self._durations.setdefault(host_id, [])
        buf.append(step_duration)
        if len(buf) > self.window:
            buf.pop(0)

    def medians(self) -> Dict[int, float]:
        return {h: float(np.median(v)) for h, v in self._durations.items() if v}

    def stragglers(self) -> List[int]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        overall = float(np.median(list(meds.values())))
        return [h for h, m in meds.items() if m > self.factor * overall]

    def reassignment(self, num_microbatches: int) -> Dict[int, int]:
        """Deadline-aware microbatch shares proportional to 1/median
        duration."""
        meds = self.medians()
        if not meds:
            return {}
        inv = {h: 1.0 / m for h, m in meds.items()}
        tot = sum(inv.values())
        raw = {h: num_microbatches * w / tot for h, w in inv.items()}
        out = {h: int(np.floor(r)) for h, r in raw.items()}
        rem = num_microbatches - sum(out.values())
        for h, _ in sorted(raw.items(), key=lambda kv: -(kv[1] % 1)):
            if rem <= 0:
                break
            out[h] += 1
            rem -= 1
        return out
