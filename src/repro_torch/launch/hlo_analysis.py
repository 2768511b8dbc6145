"""Collective-byte accounting and roofline terms: port of
``src/repro/launch/hlo_analysis.py``.

The reference parses the post-SPMD HLO text of a compiled program and sums
the per-device bytes moved by every collective op.  The port compiles no
program: its collectives are the ``_c10d_functional`` ops that DTensor
issues (a redistribution at a shard site, or a placement change inside an
op), which the cost counter's dispatch mode (``launch/jaxpr_cost.py``)
sees one by one on each rank's local tensors.  :func:`collective_record`
reads one such op; :func:`collective_bytes` applies the reference's
ring-algorithm volume factors to the records:

    all-reduce        2·(g-1)/g · bytes
    all-gather          (g-1)/g · bytes   (bytes = full gathered result)
    reduce-scatter      (g-1)   · bytes   (bytes = the scattered result)
    all-to-all          (g-1)/g · bytes
    collective-permute        1 · bytes

with ``bytes`` the op's local result and ``g`` its process group's size.
A broadcast (no HLO counterpart; DTensor issues one only to place a
replicated tensor) is charged 1 · bytes, as a permute is.

Hardware constants are the NVIDIA H100 SXM5's, the card the port runs on:
989 TFLOP/s dense bf16 and 67 TFLOP/s fp32 outside the tensor cores,
3.35 TB/s HBM3 (NVIDIA H100 Tensor Core GPU datasheet, SXM column), and
450 GB/s a GPU in one direction over fourth-generation NVLink (the
datasheet's 900 GB/s is both directions of 18 links of 25 GB/s each way).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989e12         # bf16 dense / GPU
FP32_FLOPS = 67e12          # fp32 outside the tensor cores / GPU
HBM_BW = 3.35e12            # bytes/s / GPU
LINK_BW = 450e9             # bytes/s / GPU, one direction of NVLink 4

# the _c10d_functional ops DTensor issues (their overload packet names),
# by kind; any other collective is left unpriced and fails the count
# against CommDebugMode's
_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def collective_kind(name: str) -> Optional[str]:
    """The kind of the collective op whose overload packet is ``name``
    (``c10d_functional.all_reduce`` and ``all_reduce`` alike), or None."""
    return _KINDS.get(name.rsplit(".", 1)[-1])


def comm_debug_counts(comm) -> Dict[str, int]:
    """A ``CommDebugMode``'s collective counts by kind."""
    counts: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = collective_kind(str(op))
        counts[kind] = counts.get(kind, 0) + n
    return counts


def _group_size(args) -> int:
    """The size of the process group a ``_c10d_functional`` op names (its
    last string argument)."""
    import torch.distributed as dist
    name = [a for a in args if isinstance(a, str)][-1]
    return dist.distributed_c10d._resolve_process_group(name).size()


def collective_record(func, args, out) -> Optional[Tuple[str, int, int]]:
    """(kind, local result bytes, group size) of a ``_c10d_functional``
    op, or None for any other op."""
    if func.namespace != "_c10d_functional":
        return None
    kind = collective_kind(func.overloadpacket.__name__)
    if kind is None:
        return None
    return kind, out.numel() * out.element_size(), _group_size(args)


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    bytes_by_kind: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    total_bytes: float = 0.0

    def as_dict(self):
        return {"counts": dict(self.counts),
                "bytes_by_kind": {k: float(v) for k, v in self.bytes_by_kind.items()},
                "total_bytes": float(self.total_bytes)}


def collective_bytes(records, num_devices: int) -> CollectiveStats:
    """Per-device collective traffic estimate from the records of
    :func:`collective_record` (the reference reads them from optimized HLO
    text).  Every op is counted; one whose group has a single rank or that
    moves no bytes adds no traffic (the reference skips those).
    ``num_devices`` is the group size of a record that names none."""
    stats = CollectiveStats()
    for op, nbytes, g in records:
        g = g or num_devices
        stats.counts[op] += 1
        if g <= 1 or nbytes == 0:
            continue
        if op == "all-reduce":
            moved = 2.0 * (g - 1) / g * nbytes
        elif op in ("collective-permute", "broadcast"):
            moved = float(nbytes)
        elif op == "reduce-scatter":
            moved = (g - 1) * float(nbytes)     # result is the scattered shard
        else:  # all-gather / all-to-all: result is the full gathered shape
            moved = (g - 1) / g * nbytes
        stats.bytes_by_kind[op] += moved
        stats.total_bytes += moved
    return stats


def roofline_terms(cost: dict, coll: CollectiveStats) -> dict:
    """Three roofline terms (seconds, per device == per step)."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    bytes_accessed = float(cost.get("bytes accessed", 0.0) or 0.0)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_coll = coll.total_bytes / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll,
             "hlo_flops_per_device": flops,
             "hlo_bytes_per_device": bytes_accessed,
             "collective_bytes_per_device": coll.total_bytes}
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    bound = max(t_compute, t_memory, t_coll)
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms
