"""Dry-run machinery: port of ``src/repro/launch/dryrun_lib.py``
(mesh-agnostic; the CLI in ``dryrun.py`` starts the fake process group of
256 or 512 ranks before it builds a mesh).

For every (architecture x input-shape x mesh) cell we build the step
function (``train_step`` / ``prefill_step`` / ``decode_step``) over
``meta`` tensors (shapes only, nothing allocated), place them by the
baseline shardings of ``repro_torch.sharding.specs`` as DTensors on a
``DeviceMesh`` of a fake process group (every collective a no-op, so one
process stands for rank 0 of the mesh), run the step once under the cost
counter (``launch/jaxpr_cost.py``) and extract:

  * bytes a device of the arguments and outputs (``specs.
    bytes_per_device``: the spec tables, which prove what fits);
  * FLOPs and bytes of every op, at global shapes, divided by the devices
    as the reference divides its jaxpr counts;
  * the collectives DTensor issues, each with its group and local bytes
    (``launch/hlo_analysis.py``), held to ``CommDebugMode``'s count;

which feed the roofline terms.  There is no compiled program to ask, so
the record's ``memory`` holds no code size, and its
``temp_size_in_bytes`` is the eager peak of live bytes a device allocated
during the step (``temp_is_eager_peak``), outputs included: what an eager
run adds on top of its arguments, not what a compiler would schedule.
``lower_s``/``compile_s`` become ``trace_s``, and the record's
``collectives`` hold the direct counts (``counts``) where the reference
keeps its depth-2 and rolled counts, beside ``CommDebugMode``'s
(``comm_debug_counts``).

The reference counts collectives on depth-1 and depth-2 models with the
layer stack unrolled and extrapolates linearly in depth, because XLA counts
a ``while`` body once.  The port's layers run as a Python loop, so the
full-depth model's collectives are counted directly;
:func:`extrapolated_collectives` still computes the reference's
extrapolation, as a check that no layer issues a collective the others do
not.  For the same reason ``runtime_flags.scan_unroll``,
``inner_scan_unroll`` and ``unroll_for_analysis`` (an exact copy of the
reference's module) have no reader here: every loop already runs unrolled.

A decode step takes its position as a Python int (``Model.decode``); the
dry run's 0-d ``cur_index`` stands for the last position of the cache,
``seq_len - 1``: what a step costs does not depend on it (attention spans
the whole cache, masked).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.launch import hlo_analysis, jaxpr_cost
from repro_torch.models import Model
from repro_torch.sharding import ShardingPolicy, use_policy
from repro_torch.sharding.policy import NamedSharding
from repro_torch.sharding.specs import (bytes_per_device, cache_shardings,
                                        device_put, input_shardings,
                                        param_shardings)
from repro_torch.training import optimizer as opt_lib

OPT_CFG = opt_lib.OptimizerConfig()


def _like(tree, values):
    """A tree shaped like ``tree`` holding ``values`` in ``opt_lib.leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_like(v, values) for v in tree]
    return next(values)


def build_step(arch: str, shape_name: str, policy: ShardingPolicy,
               *, remat=True, cfg=None):
    """Returns (fn, args, in_shardings, donate_argnums, model).  ``args``
    are ``meta`` tensors: the params, optimizer state and caches
    distributed by their specs over ``policy.mesh``, the step inputs plain
    (the same value on every rank, as the model takes them; their
    ``in_shardings`` are the reference's, for their bytes a device)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name]
    model = Model(cfg)
    long_ctx = shape.name == "long_500k"
    mesh = policy.mesh

    if shape.kind == "train":
        params = model.init_abstract(torch.float32)
        p_sh = param_shardings(params, policy)
        opt = opt_lib.init(params)
        batch = model.input_specs(shape)
        state_sh = {"params": p_sh,
                    "opt": {"m": p_sh, "v": p_sh,
                            "step": NamedSharding(mesh, ())}}
        state = device_put({"params": params, "opt": opt}, state_sh)
        b_sh = input_shardings(batch, policy)

        def train_step(state, batch):
            leaves = list(opt_lib.leaves(state["params"]))
            for t in leaves:
                t.requires_grad_(True)
            loss = model.train_loss(state["params"], batch, remat=remat)
            # each gradient placed as its param (a partial sum reduced):
            # the reduction the reference's compiler inserts
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if isinstance(g, DTensor) else g
                     for p, g in zip(leaves,
                                     torch.autograd.grad(loss, leaves))]
            grads = _like(state["params"], iter(grads))
            new_p, new_opt, stats = opt_lib.update(
                OPT_CFG, state["params"], grads, state["opt"])
            return {"params": new_p, "opt": new_opt}, (loss, stats)

        return train_step, (state, batch), (state_sh, b_sh), (0,), model

    params = model.init_abstract(torch.bfloat16)
    p_sh = param_shardings(params, policy)
    params = device_put(params, p_sh)

    if shape.kind == "prefill":
        batch = model.input_specs(shape)
        b_sh = input_shardings(batch, policy)

        def prefill_step(params, batch):
            return model.prefill(params, batch)

        return prefill_step, (params, batch), (p_sh, b_sh), (), model

    with use_policy(None):              # placed below, by the specs
        caches = model.cache_specs(shape)
    c_sh = cache_shardings(caches, policy, long_context=long_ctx)
    caches = device_put(caches, c_sh)
    inp = model.input_specs(shape)
    t_sh = input_shardings(inp["tokens"], policy)
    s_sh = NamedSharding(mesh, ())

    def decode_step(params, caches, tokens, cur_index):
        cur = shape.seq_len - 1 if cur_index.is_meta else int(cur_index)
        return model.decode(params, caches, tokens, cur)

    args = (params, caches, inp["tokens"], inp["cur_index"])
    return decode_step, args, (p_sh, c_sh, t_sh, s_sh), (1,), model


def _shallow_config(cfg, model, k: int):
    """Same architecture at depth = k periods (for linear extrapolation)."""
    over = {"num_layers": model.period * k}
    if cfg.num_encoder_layers:
        over["num_encoder_layers"] = k
    return dataclasses.replace(cfg, **over)


def _spec_of(t: torch.Tensor) -> tuple:
    """The spec of a DTensor's placements (replicated for a plain tensor,
    and along a partial sum, whose every rank holds the whole shape)."""
    if not isinstance(t, DTensor):
        return ()
    parts: list = [[] for _ in range(t.dim())]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            parts[p.dim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in parts)


def _memory_dict(args, in_sh, out, donate, mesh, peak) -> dict:
    """The reference's memory keys, from the spec tables; temps are the
    eager peak (module docstring)."""
    outs = list(opt_lib.leaves(out))
    out_sh = [NamedSharding(mesh, _spec_of(t)) for t in outs]
    donated = {id(t) for i in donate for t in opt_lib.leaves(args[i])}
    aliased = [(t, s) for t, s in zip(outs, out_sh) if id(t) in donated]
    return {"generated_code_size_in_bytes": 0,
            "argument_size_in_bytes": int(bytes_per_device(list(args),
                                                           list(in_sh))),
            "output_size_in_bytes": int(bytes_per_device(outs, out_sh)),
            "alias_size_in_bytes": int(bytes_per_device(
                [t for t, _ in aliased], [s for _, s in aliased])),
            "temp_size_in_bytes": int(peak),
            "temp_is_eager_peak": True}


def trace_step(arch, shape_name, policy, *, remat=True, cfg=None):
    """Build the step and run it once under the counter and
    ``CommDebugMode``.  Returns (record of the run, model): its
    ``jaxpr_cost.Cost``, the collective records, the eager peak, the
    memory dict and ``CommDebugMode``'s counts by kind.  Raises where the
    counter and ``CommDebugMode`` disagree on a count."""
    fn, args, in_sh, donate, model = build_step(
        arch, shape_name, policy, remat=remat, cfg=cfg)
    t0 = time.time()
    with use_policy(policy), CommDebugMode() as comm, \
            jaxpr_cost.counting() as counter:
        out = fn(*args)
    trace_s = time.time() - t0
    coll = hlo_analysis.collective_bytes(counter.collectives,
                                         policy.mesh.size())
    comm_counts = hlo_analysis.comm_debug_counts(comm)
    if dict(coll.counts) != comm_counts:
        raise AssertionError(f"collective counts {dict(coll.counts)} differ "
                             f"from CommDebugMode's {comm_counts}")
    run = {"cost": counter.cost, "collectives": coll,
           "comm_counts": comm_counts, "trace_s": trace_s,
           "memory": _memory_dict(args, in_sh, out, donate, policy.mesh,
                                  counter.peak_bytes)}
    return run, model


def extrapolated_collectives(arch, shape_name, policy, *, remat=True,
                             cfg=None):
    """The reference's depth extrapolation (dryrun_lib.py:172-195): the
    collectives of the model at 1 and 2 periods, extrapolated linearly to
    its ``n_periods``: {"counts", "bytes_by_kind", "total_bytes"}."""
    cfg = cfg if cfg is not None else get_config(arch)
    model = Model(cfg)
    runs = [trace_step(arch, shape_name, policy, remat=remat,
                       cfg=_shallow_config(cfg, model, k))[0]["collectives"]
            for k in (1, 2)]
    c1, c2 = runs
    p = model.n_periods

    def line(a, b):
        return {k: a.get(k, 0) + (p - 1) * (b.get(k, 0) - a.get(k, 0))
                for k in set(a) | set(b)}
    return {"counts": line(c1.counts, c2.counts),
            "bytes_by_kind": line(c1.bytes_by_kind, c2.bytes_by_kind),
            "total_bytes": c1.total_bytes + (p - 1) * (c2.total_bytes
                                                       - c1.total_bytes)}


def run_cell(arch: str, shape_name: str, mesh, *, rules: Optional[dict] = None,
             remat=True, verbose=True, skip_collectives=False) -> dict:
    """One dry-run cell on ``mesh`` (a ``DeviceMesh`` of the fake group):
    the step run once under the counter (module docstring).  With
    ``skip_collectives`` the collectives are still counted (one run gives
    everything) but not priced in the roofline, as the reference leaves
    them out."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k requires sub-quadratic attention"}
    n_dev = mesh.size()
    policy = ShardingPolicy(mesh, rules)
    record = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(str(s) for s in mesh.mesh.shape),
              "devices": int(n_dev), "skipped": False}
    run, model = trace_step(arch, shape_name, policy, remat=remat)
    record["trace_s"] = round(run["trace_s"], 2)
    record["memory"] = run["memory"]
    cost = run["cost"]
    flops = cost.flops / n_dev
    nbytes = cost.bytes / n_dev
    coll = run["collectives"]
    coll_total = 0.0 if skip_collectives else coll.total_bytes

    record["cost"] = {"flops": flops, "bytes_accessed": nbytes,
                      "source": "dispatch"}
    record["collectives"] = {
        "counts": dict(coll.counts),
        "bytes_by_kind": dict(coll.bytes_by_kind),
        "total_bytes": coll_total,
        "comm_debug_counts": run["comm_counts"],
    }

    class _C:  # lightweight stand-in for roofline_terms
        total_bytes = coll_total
    record["roofline"] = hlo_analysis.roofline_terms(
        {"flops": flops, "bytes accessed": nbytes}, _C)

    mf_dev = model.model_flops(shape) / n_dev
    record["model_flops_per_device"] = mf_dev
    record["useful_flops_ratio"] = (mf_dev / flops) if flops else 0.0
    if verbose:
        r = record["roofline"]
        print(f"[{record['mesh']}] {arch:22s} {shape_name:12s} "
              f"trace={record['trace_s']:6.1f}s "
              f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
              f"coll={r['collective_s']:.3e}s -> {r['bottleneck']}"
              f" frac={r['roofline_fraction']:.2f} "
              f"useful={record['useful_flops_ratio']:.2f}", flush=True)
    return record
