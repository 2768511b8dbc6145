"""§Perf hill-climbing tool: port of ``src/repro/launch/hillclimb.py``.
Re-trace and re-analyse a cell under named sharding/config variants and
print before/after roofline terms, on a fake 256-rank group
(``dryrun.fake_production_mesh``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch nemotron-4-340b --shape decode_32k --variant serve_tp_only
"""
from __future__ import annotations

import argparse
import json
import pathlib

import torch.distributed as dist

from repro_torch.launch.dryrun import fake_production_mesh
from repro_torch.launch.dryrun_lib import run_cell

# Named variants: sharding-rule overrides handed to ShardingPolicy.
VARIANTS = {
    "baseline": {},
    # serving: TP-only params — no per-step FSDP all-gathers
    "serve_tp_only": {"_no_fsdp": True},
    # training: sequence-shard the residual stream (ring-attention style)
    "seq_shard": {"seq": ("model",)},
    # decode: shard KV cache batch over model too (more chips per cache)
    "decode_batch_2d": {"decode_batch": ("pod", "data", "model")},
    # MoE: expert-parallel over data axis instead of model
    "experts_on_data": {"experts": ("data",), "expert_batch": ("model",)},
    # disable activation TP (diagnose collective sources)
    "no_act_tp": {"act_mlp": None, "heads": None},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline",
                    help="|".join(VARIANTS))
    ap.add_argument("--rules", default=None, help="extra JSON rule overrides")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="reports/hillclimb.jsonl")
    args = ap.parse_args(argv)

    rules = dict(VARIANTS[args.variant])
    if args.rules:
        extra = json.loads(args.rules)
        rules.update({k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in extra.items()})
    mesh = fake_production_mesh(multi_pod=False)
    try:
        rec = run_cell(args.arch, args.shape, mesh, rules=rules or None,
                       remat=not args.no_remat)
    finally:
        dist.destroy_process_group()
    rec["variant"] = args.variant
    rec["extra_rules"] = args.rules
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    r = rec["roofline"]
    print(json.dumps({k: rec["collectives"]["bytes_by_kind"].get(k, 0.0)
                      for k in ("all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute")},
                     indent=1))
    print(f"variant={args.variant}: compute={r['compute_s']:.3e}s "
          f"memory={r['memory_s']:.3e}s collective={r['collective_s']:.3e}s "
          f"bottleneck={r['bottleneck']} frac={r['roofline_fraction']:.3f}")


if __name__ == "__main__":
    main()
