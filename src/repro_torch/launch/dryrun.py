"""Multi-pod dry run: port of ``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape decode_32k --mesh single --out reports/dryrun_torch.jsonl

The reference forces 512 host devices through an XLA flag before JAX
starts.  The port starts a fake process group (``torch.distributed``'s
``"fake"`` backend: every collective a no-op) of the mesh's 256 or 512
ranks in this process, as rank 0, before it builds the mesh, and runs each
cell on ``meta`` tensors over it (``dryrun_lib``); no device is touched.
One JSON record a cell is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import traceback

import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch.dryrun_lib import run_cell
from repro_torch.launch.mesh import make_production_mesh

MESH_RANKS = {"single": 256, "multi": 512}


def start_fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0
    (any group already started is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def fake_production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size."""
    start_fake_world(MESH_RANKS["multi" if multi_pod else "single"])
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Multi-pod dry-run: trace every (arch x shape x mesh) "
                    "cell on meta tensors and extract roofline terms.")
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun.jsonl")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-collectives", action="store_true",
                    help="leave collectives out of the roofline terms "
                         "(multi-pod shardability proof; roofline is "
                         "single-pod)")
    ap.add_argument("--rules", default=None,
                    help="JSON dict of sharding-rule overrides (hillclimb)")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", True))
    rules = json.loads(args.rules) if args.rules else None
    if rules:
        rules = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in rules.items()}

    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    try:
        with out_path.open("a") as f:
            for mesh_name, multi_pod in meshes:
                mesh = fake_production_mesh(multi_pod)
                for arch in archs:
                    for shape in shapes:
                        if not shape_applicable(get_config(arch),
                                                SHAPES[shape]):
                            print(f"[{mesh_name}] {arch:22s} {shape:12s} "
                                  f"SKIP (full attention, long_500k)",
                                  flush=True)
                            continue
                        try:
                            rec = run_cell(
                                arch, shape, mesh, rules=rules,
                                remat=not args.no_remat,
                                skip_collectives=args.skip_collectives)
                            rec["mesh_name"] = mesh_name
                            f.write(json.dumps(rec) + "\n")
                            f.flush()
                        except Exception:
                            n_fail += 1
                            print(f"[{mesh_name}] {arch} {shape} FAILED",
                                  flush=True)
                            traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
