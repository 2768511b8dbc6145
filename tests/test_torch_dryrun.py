"""The port's dry run (``repro_torch.launch.dryrun_lib``), its collective
accounting (``launch/hlo_analysis.py``) and CLIs, against the reference's.

A fake process group (``torch.distributed``'s ``"fake"`` backend: every
collective a no-op) of 8 ranks stands for the mesh; the tensors are
``meta``.  In this process, for the module:

* each collective kind issued on a (2, 4) mesh, recorded by the counter's
  dispatch mode, priced as the reference prices the same op in HLO text
  (its parser fed the op's result shape and group), and counted as
  ``CommDebugMode`` counts it;
* the reference's depth-1/depth-2 extrapolation of the collectives equal
  to the direct count on reduced models of 3 periods;
* a sharded train step counted at the unsharded step's global FLOPs.

In a subprocess, as tests/test_dryrun_small.py runs the reference's: the
cell ``xlstm-125m`` x ``decode_32k`` on a (2, 4) mesh at full size.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch.dryrun_lib import (extrapolated_collectives,  # noqa: E402
                                          trace_step)
from repro_torch.launch.jaxpr_cost import cost_of, counting  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import ShardingPolicy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.dryrun import start_fake_world
    from repro_torch.launch.mesh import make_test_mesh
    start_fake_world(8)
    try:
        yield make_test_mesh((2, 4), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _dt(mesh, local_shape, placements):
    return DTensor.from_local(torch.empty(local_shape, device="meta"), mesh,
                              placements, run_check=False)


def _all_to_all(mesh):
    from torch.distributed import _functional_collectives as funcol
    x = torch.empty((8, 16), device="meta")
    return funcol.all_to_all_single(x, None, None,
                                    group=mesh.get_group("model"))


# (kind, how to issue it on the (2, 4) mesh, the op's local result shape)
CASES = {
    "all-reduce": (lambda m: _dt(m, (4, 128), [Replicate(), Partial()])
                   .redistribute(m, [Replicate(), Replicate()]), (4, 128)),
    "all-gather": (lambda m: _dt(m, (4, 128), [Replicate(), Shard(0)])
                   .redistribute(m, [Replicate(), Replicate()]), (16, 128)),
    "reduce-scatter": (lambda m: _dt(m, (16, 128), [Replicate(), Partial()])
                       .redistribute(m, [Replicate(), Shard(0)]), (4, 128)),
    "all-to-all": (_all_to_all, (8, 16)),
}
HLO_OP = {"all-reduce": "all-reduce", "all-gather": "all-gather",
          "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all"}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_collective_bytes_equal_reference(mesh, kind):
    from repro.launch import hlo_analysis as ref
    issue, result = CASES[kind]
    with CommDebugMode() as comm, counting() as counter:
        issue(mesh)
    coll = hlo_analysis.collective_bytes(counter.collectives, 8)
    assert dict(coll.counts) == {kind: 1}
    assert hlo_analysis.comm_debug_counts(comm) == dict(coll.counts)
    (_, nbytes, group), = counter.collectives
    assert group == 4 and nbytes == 4 * result[0] * result[1]
    line = (f"  %c = f32[{result[0]},{result[1]}] {HLO_OP[kind]}(f32[1] %x), "
            f"replica_groups={{{{0,1,2,3}}}}")
    want = ref.collective_bytes(line, 8)
    assert coll.bytes_by_kind[kind] == want.bytes_by_kind[kind] > 0
    assert coll.total_bytes == want.total_bytes


@pytest.mark.parametrize("arch,shape", [("phi4-mini-3.8b", "prefill_32k"),
                                        ("xlstm-125m", "decode_32k")])
def test_depth_extrapolation_equals_direct_count(mesh, arch, shape):
    """The reference extrapolates depth-1 and depth-2 compiles
    (dryrun_lib.py:172-195); on the port's unrolled layers the
    extrapolation must equal the count at full depth: no layer issues a
    collective that another does not."""
    base = get_reduced(arch)
    cfg = dataclasses.replace(base, num_layers=3 * Model(base).period)
    policy = ShardingPolicy(mesh)
    run, model = trace_step(arch, shape, policy, cfg=cfg)
    assert model.n_periods == 3
    direct = run["collectives"]
    assert direct.counts and dict(direct.counts) == run["comm_counts"]
    ext = extrapolated_collectives(arch, shape, policy, cfg=cfg)
    assert ext["counts"] == dict(direct.counts)
    assert ext["bytes_by_kind"] == pytest.approx(dict(direct.bytes_by_kind))
    assert ext["total_bytes"] == pytest.approx(direct.total_bytes)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "xlstm-125m"])
def test_sharded_counts_are_global(mesh, arch):
    """The counter gives a sharded train step (loss and gradients) the
    unsharded step's contraction FLOPs exactly: DTensor ops at their global
    shapes, ``on_local_shards`` regions scaled by the ranks that split
    them, forward and backward.  The other ops within 1%: an elementwise
    op replicated on ranks that share no work is counted once."""
    from repro_torch.sharding import use_policy
    from repro_torch.sharding.specs import device_put, param_shardings
    from repro_torch.training.optimizer import leaves
    model = Model(get_reduced(arch))
    params = model.init_abstract(torch.float32)
    sharded = device_put(params, param_shardings(params,
                                                 ShardingPolicy(mesh)))
    batch = {"tokens": torch.zeros((8, 64), dtype=torch.int32,
                                   device="meta")}

    def step(p):
        ts = list(leaves(p))
        for t in ts:
            t.requires_grad_(True)
        return torch.autograd.grad(model.train_loss(p, batch), ts)

    plain = cost_of(step, params)
    with use_policy(ShardingPolicy(mesh)):
        got = cost_of(step, sharded)
    assert got.contraction_flops() == plain.contraction_flops()
    assert abs(got.flops / plain.flops - 1) <= 0.01


SCRIPT = r"""
import json
from repro_torch.launch.dryrun import start_fake_world
from repro_torch.launch.dryrun_lib import run_cell
from repro_torch.launch.mesh import make_test_mesh

start_fake_world(8)
mesh = make_test_mesh((2, 4), device_type="cpu")
rec = run_cell("xlstm-125m", "decode_32k", mesh, verbose=False)
print("JSON:" + json.dumps({
    "devices": rec["devices"],
    "flops": rec["cost"]["flops"],
    "coll": rec["collectives"],
    "bottleneck": rec["roofline"]["bottleneck"],
    "mem": rec["memory"],
}))
"""


def test_dryrun_cell_on_8_fake_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON:")][0]
    rec = json.loads(line[5:])
    assert rec["devices"] == 8
    assert rec["flops"] > 0
    assert rec["mem"]["argument_size_in_bytes"] > 0
    assert rec["mem"]["temp_is_eager_peak"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["coll"]["counts"] == rec["coll"]["comm_debug_counts"]


# ------------------------------------------------------------ the CLIs ----

def _assigned(path, name):
    tree = ast.parse(path.read_text())
    node, = [n for n in tree.body if isinstance(n, ast.Assign)
             and any(getattr(t, "id", None) == name for t in n.targets)]
    return ast.literal_eval(node.value)


def _flags(path):
    """(name, default) of each ``add_argument`` call in a module."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "add_argument":
            default = [ast.literal_eval(k.value) for k in node.keywords
                       if k.arg in ("default", "choices", "action")]
            out.append((ast.literal_eval(node.args[0]), default))
    return out


@pytest.mark.parametrize("name", ["dryrun.py", "hillclimb.py"])
def test_cli_flags_equal_reference(name):
    ref = ROOT / "src" / "repro" / "launch" / name
    port = ROOT / "src" / "repro_torch" / "launch" / name
    assert _flags(port) == _flags(ref)


def test_hillclimb_variants_equal_reference():
    ref = _assigned(ROOT / "src/repro/launch/hillclimb.py", "VARIANTS")
    from repro_torch.launch.hillclimb import VARIANTS
    assert VARIANTS == ref
