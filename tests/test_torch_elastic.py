"""The port's elastic scaling (``repro_torch.training.elastic``): the
reference's four tests (tests/test_elastic.py) on the port, and on a
4-process ``gloo`` world a ``DeviceMesh`` over the live ranks and a train
state resharded from a (2, 2) mesh onto the (1, 2) mesh left after a host
of two ranks is lost, its values unchanged and its specs recomputed."""
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.training.elastic import (ElasticMesh,  # noqa: E402
                                          HeartbeatMonitor,
                                          StragglerMitigator)


def test_heartbeat_failure_detection():
    hb = HeartbeatMonitor(timeout=10.0)
    hb.beat(0, now=0.0)
    hb.beat(1, now=0.0)
    hb.beat(0, now=8.0)
    assert hb.failed_hosts(now=12.0) == [1]
    assert hb.alive_hosts(now=12.0) == [0]


def test_elastic_mesh_shrinks_data_axis():
    em = ElasticMesh(model_parallel=4)
    assert em.best_shape(32) == (8, 4)
    assert em.best_shape(28) == (7, 4)
    assert em.best_shape(5) == (1, 4)
    with pytest.raises(RuntimeError):
        em.best_shape(3)


def test_straggler_detection_and_reassignment():
    sm = StragglerMitigator(factor=1.5)
    for _step in range(8):
        sm.record(0, 1.0)
        sm.record(1, 1.1)
        sm.record(2, 3.0)
    assert sm.stragglers() == [2]
    shares = sm.reassignment(16)
    assert sum(shares.values()) == 16
    assert shares[2] < shares[0]


def test_reassignment_handles_empty():
    assert StragglerMitigator().reassignment(8) == {}


def test_make_mesh_defaults_to_the_card(monkeypatch):
    import inspect
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(ElasticMesh.make_mesh).parameters[
        "device_type"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticMesh(2).make_mesh([0, 1])


# ----------------------------------------------- 4-process world ----

def _state():
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.training import optimizer
    model = Model(get_reduced("phi4-mini-3.8b"))
    params = model.init(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    opt = optimizer.init(params)
    g = torch.Generator().manual_seed(1)
    opt = optimizer.tree_map(
        lambda t: torch.randn(t.shape, generator=g) if t.dim() else t, opt)
    return {"params": params, "opt": opt}


def _elastic_worker(rank, tmp):
    from test_torch_sharded_model import init_world
    from repro_torch.sharding import ShardingPolicy
    from repro_torch.sharding.specs import param_spec
    from repro_torch.training.optimizer import leaves
    init_world(rank, tmp)
    try:
        em = ElasticMesh(model_parallel=2)
        full = em.make_mesh(device_type="cpu")
        state = em.reshard_state(_state(), None, full)
        # a host of ranks 2 and 3 is lost: every rank builds the new mesh
        # over the live ranks and takes part in the move
        live = em.make_mesh([0, 1, 3], device_type="cpu")
        moved = em.reshard_state(state, full, live)
        out = {"full": full.mesh.tolist(), "live": live.mesh.tolist(),
               "names": list(live.mesh_dim_names)}
        if rank in (0, 1):
            ref = _state()
            out["equal"] = all(
                torch.equal(a.full_tensor(), b)
                for a, b in zip(leaves(moved), leaves(ref)))
            emb = moved["params"]["embed"]
            out["embed"] = [[str(p) for p in emb.placements],
                            list(emb.to_local().shape)]
            out["embed_spec"] = list(param_spec(
                "['embed']", tuple(emb.shape), ShardingPolicy(live)))
            out["step"] = int(moved["opt"]["step"].full_tensor())
        with open(f"{tmp}/elastic{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_reshard_onto_the_live_ranks(tmp_path):
    from test_torch_sharded_model import run_world
    run_world(_elastic_worker, tmp_path, timeout=120)
    outs = []
    for rank in range(4):
        with open(tmp_path / f"elastic{rank}.json") as f:
            outs.append(json.load(f))
    assert outs[0]["full"] == [[0, 1], [2, 3]]
    assert outs[0]["live"] == [[0, 1]] and outs[0]["names"] == ["data",
                                                               "model"]
    for out in outs[:2]:
        assert out["equal"] and out["step"] == 0
        # the embedding's spec on (1, 2): model on the larger dim, no
        # data shard (a data axis of 1 fits nothing)
        assert out["embed_spec"] == ["model", None]
        placements, local = out["embed"]
        assert local[0] * 2 == _state()["params"]["embed"].shape[0]
