"""What the port may import, and where its entry points run.

The port (``src/repro_torch``), its benchmarks and examples
(``benchmarks/bench_torch_*.py``, ``examples/torch_*.py``) and
``chip_smoke.py`` must run on a machine without JAX: nothing in them imports ``jax``, ``jaxlib``, ``ml_dtypes`` or
the JAX package ``repro``.  Its entry points run on ``cuda`` unless the
caller names another device, and with no CUDA device they raise instead of
quietly running on the CPU.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.control_plane import ControlPlane  # noqa: E402
from repro_torch.serving.disagg import DisaggregatedCluster  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, PrefillEngine  # noqa: E402
from repro_torch.serving.engine_backend import EngineScenarioRunner  # noqa: E402
from repro_torch.serving.scenarios import build_backend, get_scenario  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.training.data import (DataConfig, batch_for_model,  # noqa: E402
                                       batch_iterator, make_batch)
from repro_torch.training.train_loop import Trainer  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    """The port's package, ``chip_smoke.py``, and the port's benchmarks and
    examples: all of them run on the card's machine, which has no JAX."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "benchmarks").glob("bench_torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    names = {p.name for p in files}
    assert {"bench_torch_engine_throughput.py", "bench_torch_kernels.py",
            "torch_quickstart.py"} <= names
    bad = []
    for path in files:
        for name in _imported(ast.parse(path.read_text(), str(path))):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert bad == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def cpu_model():
    model = Model(get_reduced("phi4-mini-3.8b"))
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    return model, params


def test_entry_points_default_to_cuda_and_never_fall_back(no_cuda, cpu_model):
    model, params = cpu_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedCluster(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefillEngine(model, params, max_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(model, params, num_slots=2, max_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineScenarioRunner(get_scenario("parity-2d-cold", fast=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_backend("parity-2d-cold", backend="engine", fast=True)
    assert resolve_device("cpu") == torch.device("cpu")


def test_scenario_runner_runs_where_its_params_live(cpu_model):
    model, params = cpu_model
    runner = build_backend("parity-2d-cold", backend="engine", fast=True,
                           model=model, params=params, warmup=False)
    assert runner.device == torch.device("cpu")
    assert runner.cluster.device == torch.device("cpu")
    cpu = EngineScenarioRunner(get_scenario("parity-2d-cold", fast=True),
                               device="cpu")
    assert cpu.cluster.decoders[0].caches["k"].device == torch.device("cpu")


def test_cpu_only_when_named(cpu_model):
    model, params = cpu_model
    cluster = DisaggregatedCluster(model, params, num_decode=1, max_len=64,
                                   device="cpu")
    assert cluster.device == torch.device("cpu")
    assert all(d.device == torch.device("cpu") for d in cluster.decoders)
    assert cluster.decoders[0].caches["k"].device == torch.device("cpu")


def test_sanitizer_switch_matches_reference(cpu_model, monkeypatch):
    """The sanitizer switch works as in the reference: ``sanitize=True``
    attaches it, ``REPRO_SANITIZE=1`` attaches it when the argument is
    left at None, and an explicit ``sanitize=False`` wins over the
    environment."""
    model, params = cpu_model
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert DisaggregatedCluster(model, params, device="cpu",
                                sanitize=True).sanitizer is not None
    assert ControlPlane(2, sanitize=True).sanitizer is not None
    assert ControlPlane(2).sanitizer is None
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert DisaggregatedCluster(model, params, device="cpu").sanitizer \
        is not None
    assert ControlPlane(2).sanitizer is not None
    assert DisaggregatedCluster(model, params, device="cpu",
                                sanitize=False).sanitizer is None
    assert ControlPlane(2, sanitize=False).sanitizer is None


TRAIN_SHAPE = ShapeConfig("t", 32, 2, "train")


def test_training_entry_points_default_to_cuda(no_cuda):
    cfg = get_reduced("phi4-mini-3.8b")
    dc = DataConfig(cfg.vocab_size, 32, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TRAIN_SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(dc, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(batch_iterator(dc))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_for_model(cfg, TRAIN_SHAPE, 0)


def test_training_on_the_cpu_only_when_named(cpu_model):
    model, params = cpu_model
    cfg = model.cfg
    batch = make_batch(DataConfig(cfg.vocab_size, 32, 2), 0, device="cpu")
    assert batch["tokens"].device == torch.device("cpu")
    with torch.no_grad():
        loss = model.train_loss(params, batch)
    assert loss.device == torch.device("cpu") and torch.isfinite(loss)
    tr = Trainer(cfg, TRAIN_SHAPE, device="cpu")
    assert tr.device == torch.device("cpu")
    assert all(t.device == torch.device("cpu") for t in
               (tr.state["params"]["embed"], tr.state["opt"]["step"]))


def test_moe_module_imports_only_torch_and_numpy():
    path = ROOT / "src" / "repro_torch" / "models" / "moe.py"
    names = {n.split(".")[0] for n in _imported(ast.parse(path.read_text()))}
    assert names & set(FORBIDDEN) == set()
    assert names <= {"__future__", "numpy", "torch", "repro_torch"}


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_model_builds_the_moe_family(name):
    model = Model(get_reduced(name))
    assert {d.mlp for d in model.descs} == {"moe"}
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    assert all(set(layer) == {"attn", "moe"} for layer in params["layers"])


@pytest.mark.parametrize("name,keys", [
    ("seamless-m4t-medium", {"attn", "xattn", "mlp"}),
    ("phi-3-vision-4.2b", {"attn", "mlp"})])
def test_model_builds_the_encdec_and_vlm_families(name, keys):
    """The two families the port refused until it ran them: each builds,
    with its frontend projection, and the encoder-decoder with its
    encoder and a cross attention in every decoder layer."""
    model = Model(get_reduced(name))
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    assert all(set(layer) == keys for layer in params["layers"])
    cfg = model.cfg
    assert params["frontend_proj"].shape == (cfg.frontend_dim, cfg.d_model)
    encdec = cfg.family == "encdec"
    assert ("enc_layers" in params) == ("enc_final_norm" in params) == encdec
    assert model.n_cross == (cfg.num_layers if encdec else 0)
    assert not (model.supports_paged_decode or model.supports_padded_prefill
                or model.supports_prefill_resume)


def test_every_registry_architecture_builds():
    """``Model(get_config(name))`` for all 11 names of the registry (no
    init: the layout, the layer lists and the cache rows)."""
    from repro_torch.configs import _MODULES, get_config
    assert len(_MODULES) == 11
    for name in _MODULES:
        model = Model(get_config(name))
        assert model.cfg.name == name
        assert len(model.layer_descs) == model.n_layers == \
            model.cfg.num_layers


CHANGED = ("models/layers.py", "models/model.py", "serving/engine.py",
           "training/data.py", "training/optimizer.py", "bridge.py",
           "configs/__init__.py", "configs/seamless_m4t_medium.py",
           "configs/phi_3_vision_4_2b.py",
           "kernels/decode_attention/ops.py")


@pytest.mark.parametrize("rel", CHANGED)
def test_slice_modules_import_only_torch_numpy_and_the_port(rel):
    """The modules the encoder-decoder and VLM slice changed import
    nothing of JAX or the JAX package: only the standard library, numpy,
    torch and the port."""
    import sys
    path = ROOT / "src" / "repro_torch" / rel
    names = {n.split(".")[0] for n in _imported(ast.parse(path.read_text()))}
    assert names & set(FORBIDDEN) == set()
    assert names - set(sys.stdlib_module_names) <= {"numpy", "torch",
                                                    "repro_torch"}


def test_ssm_module_imports_only_torch():
    path = ROOT / "src" / "repro_torch" / "models" / "ssm.py"
    names = {n.split(".")[0] for n in _imported(ast.parse(path.read_text()))}
    assert names & set(FORBIDDEN) == set()
    assert names <= {"__future__", "math", "torch", "repro_torch"}


@pytest.mark.parametrize("name,mixers", [
    ("jamba-v0.1-52b", {"attn", "mamba"}), ("xlstm-125m", {"mlstm", "slstm"})])
def test_model_builds_the_recurrent_families(name, mixers):
    model = Model(get_reduced(name))
    assert set(model.mixers) == mixers
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    for layer, mixer in zip(params["layers"], model.mixers):
        assert set(layer) & {"attn", "mamba", "mlstm", "slstm"} == {mixer}
    assert not (model.supports_paged_decode or model.supports_padded_prefill
                or model.supports_prefill_resume)


@pytest.mark.parametrize("name,counts,kv_bytes", [
    ("jamba-v0.1-52b", {"mamba": 28, "attn": 4}, 2 * 4 * 8 * 128 * 2),
    ("xlstm-125m", {"mlstm": 9, "slstm": 3}, 0)])
def test_full_size_recurrent_models_build(name, counts, kv_bytes):
    """The published configs build (layout, caches on the meta device, KV
    bytes a token over the attention layers only)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import kv_token_bytes
    model = Model(get_config(name))
    assert {m: model.mixers.count(m) for m in set(model.mixers)} == counts
    caches = model.cache_init(2, 64, "meta")
    assert all(t.shape[1] == 2 for t in caches.values())
    assert kv_token_bytes(model) == kv_bytes


SLICE_10 = ("sharding/__init__.py", "sharding/policy.py", "sharding/specs.py",
            "launch/mesh.py", "training/compression.py",
            "training/elastic.py", "models/moe.py",
            "kernels/paged_attention/ops.py", "kernels/flash_attention/ops.py")


@pytest.mark.parametrize("rel", SLICE_10)
def test_sharding_slice_modules_import_only_torch_numpy_and_the_port(rel):
    """The sharding slice's modules, and those it changed, import nothing
    of JAX or the JAX package."""
    import sys
    path = ROOT / "src" / "repro_torch" / rel
    names = {n.split(".")[0] for n in _imported(ast.parse(path.read_text()))}
    assert names & set(FORBIDDEN) == set()
    assert names - set(sys.stdlib_module_names) <= {"numpy", "torch",
                                                    "repro_torch"}


def test_mesh_entry_points_default_to_cuda(no_cuda):
    """``make_production_mesh``, ``make_test_mesh`` and
    ``ElasticMesh.make_mesh`` build on ``cuda`` unless told otherwise, and
    with no CUDA device they raise before touching a process group."""
    import inspect
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.training.elastic import ElasticMesh
    for fn in (make_production_mesh, make_test_mesh, ElasticMesh.make_mesh):
        assert inspect.signature(fn).parameters["device_type"].default \
            == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_test_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticMesh(1).make_mesh([0])


def test_kernel_wrappers_refuse_a_dtensor():
    """A DTensor never reaches a kernel or its plain version: the wrappers
    raise, on any device (the model hands them each rank's local shards)."""
    import os
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.launch.mesh import make_test_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", world_size=1, rank=0,
                                init_method=f"file://{os.path.join(tmp, 's')}")
        try:
            mesh = make_test_mesh((1, 1), device_type="cpu")
            q = DTensor.from_local(torch.zeros(1, 2, 32), mesh,
                                   [Replicate()] * 2)
            k = torch.zeros(1, 4, 1, 32)
            lengths = torch.ones(1, dtype=torch.int32)
            with pytest.raises(TypeError, match="DTensor"):
                decode_attention(q, k, k, lengths)
            with pytest.raises(TypeError, match="DTensor"):
                paged_attention(q, k, k, lengths[:, None], lengths)
            with pytest.raises(TypeError, match="DTensor"):
                flash_attention(q[:, None], k, k)
        finally:
            dist.destroy_process_group()
