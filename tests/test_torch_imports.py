"""What the port may import, and where its entry points run.

The port (``src/repro_torch``) and ``chip_smoke.py`` must run on a machine
without JAX: nothing in them imports ``jax``, ``jaxlib``, ``ml_dtypes`` or
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
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
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


def test_sanitizer_is_not_ported_yet(cpu_model, monkeypatch):
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
