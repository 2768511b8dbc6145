"""``BENCHMARK.json`` against its contract, and the benchmark's imports."""
import ast
import json
import re
import sys

from pathlib import Path

import pytest

import architectures
from harness import spec
from harness.spec import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(M) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    cells = 24
    check_s = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 180 + 1200
    assert check_s <= 43200


def test_names_and_units():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(M["paths"][0] + "/")
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in M[group]:
            allowed = {"name", "unit", "better", "source"}
            allowed |= {"bound"} if group == "end_to_end" else \
                {"layer", "moves"}
            assert set(m) - {"workloads"} == allowed, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_cells():
    ws = M["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    used = {w["config"] for w in ws}
    assert used == {c["name"] for c in M["configs"]}
    for w in ws:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.deployment) >= {"decoders", "slots", "max_len",
                                        "decode_impl"}
        assert 0 < cell.limits["logit_gap"] and cell.limits["requests"] >= 1
        for trace in (False, True):
            got = cell.metric_names(trace)
            assert got, (w["name"], trace)
        e2e = cell.metric_names(False)
        assert "setup_s" in e2e and len(e2e) >= 2


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        layers.add(m["layer"])
        moved = e2e[m["moves"]]
        for w in m.get("workloads", [x["name"] for x in M["workloads"]]):
            assert w in moved.get("workloads", [w]), (m["name"], w)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in M["end_to_end"] + M["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_configs_match_the_program_registry():
    """Every configuration held to the program's config by its own
    architecture (``"architecture"``, and ``"program"`` or ``"registry"``)."""
    for c in M["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        arch = architectures.load(cfg)
        assert arch.mismatches(cfg["model"], spec.program_config(cfg)) == []
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    """Whole top-level names: ``repro_torch`` is the port and allowed,
    ``repro`` the JAX package and not."""
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    """Every module under ``reference/`` imports plain PyTorch and the
    standard library, or another reference module, and every
    architecture's ``reference`` is one of them."""
    files = sorted((BENCH_DIR / "reference").rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] in {"torch", "math", "typing",
                                         "__future__", "reference"}, (f, mod)
    for f in sorted((BENCH_DIR / "architectures").glob("*.py")):
        if f.stem == "__init__":
            continue
        arch = architectures.load({"architecture": f.stem})
        assert Path(arch.reference.__file__).resolve() in files, f


ARCH_IMPORTS = set(sys.stdlib_module_names) | {"torch", "architectures",
                                               "reference"}


def _outside_architecture(source: str) -> list:
    """What a module's ``source`` reaches beyond torch, the standard
    library, ``architectures`` and ``reference``: the top-level name of each
    import outside them, and each string that names the program's package
    or the harness as a module (as ``importlib`` would take it)."""
    tree = ast.parse(source)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.split(".")[0] not in ARCH_IMPORTS]
        elif isinstance(node, ast.ImportFrom):
            if node.level or node.module.split(".")[0] not in ARCH_IMPORTS:
                bad.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if re.match(r"(repro_torch|repro|harness)(\.|:|$)", node.value):
                bad.append(node.value)
    return bad


@pytest.mark.parametrize("name", sorted(
    p.name for p in (BENCH_DIR / "architectures").glob("*.py")))
def test_architectures_import_nothing_of_the_program(name):
    """An architecture describes the weights the reference judges with
    (their skeleton and fixed leaves), so it takes nothing from the program
    or the harness."""
    source = (BENCH_DIR / "architectures" / name).read_text()
    assert _outside_architecture(source) == []


@pytest.mark.parametrize("source,bad", [
    ("import repro_torch.models.ssm", ["repro_torch.models.ssm"]),
    ("from repro_torch.models import ssm", ["repro_torch.models"]),
    ("from harness import weights", ["harness"]),
    ("import numpy", ["numpy"]),
    ("from . import dense_gqa", ["."]),
    ("import importlib\nm = importlib.import_module('repro_torch.x')",
     ["repro_torch.x"]),
    ("import math, torch\nfrom reference import dense_gqa\n"
     "from architectures import differ", [])])
def test_the_architecture_import_check_catches_the_program(source, bad):
    assert _outside_architecture(source) == bad


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH_DIR).as_posix() for p in BENCH_DIR.rglob("*")
    if p.is_file() and "__pycache__" not in p.parts))
def test_file_names(path):
    assert PATH.match(path)
