"""The port's copies of the JAX package's numpy-only modules stay copies.

The port imports nothing of ``repro``, so it carries its own copies of the
configs, the control-plane mechanisms (``core``) and the serving modules
that import no JAX.  Each copy must equal its reference file, compared as
ASTs after the reference's ``repro.`` import paths are rewritten to
``repro_torch.``, with no exemption.  The ported modules that keep some of
the reference's code unchanged (the cluster's sanitizer branch, the
scenario runner's request stream and run loop) are held to it piece by
piece.  The reference files are read as text; nothing is imported.
"""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

COPIES = [
    "configs/base.py", "configs/phi4_mini_3_8b.py", "configs/stablelm_3b.py",
    "core/radix.py", "core/affinity.py", "core/router.py",
    "core/saturation.py", "core/metrics.py", "core/latency.py",
    "core/planner.py", "core/poa.py", "core/controller.py",
    "serving/fabric.py", "serving/paging.py", "serving/control_plane.py",
    "core/kvbm.py", "core/games.py", "core/__init__.py",
    "serving/workload.py", "serving/simulator.py", "serving/scenarios.py",
    "analysis/sanitize.py",
    "configs/qwen3_moe_30b_a3b.py", "configs/arctic_480b.py",
    "configs/minitron_4b.py", "configs/nemotron_4_340b.py",
    "configs/llama31_70b.py",
    "configs/jamba_v0_1_52b.py", "configs/xlstm_125m.py",
    "configs/seamless_m4t_medium.py", "configs/phi_3_vision_4_2b.py",
    "configs/__init__.py",
    "models/runtime_flags.py",
]


class _Normalise(ast.NodeTransformer):
    """Rewrite ``repro`` import paths to ``repro_torch``: those of import
    statements, and the module paths the config registry names as strings
    for ``importlib``."""

    def visit_ImportFrom(self, node):
        if node.module == "repro" or (node.module or "").startswith("repro."):
            node.module = "repro_torch" + node.module[len("repro"):]
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str) and node.value.startswith("repro."):
            node.value = "repro_torch" + node.value[len("repro"):]
        return node


def _tree(path):
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())))


def test_copy_list():
    assert len(COPIES) == len(set(COPIES)) == 33


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference(rel):
    assert _tree(PORT / rel) == _tree(REF / rel)


def _sanitizer_branches(path):
    tree = _Normalise().visit(ast.parse(path.read_text()))
    return [ast.dump(n) for n in ast.walk(tree) if isinstance(n, ast.If)
            and ast.unparse(n.test) == "sanitize is not False"]


@pytest.mark.parametrize("rel", ["serving/disagg.py",
                                 "serving/control_plane.py"])
def test_sanitizer_branch_equals_reference(rel):
    """The cluster and the control plane attach the sanitizer as the
    reference does: on ``sanitize=True``, or on ``REPRO_SANITIZE=1`` when
    the argument is left at None."""
    port = _sanitizer_branches(PORT / rel)
    assert len(port) == 1
    assert port == _sanitizer_branches(REF / rel)


def _members(path, names):
    """AST dumps of the module-level classes, and the methods of
    ``EngineScenarioRunner``, named in ``names``."""
    tree = _Normalise().visit(ast.parse(path.read_text()))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name in names:
            out[node.name] = ast.dump(node)
        if isinstance(node, ast.ClassDef) \
                and node.name == "EngineScenarioRunner":
            for f in node.body:
                if isinstance(f, ast.FunctionDef) and f.name in names:
                    out[f.name] = ast.dump(f)
    return out


def test_engine_backend_keeps_the_reference_stream_and_run():
    """The port's runner changes only where its model and device come
    from: the request stream, the run loop and the result types are the
    reference's, and ``_warmup`` makes the same calls in the same order."""
    names = {"EngineRequestSpec", "EngineRunResult", "_materialize", "_spec",
             "run"}
    rel = "serving/engine_backend.py"
    port = _members(PORT / rel, names)
    assert set(port) == names
    assert port == _members(REF / rel, names)

    def calls(path):
        fn = next(n for n in ast.walk(ast.parse(path.read_text()))
                  if isinstance(n, ast.FunctionDef) and n.name == "_warmup")
        return [ast.unparse(c.func) for c in ast.walk(fn)
                if isinstance(c, ast.Call)]
    assert calls(PORT / rel) == calls(REF / rel)


def test_model_layout_is_the_references():
    """The port's model lays its layers out by the reference's
    ``BlockDesc`` and ``layer_layout`` (model.py:38-71), unchanged."""
    def defs(path):
        tree = ast.parse(path.read_text())
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                and n.name in ("BlockDesc", "layer_layout")}
    port = defs(PORT / "models" / "model.py")
    assert set(port) == {"BlockDesc", "layer_layout"}
    assert port == defs(REF / "models" / "model.py")


def test_registry_functions_are_copies():
    """The port's registry holds every config of the reference; its
    functions are the reference's, all of them."""
    def functions(path):
        tree = ast.parse(path.read_text())
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef)}
    ref = functions(REF / "configs" / "__init__.py")
    port = functions(PORT / "configs" / "__init__.py")
    assert set(port) == set(ref) == {"get_config", "get_reduced",
                                     "all_cells"}
    assert all(port[name] == ref[name] for name in port)
