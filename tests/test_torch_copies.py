"""The port's copies of the JAX package's numpy-only modules stay copies.

The port imports nothing of ``repro``, so it carries its own copies of the
configs, the control-plane mechanisms (``core``) and the serving modules
that import no JAX.  Each copy must equal its reference file, compared as
ASTs after the reference's ``repro.`` import paths are rewritten to
``repro_torch.``.  The one allowed difference: the control plane's lazy
import of the coherence sanitizer (``repro.analysis``, control_plane.py:
433-437) is replaced by a ``NotImplementedError`` until the sanitizer is
ported.  The reference files are read as text; nothing is imported.
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
]


class _Normalise(ast.NodeTransformer):
    """Rewrite ``repro`` import paths to ``repro_torch`` and drop the
    sanitizer branch of ``ControlPlane.__init__`` (reference:
    ``if sanitize is not False: <lazy import>``; port: ``if sanitize:
    raise NotImplementedError``)."""

    def visit_ImportFrom(self, node):
        if node.module == "repro" or (node.module or "").startswith("repro."):
            node.module = "repro_torch" + node.module[len("repro"):]
        return node

    def visit_If(self, node):
        test = ast.unparse(node.test)
        if test in ("sanitize is not False", "sanitize"):
            return None
        return self.generic_visit(node)


def _tree(path):
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference(rel):
    assert _tree(PORT / rel) == _tree(REF / rel)


def test_only_the_control_plane_drops_a_branch():
    """The normaliser's one exemption fires in the control plane only, and
    there exactly once on each side."""
    for rel in COPIES:
        for root in (REF, PORT):
            tree = ast.parse((root / rel).read_text())
            hits = [n for n in ast.walk(tree) if isinstance(n, ast.If)
                    and ast.unparse(n.test) in ("sanitize is not False",
                                                "sanitize")]
            assert len(hits) == (rel == "serving/control_plane.py"), \
                (root, rel)
    port = ast.parse((PORT / "serving/control_plane.py").read_text())
    branch = [n for n in ast.walk(port) if isinstance(n, ast.If)
              and ast.unparse(n.test) == "sanitize"][0]
    assert ast.unparse(branch.body[0]).startswith("raise NotImplementedError")


def test_registry_functions_are_copies():
    """The port's registry holds the dense configs it runs; its lookup
    functions are the reference's."""
    def functions(path):
        tree = ast.parse(path.read_text())
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef)}
    ref = functions(REF / "configs" / "__init__.py")
    port = functions(PORT / "configs" / "__init__.py")
    assert set(port) == {"get_config", "get_reduced"}
    assert all(port[name] == ref[name] for name in port)
