"""The benchmark's own tests (``python -m pytest -q perfbench/tests``).

They import the harness as ``run.py`` does: the benchmark's folder and the
program's ``src`` on the path.  Tests marked ``cuda`` need a card and skip
without one, deciding inside the test."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent, HERE.parent.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
