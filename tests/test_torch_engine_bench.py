"""The port's engine fast-path bench against the reference's, on the CPU.

``benchmarks/bench_torch_engine_throughput.py`` runs the rows of
``benchmarks/bench_engine_throughput.py`` on the port's engines.  Here both
run on the reduced phi4-mini with the same weights (the reference's
``PRNGKey(0)`` bf16 params, bridged with ``params_from_numpy``; the port on
``device="cpu"``), each through its own row functions, and every value of
the three rows that depends on lengths and scheduling only must be equal,
exactly: the prefill point's bucketing (``batches``, ``padded_tokens``),
the paged-capacity row's admission count, ratio, KV bytes and pool
utilization, its flood's utilization histogram, and the occupancy flood's
histogram, ticks and prefill batching.  Wall times and the rates and
ratios computed from them are not compared (a CPU time says nothing about
the card), nor are tokens (argmax flips on near-ties across frameworks).

``check_regression`` keeps the reference's three gates and its factor-2
baseline rule: each is tripped on its own against a baseline file.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_engine_throughput as ref  # noqa: E402
from benchmarks import bench_torch_engine_throughput as port  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402

torch.set_num_threads(1)

# keys of each row that are wall times, or rates and ratios computed from
# them; every other key is compared exactly
TIMED = {"batched_tokens_per_s", "sequential_tokens_per_s",
         "batched_speedup", "rate_ratio", "kernel_rate_ratio",
         "decode_tokens_per_s", "wall_s"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    """The reduced phi4-mini as the reference bench builds it, and the same
    weights in the port on the CPU."""
    jcfg, jm, jp = ref._build_model()
    tcfg = get_reduced(ref.MODEL_NAME)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_numpy(tree, tcfg, dtype=torch.bfloat16, device="cpu")
    return (jcfg, jm, jp), (tcfg, Model(tcfg), tp)


def _untimed(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in TIMED}


def _same(want: dict, got: dict) -> None:
    """Every untimed key of the reference's row, equal in the port's."""
    want = _untimed(want)
    assert want, "nothing to compare"
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("label,depth,lo,hi", [("short_d16", 16, 12, 16),
                                               ("parity_d8", 8, 33, 48)])
def test_prefill_point_buckets_as_the_reference(models, label, depth, lo, hi):
    (jcfg, jm, jp), (tcfg, tm, tp) = models
    want = ref._prefill_point(jm, jp, jcfg, label, depth=depth, lo=lo, hi=hi,
                              repeats=1)
    got = port._prefill_point(tm, tp, tcfg, "cpu", label, depth=depth, lo=lo,
                              hi=hi, repeats=1)
    _same(want, got)
    assert got["batches"] == 2           # one pass a call: a single bucket
    assert got["batched_speedup"] > 0


def test_paged_capacity_row_equals_the_reference(models):
    (jcfg, jm, jp), (tcfg, tm, tp) = models
    want = ref.bench_paged_capacity(jm, jp, jcfg, smoke=True)
    got = port.bench_paged_capacity(tm, tp, tcfg, "cpu", smoke=True)
    _same(want, got)
    assert got["flood"] == want["flood"]
    # chip_smoke.py phase 15 holds the full-width run to this count
    assert got["paged_admitted"] == want["paged_admitted"] == \
        _chip_smoke().PAGED_ADMITTED
    assert got["capacity_ratio"] >= port.MIN_PAGED_CAPACITY
    assert set(got["decode_tokens_per_s"]) == {"sdpa", "paged_sdpa",
                                               "pallas", "paged"}
    assert got["rate_ratio"] > 0 and got["kernel_rate_ratio"] > 0


def test_occupancy_row_equals_the_reference(models):
    (jcfg, jm, jp), (tcfg, tm, tp) = models
    want = ref.bench_occupancy(jm, jp, jcfg, n_requests=8)
    got = port.bench_occupancy(tm, tp, tcfg, "cpu", n_requests=8)
    _same(want, got)
    assert sum(got["histogram"].values()) == got["ticks"]


def test_decode_row_keeps_every_slot_live(models):
    """Each impl's windows run with all 4 slots live (a lost slot raises);
    on the CPU the kernels' plain versions stand in for them."""
    _, (tcfg, tm, tp) = models
    got = port.bench_decode(tm, tp, tcfg, "cpu", steps=2)
    assert set(got) == {"sdpa", "pallas", "paged_sdpa", "paged"}
    assert all(r["tokens_per_s"] == 4 * r["tokens_per_s_per_slot"] > 0
               for r in got.values())


def _payload(speedup=3.0, capacity=3.0, rate=1.0, tokens_per_s=100.0):
    return {"prefill": {"batched_speedup": speedup},
            "decode": {"sdpa": {"tokens_per_s": tokens_per_s}},
            "paged": {"capacity_ratio": capacity, "rate_ratio": rate,
                      "paged_admitted": 12}}


@pytest.mark.parametrize("change,failing", [
    ({}, None),
    ({"speedup": 1.9}, "prefill.batched_speedup"),
    ({"capacity": 1.75}, "paged.capacity_ratio"),
    ({"rate": 0.85}, "paged.rate_ratio"),
    ({"tokens_per_s": 49.0}, "decode.sdpa.tokens_per_s"),
])
def test_check_regression_gates(tmp_path, change, failing):
    """The three gates and the factor-2 rule each fail alone; a payload
    within all of them passes.  The decode rate's halving fails only
    against the baseline, the others against their constants (the
    baseline's 12 admissions are a counter, never gated)."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps(_payload()))
    failures = port.check_regression(_payload(**change), str(base))
    if failing is None:
        assert failures == []
    else:
        assert len(failures) == 1 and failures[0].startswith(failing + ":")


def test_run_needs_a_card(monkeypatch):
    """The bench's entry point resolves its device like the port's entry
    points: with no card it raises, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run(smoke=True)
