"""The reference against the program at a tiny size on the CPU.

In fp32 on both sides (the program's compute and KV types patched to
fp32, its weights the same bf16 values upcast) the program's prompt pass
and its served tokens through the cluster agree with the reference to
rounding: that holds the reference's equations (RoPE, GQA grouping,
norms, MLPs) to the program's.  In the program's own bf16 the control,
the reference in fp8, lies further from the fp32 reference than the
program does."""
import time

import pytest
import torch

import tiny
from harness import check, report, weights
from reference import dense_gqa


@pytest.fixture
def fp32_program(monkeypatch):
    from repro_torch.models import layers, model
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(model, "KV_DTYPE", torch.float32)


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp32(v) for v in tree]
    return tree.float()


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "minitron-4b"])
def test_prompt_logits_match_the_reference(fp32_program, name):
    from repro_torch.models.model import Model
    reg = tiny.registry(name)
    cell = tiny.cell(name=name)
    m = cell.config["model"]
    w = weights.make_weights(tiny.dense(), m, 7, "cpu")
    toks = torch.randint(1, m["vocab_size"], (2, 40),
                         generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([40, 23], dtype=torch.int32)
    got, _ = Model(reg).prefill_batched(_fp32(w), toks, lengths, max_len=64)
    want = {}

    def keep(i, lo, logits):
        want[i] = logits[-1]
    seqs = [toks[0].tolist(), toks[1, :23].tolist()]
    dense_gqa.logits_at(w, m, seqs, [range(39, 40), range(22, 23)], keep)
    for i in range(2):
        assert torch.allclose(got[i], want[i], atol=2e-4, rtol=0), \
            float((got[i] - want[i]).abs().max())


@pytest.mark.parametrize("impl", ["sdpa", "pallas", "paged_sdpa", "paged"])
def test_served_tokens_match_in_fp32(fp32_program, impl):
    """Cold and resumed prompt passes, the hand-off and decoding, through
    ``DisaggregatedCluster`` on the CPU (the kernels' plain versions)."""
    cell = tiny.cell("open", impl=impl)
    res = report.run_cell(cell, 3, 2.0, False, "cpu", time.perf_counter(),
                          registry=tiny.registry())
    kinds = {r.prefill for r in res["_run"].records.values()}
    assert {"cold", "resumed"} <= kinds
    n, toks = res["_compared"]
    assert n >= 2 and toks > 10
    assert res["checks"]["logit_gap"]["value"] < 1e-4


def test_control_lies_further_than_the_program():
    cell = tiny.cell("closed", limit=10.0)
    res = report.run_cell(cell, 4, 2.0, False, "cpu", time.perf_counter(),
                          registry=tiny.registry(), control=True)
    assert res["correct"]
    assert res["_control_gap"] > 3 * max(res["checks"]["logit_gap"]["value"],
                                         1e-3)


def test_sample_holds_the_longest_and_both_prefill_kinds():
    from harness.load import Request
    from harness.serve import Record

    class Served:
        def __init__(self, n):
            self.output = [1] * n

    recs = []
    for i in range(20):
        r = Record(Request(f"r{i}", 10 + i, 4, list), [1] * (10 + i), 0.0,
                   finished=1.0, served=Served(3))
        r.prefill = "cold" if i == 3 else "resumed" if i > 10 else ""
        recs.append(r)
    recs.append(Record(Request("open", 99, 4, list), [1] * 99, 0.0,
                       served=Served(1)))
    got = check.sample(recs, 4, 11)
    assert len(got) == 4
    assert got[0].req.rid == "r19"
    assert any(r.prefill == "cold" for r in got)
    assert any(r.prefill == "resumed" for r in got)
    assert all(r.finished is not None for r in got)
    assert [r.req.rid for r in check.sample(recs, 4, 11)] == \
        [r.req.rid for r in got]
