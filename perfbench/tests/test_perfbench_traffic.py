"""The traffic generators: a seed repeats exactly, seeds differ in order
and tokens but not in the work they ask for."""
import json
from collections import Counter

import pytest

from harness import sampling
from harness.load import ClosedLoop, OpenLoop, build_traffic
from harness.spec import BENCH_DIR

MIXES = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json"))
BIG = 2 ** 31 + 7


def _mix(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def _requests(t):
    if isinstance(t, OpenLoop):
        return t.requests
    return [r for q in t.queues for r in q]


def _digest(t, n=8):
    reqs = _requests(t)
    return ([(r.rid, r.prompt_len, r.max_new, r.due, r.client, r.group)
             for r in reqs],
            [r.make_tokens() for r in reqs[:n]])


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_repeats_exactly(mix):
    a = build_traffic(_mix(mix), BIG, 20.0, 1000)
    b = build_traffic(_mix(mix), BIG, 20.0, 1000)
    assert _digest(a) == _digest(b)


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_differ(mix):
    a = _digest(build_traffic(_mix(mix), 1, 20.0, 1000))
    b = _digest(build_traffic(_mix(mix), 2, 20.0, 1000))
    assert a[1] != b[1]
    assert [x[1:] for x in a[0]] != [x[1:] for x in b[0]]


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_ask_for_the_same_work(mix):
    """The same multiset of prompt and of output lengths for any seed; an
    open loop sends its lead-in and its window each the same number of
    requests, with the same output lengths, system prompts and prompt
    tokens in all (a system prompt's user turn is the seed's to pair)."""
    m = _mix(mix)
    seconds = 30.0
    a, b = (_requests(build_traffic(m, s, seconds, 1000)) for s in (3, BIG))
    if m["generator"] != "open_loop":
        for key in (lambda r: r.max_new, lambda r: r.prompt_len):
            assert Counter(map(key, a)) == Counter(map(key, b))
        return
    lead = m["lead_in_s"]
    assert len(a) == len(b) == round(m["rate_per_s"] * lead) + round(
        m["rate_per_s"] * seconds)
    for part in (lambda r: r.due < lead,
                 lambda r: lead <= r.due < lead + seconds):
        pa, pb = [r for r in a if part(r)], [r for r in b if part(r)]
        assert pa and len(pa) == len(pb)
        for key in (lambda r: r.max_new, lambda r: r.group):
            assert Counter(map(key, pa)) == Counter(map(key, pb))
        assert sum(r.prompt_len for r in pa) == sum(r.prompt_len for r in pb)


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_inside_the_mix(mix):
    m = _mix(mix)
    t = build_traffic(m, 5, 20.0, 1000)
    reqs = _requests(t)
    assert reqs
    for r in reqs:
        toks = r.make_tokens() if r is reqs[0] else None
        if toks is not None:
            assert len(toks) == r.prompt_len
            assert all(0 < x < 1000 for x in toks)
        if m["generator"] == "open_loop":
            lo, hi = m["output_len"]
            assert lo <= r.max_new <= hi
            assert r.prompt_len <= m["system_len"][1] + m["user_len"][1]
            assert 0 <= r.due < m["lead_in_s"] + 20.0
        else:
            assert m["prompt_len"][0] <= r.prompt_len <= m["prompt_len"][1]
            assert m["output_len"][0] <= r.max_new <= m["output_len"][1]
        assert r.prompt_len + r.max_new + 1 <= m["deployment"]["max_len"]


def test_open_loop_shares_system_prompts():
    m = dict(_mix("chat-prefix"), rate_per_s=20.0)
    t = build_traffic(m, 9, 10.0, 5000)
    by_group = {}
    for r in t.requests[:40]:
        by_group.setdefault(r.group, []).append(r.make_tokens())
    shared = [v for v in by_group.values() if len(v) > 1]
    assert shared
    for prompts in shared:
        n = min(len(p) for p in prompts)
        lo = m["system_len"][0]
        assert all(p[:lo] == prompts[0][:lo] for p in prompts)
        assert len({tuple(p) for p in prompts}) == len(prompts)
        assert n > lo


def test_open_loop_popularity_is_zipf():
    counts = sampling.zipf_counts(1000, 16, 1.1)
    assert sum(counts) == 1000
    assert counts == sorted(counts, reverse=True)
    assert counts[0] / counts[1] == pytest.approx(2 ** 1.1, rel=0.05)


def test_quantile_sizes():
    assert sampling.log_uniform(4, 100, 1600) == [141, 283, 566, 1131]
    gaps = sampling.exponential_gaps(10000, 4.0)
    assert sum(gaps) / len(gaps) == pytest.approx(0.25, rel=0.01)
