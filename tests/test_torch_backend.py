"""Backend parity, three ways: the port's engine backend, the JAX engine
backend and the analytic simulator, on the four ``parity-*`` scenarios.

Under the parity protocol (explicit template traces, zero jitter, frozen
load views, serialized engine runs) a τ=0 routing decision depends only on
the indexer's insert history, so all three backends must agree
decision for decision (EXPERIMENTS.md, "backend parity").  Each scenario
runs in its ``fast`` length on the reduced phi4-mini; the port gets the
JAX model's weights through ``bridge.params_from_numpy`` and runs on the
CPU.  Engine modes: ``"pallas"`` and ``"paged_sdpa"`` on both engine
backends (the reference test's ``fast`` and ``paged`` modes), and
``"paged"`` on the port (K2's plain version on the CPU), held to the JAX
``"paged_sdpa"`` run.

Exactly equal: the decisions, the overlap vectors (rounded to 12 places),
the regime (from, to) sequences, the final regime, the blocks each decoder
moved, ``prefill_stats`` but ``wall_s`` (a wall time) and the runner's
materialized request specs.  After each port run every page allocator
audits clean with all pages free.  Token streams are not compared across
frameworks: argmax flips on near-ties (EXPERIMENTS.md).

The runner's warm-up runs each pass shape once; it must leave the
engines' accounting as it found it (prefill stats and prefix cache, every
slot, the page table and allocator, and a paged pool but its trash page).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import scenarios as jax_scenarios  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import scenarios  # noqa: E402
from repro_torch.serving.engine import DecodeEngine, PrefillEngine  # noqa: E402

torch.set_num_threads(1)

PARITY = scenarios.parity_scenarios()
# port decode impl -> the JAX engine run it is held to
MODES = {"pallas": "pallas", "paged_sdpa": "paged_sdpa",
         "paged": "paged_sdpa"}


@pytest.fixture(scope="module")
def models():
    """The reduced phi4-mini as the reference parity test builds it, and
    the same weights in the port."""
    jm = build_model(jax_reduced("phi4-mini-3.8b"))
    jp = jm.init(jax.random.PRNGKey(0), jnp.bfloat16)
    tcfg = get_reduced("phi4-mini-3.8b")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_numpy(tree, tcfg, dtype=torch.bfloat16, device="cpu")
    return (jm, jp), (Model(tcfg), tp)


_JAX_RUNS = {}


def _jax_run(models, name, impl):
    """The JAX engine backend's record of one scenario, run once per
    (scenario, impl) for every port mode held to it."""
    if (name, impl) not in _JAX_RUNS:
        (jm, jp), _ = models
        runner = jax_scenarios.build_backend(
            name, backend="engine", seed=0, fast=True, model=jm, params=jp,
            decode_impl=impl)
        _JAX_RUNS[name, impl] = (_specs(runner),
                                 _engine_record(runner.run()))
    return _JAX_RUNS[name, impl]


def _specs(runner):
    return [(s.template, s.tokens, s.max_new) for s in runner.specs]


def _engine_record(res):
    reqs = sorted(res.requests, key=lambda r: int(r.request_id[1:]))
    stats = dict(res.prefill_stats)
    stats.pop("wall_s")
    return dict(
        decisions=[(i, w, round(ov, 12)) for i, w, ov in res.decisions],
        vectors=[tuple(round(x, 12) for x in r.overlaps) for r in reqs],
        regimes=[(a, b) for _, a, b in res.regime_transitions],
        final_regime=res.final_regime,
        transferred_blocks=list(res.transferred_blocks),
        prefill_stats=stats)


def _analytic_record(sim):
    res = sim.run()
    reqs = sorted(res.completed, key=lambda r: r.rid)
    return dict(
        decisions=[(r.rid, r.decode_worker, round(r.overlap, 12))
                   for r in reqs],
        vectors=[tuple(round(x, 12) for x in r.overlaps_all) for r in reqs],
        regimes=[(a, b) for _, a, b in sim.detector.transitions],
        final_regime=int(sim.detector.regime))


@pytest.mark.parametrize("impl", list(MODES))
@pytest.mark.parametrize("name", PARITY)
def test_three_backends_agree(name, impl, models):
    _, (tm, tp) = models
    runner = scenarios.build_backend(name, backend="engine", seed=0,
                                     fast=True, model=tm, params=tp,
                                     decode_impl=impl)
    assert runner.device == torch.device("cpu")
    port = _engine_record(runner.run())
    for dec in runner.cluster.decoders:
        if dec.allocator is not None:
            assert dec.allocator.audit() == []
            assert dec.allocator.free_pages == dec.allocator.num_pages
    jax_specs, ref = _jax_run(models, name, MODES[impl])
    assert _specs(runner) == jax_specs
    assert port == ref
    analytic = _analytic_record(
        scenarios.build_backend(name, backend="analytic", seed=0, fast=True))
    assert len(analytic["decisions"]) == len(runner.specs)
    for key, want in analytic.items():
        assert port[key] == want, key
    # the port's copy of the simulator is the reference's, event for event
    assert analytic == _analytic_record(jax_scenarios.build_backend(
        name, backend="analytic", seed=0, fast=True))


def _toks(model, template, n):
    vocab = model.cfg.vocab_size
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


def _counting(monkeypatch, model, names):
    calls = {n: 0 for n in names}
    for n in names:
        inner = getattr(model, n)

        def counted(*a, n=n, inner=inner, **kw):
            calls[n] += 1
            return inner(*a, **kw)
        monkeypatch.setattr(model, n, counted)
    return calls


def test_prefill_warmup_runs_every_pass_and_leaves_the_engine(models,
                                                              monkeypatch):
    _, (tm, tp) = models
    eng = PrefillEngine(tm, tp, max_len=96, device="cpu")
    eng.prefill(_toks(tm, 0, 48))
    stats, cache = eng.stats.as_dict(), list(eng._cache)
    calls = _counting(monkeypatch, tm, ("prefill", "prefill_batched",
                                        "prefill_resume"))
    eng.warmup([40, 48], suffix_lengths=[1, 16, 32, 60],
               batch_sizes=[1, 2, 3])
    # a cold pass per length; batched per (width 1/2/4, padded 48); a
    # resume per (width, suffix below the longest prompt)
    assert calls == {"prefill": 2, "prefill_batched": 3,
                     "prefill_resume": 9}
    assert eng.stats.as_dict() == stats
    assert list(eng._cache) == cache


@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_decode_warmup_leaves_slots_table_and_pool(models, monkeypatch,
                                                   impl):
    _, (tm, tp) = models
    pre = PrefillEngine(tm, tp, max_len=96, device="cpu")
    dec = DecodeEngine(tm, tp, num_slots=2, max_len=96, decode_impl=impl,
                       device="cpu")
    if dec.paged:
        # a live slot: the paged warm-up writes only the trash page
        toks = _toks(tm, 1, 40)
        logits, caches = pre.prefill(toks)
        dec.admit(1, "live", caches, int(np.argmax(logits)), len(toks), 8)
        dec.reserve(0, "held", prompt_len=20, max_new=4)
    slots = copy.deepcopy(dec.slots)
    state = (dec.tokens.copy(), dec.transferred_blocks, list(dec._resident))
    if dec.paged:
        state += (dec.page_table.copy(), copy.deepcopy(dec.allocator.owned),
                  dict(dec.allocator.reserved), dec.allocator.free_list())
        pool = {n: t[:, 1:].clone() for n, t in dec.caches.items()}
    calls = _counting(monkeypatch, tm, ("decode",))
    dec.warmup(table_widths=dec.width_ladder() if dec.paged else None)
    assert calls["decode"] == (len(dec.width_ladder()) if dec.paged else 1)
    assert dec.slots == slots
    after = (dec.tokens.copy(), dec.transferred_blocks, list(dec._resident))
    if dec.paged:
        after += (dec.page_table.copy(), dec.allocator.owned,
                  dict(dec.allocator.reserved), dec.allocator.free_list())
        assert all(torch.equal(dec.caches[n][:, 1:], pool[n]) for n in pool)
    for a, b in zip(after, state):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
