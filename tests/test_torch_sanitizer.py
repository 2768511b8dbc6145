"""The coherence sanitizer's engine checks, on the port's cluster.

The engine half of ``tests/test_sanitizer_violations.py``, run on a real
``repro_torch`` ``DisaggregatedCluster`` (reduced phi4-mini, on the CPU)
instead of a fake one: each test brings the cluster to a green state,
breaks exactly one invariant the way a plausible bug would, and asserts
that :class:`SanitizeError` names it.  A clean lifecycle, dense and paged,
with and without replica views, stays green, and the switch works as in
the reference: ``REPRO_SANITIZE=1`` attaches the sanitizer when
``sanitize`` is left at None, an explicit ``sanitize=False`` wins.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.sanitize import SanitizeError  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.disagg import (DisaggregatedCluster,  # noqa: E402
                                        ServeRequest)
from repro_torch.serving.engine import Slot  # noqa: E402

torch.set_num_threads(1)

BOGUS_HASH = 0xDEAD_BEEF_F00D


@pytest.fixture(scope="module")
def cpu_model():
    model = Model(get_reduced("phi4-mini-3.8b"))
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    return model, params


def _prompt(model, template, n=40):
    vocab = model.cfg.vocab_size
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


def _cluster(cpu_model, **kw):
    model, params = cpu_model
    kw.setdefault("num_decode", 2)
    kw.setdefault("sanitize", True)
    return DisaggregatedCluster(model, params, slots_per_worker=2,
                                max_len=96, adaptive=False, device="cpu",
                                **kw)


def _caches(cluster, n=40):
    return cluster.prefill.dummy_caches(n)


def _serve(cluster, model, n, max_new=3):
    for i in range(n):
        cluster.submit(ServeRequest(f"r{i}", _prompt(model, i % 3),
                                    max_new_tokens=max_new))
    return cluster.run_until_done()


# ------------------------------------------------------------ E1 / E2 -------


def test_reserve_into_held_slot_fires(cpu_model):
    cl = _cluster(cpu_model)
    dec = cl.decoders[0]
    dec.reserve(0, "a", prompt_len=40, max_new=4)
    with pytest.raises(SanitizeError, match="E1 slot reuse"):
        dec.reserve(0, "b", prompt_len=40, max_new=4)


def test_admit_over_other_requests_reservation_fires(cpu_model):
    cl = _cluster(cpu_model)
    dec = cl.decoders[0]
    dec.reserve(1, "a", prompt_len=40, max_new=4)
    with pytest.raises(SanitizeError, match="E1 slot reuse"):
        dec.admit(1, "b", _caches(cl), 0, 40, 4)


def test_leaked_active_slot_fires(cpu_model):
    cl = _cluster(cpu_model)
    dec = cl.decoders[1]
    dec.reserve(0, "a", prompt_len=40, max_new=4)
    dec.admit(0, "a", _caches(cl), 0, 40, 4)    # never entered cl.running
    with pytest.raises(SanitizeError, match="E2 slot accounting"):
        cl.sanitizer.check_all()


def test_running_request_with_empty_slot_fires(cpu_model):
    cl = _cluster(cpu_model)
    cl.running["r1"] = (None, 0, 1)             # slot 1 was never admitted
    with pytest.raises(SanitizeError, match="E2 slot accounting"):
        cl.step()


# ------------------------------------------------------- paged KV pages -----


def _paged_mid_run(cpu_model, n=2):
    """A paged cluster with ``n`` requests admitted on decoder 0 and one
    decode tick taken."""
    model, _ = cpu_model
    cl = _cluster(cpu_model, num_decode=1, decode_impl="paged")
    for i in range(n):
        cl.submit(ServeRequest(f"p{i}", _prompt(model, i), max_new_tokens=6))
    cl.step()
    assert len(cl.running) == n
    cl.sanitizer.check_all("mid-run")           # baseline is green
    return cl, cl.decoders[0]


def test_leaked_page_fires_partition(cpu_model):
    """A page that falls out of both the free list and every live table."""
    cl, dec = _paged_mid_run(cpu_model)
    dec.allocator._free.remove(dec.allocator._free[0])
    with pytest.raises(SanitizeError, match="P1 page-pool partition"):
        cl.step()


def test_double_owned_page_fires(cpu_model):
    """The same physical page mapped into two live slots' tables."""
    cl, dec = _paged_mid_run(cpu_model)
    dec.allocator.owned[1].append(dec.allocator.owned[0][0])
    with pytest.raises(SanitizeError, match="P2 page double-own"):
        cl.sanitizer.check_all()


def test_released_slot_holding_pages_fires(cpu_model):
    """A slot torn down without returning its pages to the allocator."""
    cl, dec = _paged_mid_run(cpu_model, n=1)
    rid = next(iter(cl.running))
    _req, _worker, slot = cl.running.pop(rid)
    dec.slots[slot] = Slot()                    # bypasses release()
    with pytest.raises(SanitizeError, match="P3 released-slot pages"):
        cl.step()


# ----------------------------------------------------- replica views --------


def _replicated(cpu_model):
    return _cluster(cpu_model, replicas=2, staleness_ticks=2)


def test_engine_missed_sync_cadence_fires(cpu_model):
    """The scheduler's view sync going nowhere is the engine-clock form of
    an R1 violation: the third tick past the last sync exceeds the
    two-tick cadence."""
    cl = _replicated(cpu_model)
    cl.control.sync_views = lambda now: None
    cl.step()
    cl.step()                                   # at the bound: still green
    with pytest.raises(SanitizeError, match="R1 replica staleness bound"):
        cl.step()


def test_engine_snapshot_mutation_fires(cpu_model):
    model, _ = cpu_model
    cl = _replicated(cpu_model)
    _serve(cl, model, 3)
    cl.control.sync_views(cl._now())            # fresh frozen copy
    cl.control.replica_views[1]._hash_claims[BOGUS_HASH] = (0,)
    with pytest.raises(SanitizeError, match="R2 replica snapshot integrity"):
        cl.sanitizer.check_all()


# ------------------------------------------------------ clean lifecycles ----


@pytest.mark.parametrize("kw", [
    pytest.param(dict(decode_impl="pallas"), id="dense"),
    pytest.param(dict(decode_impl="paged"), id="paged"),
    pytest.param(dict(decode_impl="paged", replicas=2, staleness_ticks=2),
                 id="paged-replicas"),
])
def test_clean_lifecycle_is_green(cpu_model, kw):
    """Backpressure, continuous batching, prefix resumes and (paged) page
    growth under the sanitizer, every tick checked; afterwards every pool
    is whole."""
    model, _ = cpu_model
    cl = _cluster(cpu_model, **kw)
    done = _serve(cl, model, 7, max_new=20)    # 40 + 20 crosses a page
    assert len(done) == 7 and not cl.running
    assert sum("tick" in e for e in cl.sanitizer.trace.events) > 5
    for dec in cl.decoders:
        assert dec.active_count == 0
        if dec.allocator is not None:
            assert dec.allocator.audit() == []
            assert dec.allocator.free_pages == dec.allocator.num_pages


# ---------------------------------------------------------- the switch ------


def test_environment_switch_attaches_the_sanitizer(cpu_model, monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    cl = _cluster(cpu_model, sanitize=None)
    assert cl.sanitizer is not None
    dec = cl.decoders[0]
    dec.reserve(0, "a", prompt_len=40, max_new=4)
    with pytest.raises(SanitizeError, match="E1 slot reuse"):
        dec.reserve(0, "b", prompt_len=40, max_new=4)
    # an explicit False wins over the environment: the engine's own guard
    # is all that is left
    off = _cluster(cpu_model, sanitize=False)
    assert off.sanitizer is None
    off.decoders[0].reserve(0, "a", prompt_len=40, max_new=4)
    with pytest.raises(RuntimeError, match="held by") as exc:
        off.decoders[0].reserve(0, "b", prompt_len=40, max_new=4)
    assert not isinstance(exc.value, SanitizeError)
