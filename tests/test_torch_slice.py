"""The port's disaggregated cluster against the JAX engine backend.

One JAX ``DisaggregatedCluster`` and one port cluster, both on the reduced
phi4-mini with G = 3 query heads per KV head and the same (bridged)
weights, serve the same 10 requests: three templates whose prompts share
prefixes, so prefix-cache resumes run.  Requests are submitted one at a
time (``run_until_done`` after each) and, in a second case, all at once
(batched prefill, both decoders loaded), with ``adaptive=False`` and
``cache_ttl=None``, so routing does not read the wall clock.

Exactly equal: the (worker, overlap) decision sequence, the order in which
requests finish, each request's overlap vector and output length,
``PrefillStats`` (all but ``wall_s``, a wall time), the blocks each decoder
moved, and, after the paged run, every allocator's audit with all pages
free.  Generated tokens are not
compared: argmax flips on near-ties across frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import disagg as jax_disagg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import disagg  # noqa: E402

torch.set_num_threads(1)

G3 = dict(num_heads=6, num_kv_heads=2)
CLUSTER = dict(num_decode=2, slots_per_worker=2, max_len=96, adaptive=False,
               cache_ttl=None)


@pytest.fixture(scope="module")
def both():
    jcfg = jax_reduced("phi4-mini-3.8b", **G3)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(1), jnp.bfloat16)
    tcfg = get_reduced("phi4-mini-3.8b", **G3)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_numpy(tree, tcfg, dtype=torch.bfloat16, device="cpu")
    return (jm, jp), (Model(tcfg), tp), tcfg.vocab_size


def _requests(vocab):
    """10 (id, prompt, max_new): prompts built like the engine backend's
    (engine_backend.py), three templates, ragged lengths."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(10):
        template = int(rng.integers(0, 3))
        n = int(rng.integers(30, 60))
        toks = [(template * 1_000_003 + 7 * j) % vocab for j in range(n)]
        out.append((f"r{i}", toks, int(rng.integers(2, 5))))
    return out


def _serve(mod, model, params, impl, requests, serial, **kw):
    cluster = mod.DisaggregatedCluster(model, params, decode_impl=impl,
                                       **CLUSTER, **kw)
    for rid, toks, max_new in requests:
        cluster.submit(mod.ServeRequest(rid, list(toks),
                                        max_new_tokens=max_new))
        if serial:
            cluster.run_until_done()
    cluster.run_until_done()
    return cluster


def _record(cluster):
    stats = cluster.prefill.stats.as_dict()
    stats.pop("wall_s")
    done = {r.request_id: r for r in cluster.done}
    return dict(
        decisions=[(d.worker, d.overlap) for d in cluster.control.decision_log],
        finished=[r.request_id for r in cluster.done],
        overlaps={k: r.overlaps for k, r in done.items()},
        out_len={k: len(r.output) for k, r in done.items()},
        stats=stats,
        moved=[d.transferred_blocks for d in cluster.decoders])


@pytest.mark.parametrize("serial", [True, False], ids=["serial", "flood"])
@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_cluster_matches_jax_engine_backend(both, impl, serial):
    (jm, jp), (tm, tp), vocab = both
    requests = _requests(vocab)
    ref = _serve(jax_disagg, jm, jp, impl, requests, serial)
    port = _serve(disagg, tm, tp, impl, requests, serial, device="cpu")
    want, got = _record(ref), _record(port)
    assert got == want
    assert got["stats"]["reused_blocks"] > 0          # resumes ran
    assert got["out_len"] == {rid: m + 1 for rid, _, m in requests}
    if impl == "paged":
        for dec in port.decoders:
            assert dec.allocator.audit() == []
            assert dec.allocator.free_pages == dec.allocator.num_pages
