"""The port's model under a sharding policy, and its grouped MoE dispatch.

A 4-process ``gloo`` world on the CPU builds a (2, 2) ("data", "model")
mesh, distributes each model's params by ``param_shardings`` and runs it
under ``use_policy``: params and caches are DTensors, the shard sites
redistribute the activations, and the decode and flash kernels' wrappers
(their plain versions here) take each rank's local shards.  Every pass is
held against the same model unsharded in the same process, in fp32
(``COMPUTE_DTYPE`` and the KV cache dtype set to fp32, so that no bf16
rounding turns a last-bit difference of the reduction order into an ulp):
max|d| <= 1e-5 x max|unsharded| for each output and gradient, where
about 1e-6 is expected.  The world runs once for the module; its rank 0
writes what the tests read.

* Reduced phi4-mini: a prompt pass, a 4-step forced decode walk under
  ``"pallas"`` (int and (B,) positions in turn), a ``"paged"`` step over
  pools adopted from the prompt pass, ``train_loss`` and its gradients,
  and the loss with ``use_flash``.
* Reduced xlstm's ``train_loss`` gradients, every leaf, with fp64 params
  and compute (see ``B_I_ABS``).
* Reduced qwen3-moe with one KV head (not divisible by the model axis, so
  the decode kernel gathers whole heads), reduced jamba (Mamba's and the
  MoE's sites) and reduced xlstm (the mLSTM's and sLSTM's): a prompt pass
  and a 4-step walk.  A data axis of 2
  gives the MoE two dispatch groups, so the unsharded side runs under a
  stub-mesh policy of the same shape, and the sharded side takes its
  expert ids call by call (a near-tie could flip a choice across the two
  reduction orders); its own choices must agree for >= 95%.

In one process: with no policy ``shard`` returns its input and the MoE
takes its one-group path bit for bit; the 2-group dispatch equals the JAX
reference's with its ``current_policy`` patched to a stub mesh of data
axis 2 (its ``shard`` stays the identity, no policy being installed),
the port taking the reference's expert ids as tests/test_torch_moe_model.py
does.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.sharding import ShardingPolicy, shard, use_policy  # noqa: E402

WORLD = 4
TIMEOUT = 300
REL = 1e-5
PROMPT, STEPS, MAX_LEN = 16, 4, 24
ARCHS = {"phi4": ("phi4-mini-3.8b", {}),
         "qwen3": ("qwen3-moe-30b-a3b", dict(num_heads=8, num_kv_heads=1)),
         "jamba": ("jamba-v0.1-52b", {}),
         "xlstm": ("xlstm-125m", {})}


class StubMesh:
    def __init__(self, shape, axes=("data", "model")):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = axes
        self.mesh = self.devices
        self.mesh_dim_names = axes


def run_world(fn, tmp, timeout=TIMEOUT):
    """``fn(rank, tmp)`` in WORLD spawned processes; fails (never hangs)
    when one raises or the world outlives ``timeout`` seconds."""
    ctx = mp.start_processes(fn, args=(str(tmp),), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD}-process world ran past {timeout} s")


def init_world(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=WORLD, rank=rank)


# ------------------------------------------------- the sharded world ----

def _rel(got, ref):
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    got, ref = got.detach(), ref.detach()
    return float((got - ref).abs().max() / ref.abs().max())


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


class _Routing:
    """Records the unsharded pass's expert ids, call by call, and makes the
    sharded pass take them: each rank takes the rows of its own groups."""

    def __init__(self, mesh):
        self.mesh, self.calls, self.n, self.agree = mesh, [], 0, []
        self.route = moe_lib._route

    def record(self, params, xn, k):
        out = self.route(params, xn, k)
        self.calls.append(out[2])
        return out

    def force(self, params, xn, k):
        logits, _, own = self.route(params, xn, k)
        ref = self.calls[self.n]
        self.n += 1
        start = 0
        if own.shape[0] < ref.shape[0]:      # the groups are split by data
            start = self.mesh.get_coordinate()[0] * own.shape[0]
        idx = ref[start:start + own.shape[0]]
        self.agree.append(float(torch.all(
            torch.sort(own, -1).values == torch.sort(idx, -1).values,
            -1).float().mean()))
        return logits, torch.softmax(torch.gather(logits, 1, idx), -1), idx


def _walk(model, params, caches, impl):
    logits = []
    for i in range(STEPS):
        tok = torch.tensor([[3 + i], [7 + i]])
        cur = PROMPT + i if i % 2 == 0 else torch.tensor([PROMPT + i] * 2)
        out, caches = model.decode(params, caches, tok, cur, decode_impl=impl)
        logits.append(out)
    return logits


def _named_leaves(node, keys=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _named_leaves(v, keys + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _named_leaves(v, keys + (i,))
    else:
        yield "/".join(map(str, keys)), node


def _grad_errors(model, policy, tokens):
    """Each leaf's gradient of ``train_loss`` under the policy against the
    unsharded one, both with fp64 params and compute: {leaf: [max|d|,
    max|unsharded|, its norm]}."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.sharding.specs import device_put, param_shardings
    params = model.init(torch.Generator().manual_seed(0), torch.float64,
                        "cpu")
    sp = device_put(params, param_shardings(params, policy))
    L.COMPUTE_DTYPE = ssm_lib.COMPUTE_DTYPE = torch.float64
    names = [n for n, _ in _named_leaves(params)]
    for tree in (params, sp):
        for t in _leaves(tree):
            t.requires_grad_(True)
    loss = model.train_loss(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(_leaves(params)))
    with use_policy(policy):
        sloss = model.train_loss(sp, {"tokens": tokens})
        sgrads = torch.autograd.grad(sloss, list(_leaves(sp)))
    out = {}
    for name, got, ref in zip(names, sgrads, grads):
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        out[name] = [float((got - ref).abs().max()), float(ref.abs().max()),
                     float(ref.norm())]
    L.COMPUTE_DTYPE = ssm_lib.COMPUTE_DTYPE = torch.float32
    return out


def _sharded_runs(rank, mesh):
    from repro_torch.models import layers as L
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.serving.engine import adopt_prefill_pages
    from repro_torch.sharding.specs import device_put, param_shardings
    for mod in (L, moe_lib, ssm_lib):
        mod.COMPUTE_DTYPE = torch.float32
    model_lib.KV_DTYPE = torch.float32
    calls = {"decode": [], "flash": [], "paged": []}
    for name, key in (("decode_attention", "decode"),
                      ("flash_attention", "flash"),
                      ("paged_attention", "paged")):
        inner = getattr(L, name)

        def spy(*args, _inner=inner, _key=key, **kw):
            calls[_key].append([[type(a).__name__, list(a.shape)]
                                for a in args])
            return _inner(*args, **kw)
        setattr(L, name, spy)

    policy = ShardingPolicy(mesh)
    stub = ShardingPolicy(StubMesh((2, 2)))
    tokens = torch.arange(2 * PROMPT).reshape(2, PROMPT) * 7 % 512
    out = {}
    for arch, (name, heads) in ARCHS.items():
        model = Model(get_reduced(name, **heads))
        params = model.init(torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
        sp = device_put(params, param_shardings(params, policy))
        res = out[arch] = {}
        routing = _Routing(mesh)
        moe_lib._route = routing.record
        with use_policy(stub):
            ref_logits, ref_caches = model.prefill(
                params, {"tokens": tokens}, max_len=MAX_LEN)
            ref_walk = _walk(model, params, ref_caches, "pallas")
        moe_lib._route = routing.force
        with use_policy(policy):
            logits, caches = model.prefill(sp, {"tokens": tokens},
                                           max_len=MAX_LEN)
            res["prefill"] = _rel(logits, ref_logits)
            res["cache_placements"] = {
                n: [f"Shard({p.dim})" if p.is_shard() else type(p).__name__
                    for p in t.placements] for n, t in caches.items()}
            calls["decode"].clear()
            walk = _walk(model, sp, caches, "pallas")
            res["walk_pallas"] = [_rel(a, b) for a, b in zip(walk, ref_walk)]
            res["decode_calls"] = calls["decode"][:1]
        moe_lib._route = routing.route
        res["agree"] = min(routing.agree, default=1.0)
        if arch == "xlstm":
            res["grads"] = _grad_errors(model, policy, tokens)
        if arch != "phi4":
            continue
        table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        paged = []
        for p, pol in ((params, stub), (sp, policy)):
            with use_policy(pol):
                _, dense = model.prefill(p, {"tokens": tokens},
                                         max_len=MAX_LEN)
                pool = model.paged_cache_init(8, 16, "cpu")
                for r in range(2):
                    adopt_prefill_pages(pool, dense, r, table[r], block=16)
                calls["paged"].clear()
                paged.append(model.decode(p, pool, tokens[:, :1],
                                          torch.tensor([PROMPT] * 2),
                                          decode_impl="paged",
                                          page_table=table)[0])
        with use_policy(policy):
            res["paged"] = _rel(paged[1], paged[0])
        res["paged_calls"] = calls["paged"][:1]
        for tree in (params, sp):
            for t in _leaves(tree):
                t.requires_grad_(True)
        loss = model.train_loss(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, list(_leaves(params)))
        with use_policy(policy):
            sloss = model.train_loss(sp, {"tokens": tokens})
            sgrads = torch.autograd.grad(sloss, list(_leaves(sp)))
            res["loss"] = _rel(sloss, loss)
            res["grads"] = max(_rel(a, b) for a, b in zip(sgrads, grads))
            res["grad_types"] = sorted({type(g).__name__ for g in sgrads})
        long = torch.arange(2 * 128).reshape(2, 128) * 5 % 512
        model.use_flash = True
        with torch.no_grad():
            floss = model.train_loss(params, {"tokens": long})
            calls["flash"].clear()
            with use_policy(policy):
                res["flash_loss"] = _rel(
                    model.train_loss(sp, {"tokens": long}), floss)
        res["flash_calls"] = calls["flash"][:1]
    return out


def _sharded_worker(rank, tmp):
    init_world(rank, tmp)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh((2, 2), device_type="cpu")
        out = _sharded_runs(rank, mesh)
        if rank == 0:
            with open(f"{tmp}/results.json", "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_world")
    run_world(_sharded_worker, tmp)
    with open(tmp / "results.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_prompt_pass_equals_unsharded(sharded, arch):
    res = sharded[arch]
    assert res["prefill"] <= REL
    # batch over data, KV heads over model where they divide it (phi4-mini
    # and jamba: 2 of them), else head_dim (qwen3-moe here: 1); a recurrent
    # state by the generic rule, the mLSTM's (P, B, H, hd, hd) on its
    # largest feature dim, the first head_dim
    place = res["cache_placements"]
    if arch == "xlstm":
        assert place["mlstm_C"] == ["Shard(1)", "Shard(3)"]
    else:
        assert place["k"] == (["Shard(1)", "Shard(3)"] if arch != "qwen3"
                              else ["Shard(1)", "Shard(4)"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_decode_walk_equals_unsharded(sharded, arch):
    res = sharded[arch]
    assert len(res["walk_pallas"]) == STEPS
    assert max(res["walk_pallas"]) <= REL


def test_decode_kernel_takes_local_shards(sharded):
    """K1's wrapper sees plain tensors: one slot of two (batch over data),
    and on phi4-mini half the query and KV heads (model), on qwen3-moe,
    whose one KV head does not divide the model axis, every head."""
    cfg = get_reduced("phi4-mini-3.8b")
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    (q, k, v, lengths), = sharded["phi4"]["decode_calls"]
    assert {q[0], k[0], v[0], lengths[0]} == {"Tensor"}
    assert q[1] == [1, h // 2, hd] and k[1] == [1, MAX_LEN, kh // 2, hd]
    assert lengths[1] == [1]
    (q, k, _, _), = sharded["qwen3"]["decode_calls"]
    assert q[1] == [1, 8, k[1][3]] and k[1][2] == 1


def test_sharded_paged_decode_equals_unsharded(sharded):
    """A paged step over page pools adopted from the prompt pass's caches:
    K2's wrapper sees each rank's slot and heads, and the whole pool."""
    res = sharded["phi4"]
    assert res["paged"] <= REL
    cfg = get_reduced("phi4-mini-3.8b")
    (q, k, _, table, lengths), = res["paged_calls"]
    assert {q[0], k[0], table[0], lengths[0]} == {"Tensor"}
    assert q[1][:2] == [1, cfg.num_heads // 2]
    assert k[1] == [9, 16, cfg.num_kv_heads // 2, cfg.resolved_head_dim]
    assert table[1] == [1, 2] and lengths[1] == [1]


def test_sharded_loss_and_grads_equal_unsharded(sharded):
    res = sharded["phi4"]
    assert res["loss"] <= REL and res["grads"] <= REL
    assert res["grad_types"] == ["DTensor"]


def test_flash_kernel_takes_local_shards(sharded):
    res = sharded["phi4"]
    assert res["flash_loss"] <= REL
    cfg = get_reduced("phi4-mini-3.8b")
    (q, k, v), = res["flash_calls"]
    assert {q[0], k[0], v[0]} == {"Tensor"}
    assert q[1] == [1, 128, cfg.num_heads // 2, cfg.resolved_head_dim]


# xLSTM's gradients are compared with fp64 params and compute: in fp32,
# rounding alone moves its gate leaves by up to 1.8e-5 x their max (the
# same model with its einsums rounded from fp64 instead), past REL; in fp64
# the sharded gap is ~1e-6 (the gates stay fp32 on both sides).  The
# sLSTM's input-gate bias gets a gradient of ~1e-9, the residue of terms
# that cancel, which no relative bound can hold: it is held to B_I_ABS x
# the largest leaf's gradient norm (~130) instead, where a fault would
# show at the other gate biases' ~1e-2
B_I_ABS = 1e-8


def test_sharded_xlstm_grads_equal_unsharded(sharded):
    grads = sharded["xlstm"]["grads"]
    gates = [n for n in grads if n.endswith("/b_i")]
    assert gates and len(grads) > len(gates)
    for name, (diff, top, _) in grads.items():
        if name not in gates:
            assert diff <= REL * top, name
    largest = max(norm for _, _, norm in grads.values())
    for name in gates:
        assert grads[name][0] <= B_I_ABS * largest, name


@pytest.mark.parametrize("arch", ["qwen3", "jamba"])
def test_sharded_moe_takes_its_own_expert_choices(sharded, arch):
    assert sharded[arch]["agree"] >= 0.95


# ------------------------------------------------ in one process ----

def test_shard_returns_its_input_without_a_policy():
    x = torch.ones(2, 3, 4)
    assert shard(x, "batch", "seq", "act_embed") is x


def _moe_case(factor=None):
    cfg = get_reduced("qwen3-moe-30b-a3b", num_heads=8, num_kv_heads=1)
    if factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
    return cfg


def test_one_group_moe_path_is_unchanged():
    """No policy, and a policy whose data axis is 1, both take the
    one-group path: the same output, aux loss and load, bit for bit."""
    cfg = _moe_case(0.5)
    g = torch.Generator().manual_seed(1)
    params = moe_lib.moe_init(g, cfg, torch.bfloat16, "cpu")
    x = torch.randn(3, 11, cfg.d_model, generator=g).to(torch.bfloat16)
    assert moe_lib._dispatch_groups(33) == 1
    y, aux = moe_lib.moe(params, x, cfg)
    with use_policy(ShardingPolicy(StubMesh((1, 4)))):
        assert moe_lib._dispatch_groups(33) == 1
        y1, aux1 = moe_lib.moe(params, x, cfg)
    assert torch.equal(y, y1)
    assert all(torch.equal(aux[n], aux1[n]) for n in aux)
    with use_policy(ShardingPolicy(StubMesh((4, 1)))):
        assert [moe_lib._dispatch_groups(n) for n in (32, 30, 33)] == [4, 2, 1]


@pytest.fixture
def jax_two_groups(monkeypatch):
    """The JAX reference with ``current_policy`` giving a stub mesh of data
    axis 2 (``_dispatch_groups`` then gives 2 groups), and the port under a
    stub policy of the same shape."""
    jax = pytest.importorskip("jax")
    import repro.sharding as jax_sharding
    from repro.sharding.policy import ShardingPolicy as JaxPolicy
    stub = StubMesh((2, 2))
    monkeypatch.setattr(jax_sharding, "current_policy",
                        lambda: JaxPolicy(stub))
    with use_policy(ShardingPolicy(stub)):
        yield jax


def _ref_ids(jax, params, x, cfg):
    """The reference's own top-k expert ids of an eager MoE call (its
    router ops, moe.py:84-88)."""
    import jax.numpy as jnp
    from repro.models.layers import rmsnorm as jax_rmsnorm
    xn = jax_rmsnorm(params["norm"], x, cfg.norm_eps).reshape(-1,
                                                               x.shape[-1])
    logits = jnp.einsum("td,de->te", xn, params["wr"].astype(jnp.bfloat16))
    return np.asarray(jax.lax.top_k(logits.astype(jnp.float32),
                                    cfg.moe.top_k)[1])


def _forced(monkeypatch, ids):
    """The port's MoE calls take ``ids`` in call order."""
    route = moe_lib._route
    queue = list(ids)

    def forced(params, xn, k):
        logits, _, _ = route(params, xn, k)
        idx = torch.from_numpy(queue.pop(0).astype(np.int64))
        return logits, torch.softmax(torch.gather(logits, 1, idx), -1), idx
    monkeypatch.setattr(moe_lib, "_route", forced)


@pytest.mark.parametrize("factor", [None, 0.05], ids=["default", "tight"])
def test_two_group_moe_matches_the_reference(jax_two_groups, monkeypatch,
                                             factor):
    """``moe()`` with 2 dispatch groups against the reference's with 2,
    within tests/test_torch_moe.py's bounds; at the tight capacity the
    groups drop other rows than one group would."""
    jax = jax_two_groups
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.models import moe as jax_moe
    from repro_torch.bridge import tree_from_numpy
    cfg = _moe_case(factor)
    jcfg = jax_reduced("qwen3-moe-30b-a3b", num_heads=8, num_kv_heads=1)
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=factor))
    jp = jax_moe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    tp = tree_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jp), dtype=torch.bfloat16, device="cpu")
    x = np.random.default_rng(4).standard_normal((4, 24, cfg.d_model),
                                                 np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert jax_moe._dispatch_groups(96) == moe_lib._dispatch_groups(96) == 2
    ids = _ref_ids(jax, jp, jx, jcfg)
    y, aux = jax_moe.moe(jp, jx, jcfg)
    _forced(monkeypatch, [ids] * 2)
    ty, taux = moe_lib.moe(tp, tx, cfg)
    torch.testing.assert_close(ty.float(), torch.from_numpy(
        np.asarray(y, np.float32)), atol=2e-2, rtol=2e-2)
    assert np.array_equal(taux["expert_load"].numpy(),
                          np.asarray(aux["expert_load"]))
    np.testing.assert_allclose(taux["moe_aux_loss"].item(),
                               float(aux["moe_aux_loss"]), rtol=1e-5)
    if factor is not None:
        with use_policy(None):
            one, _ = moe_lib.moe(tp, tx, cfg)
        assert not torch.equal(one, ty)


def test_two_group_prefill_matches_the_reference(jax_two_groups,
                                                 monkeypatch):
    """A prompt pass of reduced qwen3-moe, 2 groups on both sides, within
    the repo's logits bound (0.02 x the reference's spread)."""
    jax = jax_two_groups
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.models import moe as jax_moe
    from repro.models.layers import rmsnorm as jax_rmsnorm
    from repro.models.model import Model as JaxModel
    from repro_torch.bridge import params_from_numpy
    jcfg = jax_reduced("qwen3-moe-30b-a3b", num_heads=8, num_kv_heads=1)
    cfg = _moe_case()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.bfloat16)
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), cfg, dtype=torch.bfloat16,
                           device="cpu")
    ids = []
    ref_moe = jax_moe.moe

    def recorded(params, x, c):
        xn = jax_rmsnorm(params["norm"], x, c.norm_eps).reshape(-1,
                                                                x.shape[-1])
        logits = jnp.einsum("td,de->te", xn,
                            params["wr"].astype(jnp.bfloat16))
        idx = jax.lax.top_k(logits.astype(jnp.float32), c.moe.top_k)[1]
        jax.debug.callback(lambda v: ids.append(np.asarray(v)), idx,
                           ordered=True)
        return ref_moe(params, x, c)
    monkeypatch.setattr(jax_moe, "moe", recorded)
    toks = np.array([[(r * 1_000_003 + 7 * i) % 512 for i in range(40)]
                     for r in range(2)], np.int32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=48)
    jax.effects_barrier()
    assert len(ids) == cfg.num_layers
    _forced(monkeypatch, ids)
    tl, _ = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                               max_len=48)
    ref = np.asarray(jl, np.float32)
    for row_p, row_r in zip(tl.numpy(), ref):
        assert np.abs(row_p - row_r).max() < 0.02 * (row_r.max() - row_r.min())
