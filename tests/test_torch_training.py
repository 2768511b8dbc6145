"""The port's training path against the JAX package's, on the same inputs.

Model: the reduced phi4-mini (4 layers, d 128, H 4, K 2, hd 32, vocab 512)
with the reference's fp32 weights carried across by ``repro_torch.bridge``;
batches from both data pipelines (bit-identical by construction).

Bounds, each with its reason:
* ``train_loss``: 2e-3 absolute, with and without the flash branch (JAX:
  Pallas in interpret mode; port: the plain version on the CPU).  Both
  sides compute in bf16 and round at different places; the reference's own
  flash and plain losses differ by 9.3e-4 at this size.
* gradients: relative L2 error per leaf < 0.05 against ``jax.grad``; the
  bf16 roundings above reach the gradients amplified by the backward pass
  (the worst leaf measures 0.02).
* the optimizer: 1e-6 of each leaf's largest value; both run the same fp32
  operations, in another order only in the global-norm sum.
* grad accumulation, remat and restart: the reference's own bounds
  (tests/test_training.py:25-73), restart bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.data import (DataConfig, batch_for_model,  # noqa: E402
                                       make_batch)
from repro_torch.training.train_loop import (TrainConfig, Trainer,  # noqa: E402
                                             make_train_step)

torch.set_num_threads(1)

SHAPE = ShapeConfig("t", 64, 8, "train")
ARCH = "phi4-mini-3.8b"


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def models():
    """Reference and port model on the same fp32 weights, and one B=2,
    S=128 batch on each side."""
    jm = build_model(jax_reduced(ARCH))
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    cfg = get_reduced(ARCH)
    tm = Model(cfg)
    tp = params_from_numpy(_np(jp), cfg, dtype=torch.float32, device="cpu")
    dc = DataConfig(cfg.vocab_size, 128, 2)
    jb = jax_data.make_batch(jax_data.DataConfig(cfg.vocab_size, 128, 2), 0)
    return jm, jp, tm, tp, jb, make_batch(dc, 0, device="cpu")


def _fresh(tp):
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else
                _fresh(v)) if not isinstance(v, list) else
            [_fresh(x) for x in v] for k, v in tp.items()}


# ----------------------------------------------------------------- data ---

@pytest.mark.parametrize("step,host", [(0, 0), (7, 0), (3, 1)])
def test_make_batch_bit_identical(step, host):
    jc = jax_data.DataConfig(512, 96, 8, seed=5)
    tc = DataConfig(512, 96, 8, seed=5)
    ref = np.asarray(jax_data.make_batch(jc, step, host, 2)["tokens"])
    port = make_batch(tc, step, host, 2, device="cpu")["tokens"]
    assert port.dtype == torch.int32
    assert np.array_equal(port.numpy(), ref)


def test_batch_for_model_dense_and_stubs():
    """The dense batch, and the VLM's patches and the encoder-decoder's
    frames (the frontend stubs), bit-identical to the reference's."""
    cfg = get_reduced(ARCH)
    ref = jax_data.batch_for_model(jax_reduced(ARCH), SHAPE, 4, seed=3)
    port = batch_for_model(cfg, SHAPE, 4, seed=3, device="cpu")
    assert np.array_equal(port["tokens"].numpy(), np.asarray(ref["tokens"]))
    for name, stub in (("phi-3-vision-4.2b", "patches"),
                       ("seamless-m4t-medium", "frames")):
        ref = jax_data.batch_for_model(jax_reduced(name), SHAPE, 0)
        port = batch_for_model(get_reduced(name), SHAPE, 0, device="cpu")
        assert set(port) == set(ref) == {"tokens", stub}
        assert np.array_equal(port["tokens"].numpy(),
                              np.asarray(ref["tokens"]))
        assert port[stub].dtype == torch.bfloat16
        assert np.array_equal(port[stub].view(torch.int16).numpy(),
                              np.asarray(ref[stub]).view(np.int16))


# ----------------------------------------------------------------- loss ---

@pytest.mark.parametrize("use_flash", [False, True])
def test_train_loss_matches_reference(models, use_flash):
    jm, jp, tm, tp, jb, tb = models
    jm.use_flash = tm.use_flash = use_flash
    try:
        ref = float(jax.jit(lambda p, b: jm.train_loss(p, b))(jp, jb))
        before = fops.flash_attention.launches
        with torch.no_grad():
            port = tm.train_loss(tp, tb)
    finally:
        jm.use_flash = tm.use_flash = False
    assert port.dtype == torch.float32 and port.dim() == 0
    assert abs(float(port) - ref) < 2e-3
    assert fops.flash_attention.launches == before   # plain on the CPU


def test_flash_loss_has_no_gradient(models):
    _, _, tm, tp, _, tb = models
    params = _fresh(tp)
    for p in opt_lib.leaves(params):
        p.requires_grad_(True)
    tm.use_flash = True
    try:
        with pytest.raises(RuntimeError, match="no gradient"):
            tm.train_loss(params, tb)
    finally:
        tm.use_flash = False


@pytest.mark.parametrize("remat", [False, True])
def test_grads_match_reference(models, remat):
    jm, jp, tm, tp, jb, tb = models
    ref = jax.jit(jax.grad(lambda p: jm.train_loss(p, jb, remat=remat)))(jp)
    ref = params_from_numpy(_np(ref), tm.cfg, dtype=torch.float32,
                            device="cpu")
    params = _fresh(tp)
    leaves = list(opt_lib.leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(tm.train_loss(params, tb, remat=remat),
                                leaves)
    for r, g in zip(opt_lib.leaves(ref), grads):
        assert g.shape == r.shape
        assert float((g - r).norm() / r.norm()) < 0.05


# ------------------------------------------------------------ optimizer ---

def test_optimizer_update_matches_reference(models):
    """One AdamW step from a reference state that already has moments (its
    first update), on the same fp32 params and grads."""
    jm, jp, tm, _, _, _ = models
    rng = np.random.default_rng(0)
    grads_np = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), _np(jp))
    cfg = jax_opt.OptimizerConfig(warmup_steps=2, total_steps=10)
    update = jax.jit(lambda p, g, s: jax_opt.update(cfg, p, g, s))
    state = jax_opt.init(jp)
    jp1, state, _ = update(jp, grads_np, state)
    grads2 = jax.tree.map(lambda g: 0.5 * g, grads_np)
    jp2, state2, jstats = update(jp1, grads2, state)

    tp = params_from_numpy(_np(jp1), tm.cfg, dtype=torch.float32,
                           device="cpu")
    topt = opt_state_from_numpy(_np(state), tm.cfg, device="cpu")
    assert int(topt["step"]) == 1
    tg = params_from_numpy(_np(grads2), tm.cfg, dtype=torch.float32,
                           device="cpu")
    tp, topt, stats = opt_lib.update(cfg, tp, tg, topt)
    assert int(topt["step"]) == 2
    assert float(stats["grad_norm"]) == pytest.approx(
        float(jstats["grad_norm"]), rel=1e-6)
    assert float(stats["lr"]) == pytest.approx(float(jstats["lr"]), rel=1e-6)
    for port, ref in ((tp, jp2), (topt["m"], state2["m"]),
                      (topt["v"], state2["v"])):
        ref = params_from_numpy(_np(ref), tm.cfg, dtype=torch.float32,
                                device="cpu")
        for a, b in zip(opt_lib.leaves(port), opt_lib.leaves(ref)):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = opt_lib.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                  min_lr_ratio=0.1)
    ref = float(jax_opt.schedule(jax_opt.OptimizerConfig(
        lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
        jnp.int32(step)))
    assert float(opt_lib.schedule(cfg, step)) == pytest.approx(ref, rel=1e-6)


def test_optimizer_clips_gradients():
    cfg = opt_lib.OptimizerConfig(clip_norm=1.0, lr=1.0, weight_decay=0.0,
                                  warmup_steps=0)
    params = {"w": torch.zeros((4,))}
    opt = opt_lib.init(params)
    new_p, _, stats = opt_lib.update(cfg, params,
                                     {"w": torch.full((4,), 1e6)}, opt)
    assert float(stats["grad_norm"]) > 1e5
    assert float(new_p["w"].abs().max()) < 10.0   # clip bounded the step


# ------------------------------------------------------------ train loop ---

def test_grad_accum_equivalence():
    """grad_accum=2 matches grad_accum=1 on the same global batch
    (tests/test_training.py:25-43)."""
    cfg = get_reduced(ARCH)
    model = Model(cfg)
    batch = make_batch(DataConfig(cfg.vocab_size, 32, 8), 0, device="cpu")
    results = []
    for accum in (1, 2):
        params = model.init(torch.Generator().manual_seed(0), torch.float32,
                            device="cpu")
        state = {"params": params, "opt": opt_lib.init(params)}
        step = make_train_step(model, TrainConfig(grad_accum=accum,
                                                  remat=False))
        results.append(step(state, batch))
    (s1, st1), (s2, st2) = results
    assert float(st1["loss"]) == pytest.approx(float(st2["loss"]), rel=1e-3)
    d = max(float((a - b).detach().abs().max())
            for a, b in zip(opt_lib.leaves(s1["params"]),
                            opt_lib.leaves(s2["params"])))
    assert d < 1e-4


def test_remat_matches_no_remat(models):
    _, _, tm, tp, _, tb = models
    grads = []
    for remat in (True, False):
        params = _fresh(tp)
        leaves = list(opt_lib.leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        grads.append(torch.autograd.grad(
            tm.train_loss(params, tb, remat=remat), leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3)


def test_loss_decreases():
    tr = Trainer(get_reduced("stablelm-3b"), SHAPE, TrainConfig(remat=False),
                 device="cpu")
    hist = tr.run(25)
    assert set(hist[0]) == {"loss", "grad_norm", "lr", "step", "step_time"}
    assert np.mean([h["loss"] for h in hist[-5:]]) < \
        np.mean([h["loss"] for h in hist[:5]]) - 0.15


def test_checkpoint_restart_bit_exact(tmp_path):
    """6 steps straight vs 3 + checkpoint + restore + 3: identical
    (tests/test_training.py:58-73)."""
    cfg = get_reduced("stablelm-3b")
    tr_a = Trainer(cfg, SHAPE, TrainConfig(remat=False), device="cpu")
    tr_a.run(6)
    ck = str(tmp_path / "ck")
    tr_b = Trainer(cfg, SHAPE, TrainConfig(remat=False, ckpt_dir=ck,
                                           ckpt_every=3), device="cpu")
    tr_b.run(3)
    tr_c = Trainer(cfg, SHAPE, TrainConfig(remat=False, ckpt_dir=ck),
                   device="cpu")
    assert tr_c.step == 3
    assert int(tr_c.state["opt"]["step"]) == 3
    tr_c.run(3)
    for a, b in zip(opt_lib.leaves(tr_a.state),
                    opt_lib.leaves(tr_c.state)):
        assert torch.equal(a, b)


def test_trainer_with_flash_raises():
    tr = Trainer(get_reduced(ARCH), ShapeConfig("t", 128, 2, "train"),
                 device="cpu")
    tr.model.use_flash = True
    with pytest.raises(RuntimeError, match="no gradient"):
        tr.run(1)
    assert tr.step == 0 and tr.history == []


# ----------------------------------------------------------- checkpoint ---

def test_checkpoint_layout_reads_in_the_reference(tmp_path):
    """The port's files are the reference's layout: the reference restores
    them into its own tree of the same structure, and keeps 3 steps."""
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3),
                       "layers": [{"b": torch.ones(2, dtype=torch.bfloat16)},
                                  {"b": torch.full((2,), 3.0)}]},
            "step": torch.tensor(4, dtype=torch.int32)}
    for step in (1, 2, 3, 4):
        ckpt_lib.save(str(tmp_path), step, tree)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003", "step_00000004"]
    assert ckpt_lib.latest_step(str(tmp_path)) == \
        jax_ckpt.latest_step(str(tmp_path)) == 4
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                        {"params": {"w": tree["params"]["w"],
                                    "layers": [{"b": torch.zeros(2)},
                                               {"b": torch.zeros(2)}]},
                         "step": torch.zeros(())},
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    ref, step = jax_ckpt.restore(str(tmp_path), like)
    assert step == 4
    assert np.array_equal(np.asarray(ref["params"]["w"]),
                          tree["params"]["w"].numpy())
    assert np.array_equal(np.asarray(ref["params"]["layers"][0]["b"]),
                          np.ones(2, np.float32))
    back, _ = ckpt_lib.restore(str(tmp_path), tree)
    assert back["params"]["layers"][0]["b"].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(opt_lib.leaves(back),
                                                 opt_lib.leaves(tree)))


def test_async_checkpointer_snapshots(tmp_path):
    w = torch.zeros(3)
    saver = ckpt_lib.AsyncCheckpointer(str(tmp_path))
    saver.save(1, {"w": w})
    w.add_(5.0)                    # training goes on in place
    saver.save(2, {"w": w})
    saver.close()
    one, _ = ckpt_lib.restore(str(tmp_path), {"w": w}, step=1)
    two, _ = ckpt_lib.restore(str(tmp_path), {"w": w}, step=2)
    assert torch.equal(one["w"], torch.zeros(3))
    assert torch.equal(two["w"], torch.full((3,), 5.0))
