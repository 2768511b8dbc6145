"""The Mamba-2 decode step's kernel (``kernels/ssd_step``): its wrapper on
the CPU, and the kernel against the plain step on the card.

On the CPU: a CPU tensor takes the plain step, launches nothing and
writes the new state into the state it was given, as the kernel does; the
block's cached step gives the plain step's numbers in the cache's own
tensor; the wrapper's checks refuse what the kernel does not take; and
``Model._layer`` copies no state leaf onto itself while still copying a
fresh one, so a decode step on the CPU writes each SSM state once.

On the card (marked ``cuda``; they skip without one):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_ssd_step.py

the kernel at Nemotron-H's shape (B 32, H 256, G 8, N 256, P 64), Jamba's
(G 1, N 16, P 64) and the tiny configs' (N 4, P 16): the new state bit for
bit equal to the plain step's, written in place into the state it was
given; y within fp32 summation-order error of the plain step's.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import nemotron_h_47b  # noqa: E402
from repro_torch.kernels.ssd_step import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

torch.set_num_threads(1)


def _inputs(b, h, g, n, p, dtype, device="cpu", seed=0, row_pad=0):
    """The step's inputs as the cached block hands them over: x, B and C
    slices of one wider projection row (each row ``row_pad`` elements
    wider than x, B and C together), dt > 0 in fp32, A_log in ``dtype``
    and a random fp32 state."""
    gen = torch.Generator().manual_seed(seed)
    width = h * p + 2 * g * n + row_pad
    proj = torch.randn((b, width), generator=gen).to(dtype)
    x = proj[:, :h * p].view(b, h, p)
    b_in = proj[:, h * p:h * p + g * n].view(b, g, n)
    c_in = proj[:, h * p + g * n:h * p + 2 * g * n].view(b, g, n)
    dt = torch.rand((b, h), generator=gen) * 0.1 + 1e-3
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32)).to(dtype)
    state = torch.randn((b, h, n, p), generator=gen)
    return [t.to(device) for t in (x, dt, a_log, b_in, c_in, state)]


# ------------------------------------------------------------------- CPU ---

def test_a_cpu_tensor_takes_the_plain_step_and_launches_nothing():
    """The plain step's numbers, written into the state it was given and
    returned as that tensor: the kernel's contract."""
    args = _inputs(3, 4, 2, 4, 16, torch.bfloat16)
    want_y, want = ops.ssd_step_plain(*args)
    state = args[-1]
    before = ops.ssd_step.launches
    y, new = ops.ssd_step(*args)
    assert ops.ssd_step.launches == before == 0
    assert torch.equal(y, want_y) and torch.equal(new, want)
    assert new is state


def test_cached_block_step_on_the_cpu_is_the_plain_step(monkeypatch):
    """The tiny Nemotron-H's block, one cached step: the state it returns
    is the plain step's on the block's own inputs (captured), written into
    the cache's own tensor as on a card; the conv state is a new tensor,
    the cache's left as it was."""
    cfg = nemotron_h_47b.reduced()
    params = S.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, "cpu")
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    _, cache = S.mamba_block(params, x[:, :8], cfg)
    seen = []

    def spy(*args):
        seen.append((args[-1], [*args[:-1], args[-1].clone()]))
        return ops.ssd_step(*args)
    monkeypatch.setattr(S, "ssd_step", spy)
    conv = cache["conv"].clone()
    _, new = S.mamba_block(params, x[:, 8:], cfg, cache=cache)
    ((state, args),) = seen
    assert state is cache["ssm"] and new["ssm"] is cache["ssm"]
    assert torch.equal(new["ssm"], ops.ssd_step_plain(*args)[1])
    assert new["conv"] is not cache["conv"]
    assert torch.equal(cache["conv"], conv)
    assert ops.ssd_step.launches == 0


def _break(case, args):
    """``args`` altered as ``case`` names, each a thing the kernel does not
    take."""
    x, dt, a_log, b_in, c_in, state = args
    if case == "p":
        x = torch.zeros((x.shape[0], x.shape[1], 24), dtype=x.dtype)
        state = torch.zeros((*state.shape[:3], 24))
    elif case == "x_dtype":
        x = x.half()
    elif case == "bc_dtype":
        b_in = b_in.float()
    elif case == "state_dtype":
        state = state.to(torch.bfloat16)
    elif case == "dt_dtype":
        dt = dt.double()
    elif case == "a_log_dtype":
        a_log = a_log.half()
    elif case == "state_strided":
        state = state.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "x_strided":
        x = torch.zeros((x.shape[0], x.shape[1], 2 * x.shape[2]),
                        dtype=x.dtype)[:, :, ::2]
    elif case == "groups":
        b_in, c_in = (torch.zeros((b_in.shape[0], 3, b_in.shape[2]),
                                  dtype=b_in.dtype) for _ in range(2))
    elif case == "state_shape":
        state = state[:, :, :-1]
    elif case == "dt_shape":
        dt = dt[:, :-1]
    elif case == "state_misaligned":
        flat = torch.zeros(state.numel() + 1)
        state = flat[1:].view(state.shape)
    return x, dt, a_log, b_in, c_in, state


BROKEN = ["p", "x_dtype", "bc_dtype", "state_dtype", "dt_dtype",
          "a_log_dtype", "state_strided", "x_strided", "groups",
          "state_shape", "dt_shape", "state_misaligned"]


@pytest.mark.parametrize("case", BROKEN)
def test_the_wrapper_checks_refuse_what_the_kernel_does_not_take(case):
    args = _inputs(2, 4, 2, 8, 16, torch.bfloat16, row_pad=3)
    ops.check_inputs(*args)                  # the path's strided rows pass
    with pytest.raises(ValueError):
        ops.check_inputs(*_break(case, args))


@pytest.mark.parametrize("p", ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrapper_checks_take_every_built_width(p, dtype):
    ops.check_inputs(*_inputs(2, 8, 4, 16, p, dtype, row_pad=1))


def test_no_kernel_for_another_device():
    args = _inputs(2, 4, 2, 4, 16, torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.ssd_step(*args)


def test_the_dry_runs_meta_step_is_the_plain_step():
    """The cached block on ``meta`` tensors (the dry run's) takes the
    plain step, whose operations the cost counter counts, and launches
    nothing."""
    cfg = nemotron_h_47b.reduced()
    params = S.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, "cpu")
    params = {k: (v.to("meta") if isinstance(v, torch.Tensor)
                  else {n: t.to("meta") for n, t in v.items()})
              for k, v in params.items()}
    cache = {k: v.to("meta") for k, v in S.mamba_cache_init(cfg, 2,
                                                            "cpu").items()}
    x = torch.empty((2, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    y, new = S.mamba_block(params, x, cfg, cache=cache)
    assert y.is_meta and new["ssm"].shape == cache["ssm"].shape
    assert new["ssm"] is not cache["ssm"] and ops.ssd_step.launches == 0


class _Copies(torch.overrides.TorchFunctionMode):
    """Records the destination of every ``Tensor.copy_``."""

    def __init__(self):
        super().__init__()
        self.into = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.copy_:
            self.into.append(args[0])
        return func(*args, **(kwargs or {}))


def test_layer_copies_no_leaf_onto_itself_and_copies_a_fresh_one(
        monkeypatch):
    """``Model._layer`` after a recurrent block: a leaf the block returned
    as the cache's own tensor (written in place, as the kernel does) is
    not copied, a fresh leaf (the conv state) is, and both end in the
    cache."""
    model = Model(nemotron_h_47b.reduced("M"))
    params = model.init(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")
    caches = model.cache_init(2, 4, "cpu")
    bc = model._layer_cache(caches, 0)
    fresh_conv = torch.full_like(bc["conv"], 3.0)

    def block(lp, x, cfg, cache=None):
        cache["ssm"].add_(1.0)                 # in place, as on a card
        return torch.zeros_like(x), {"ssm": cache["ssm"], "conv": fresh_conv}
    monkeypatch.setitem(M.RECURRENT, "mamba",
                        M.RECURRENT["mamba"]._replace(block=block))
    x = torch.zeros((2, 1, model.cfg.d_model))
    with _Copies() as spy:
        model._layer(params["layers"][0], model.layer_descs[0], x, bc,
                     None, None, "sdpa", None, None)
    assert len(spy.into) == 1 and spy.into[0] is bc["conv"]
    assert torch.equal(caches["conv"][0], fresh_conv)
    assert torch.all(caches["ssm"] == 1.0)


def _shares(t, base):
    return t.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()


def test_cpu_decode_writes_each_state_once_with_the_plain_numbers(
        monkeypatch):
    """A tiny Nemotron-H decode step on the CPU: the only copies into the
    cache's SSM states are the step's own, one a Mamba layer (no copy of a
    state onto itself after the block), and the logits and caches are bit
    for bit those of a step whose block returns a fresh state, which
    ``Model._layer`` copies in."""
    model = Model(nemotron_h_47b.reduced("M-*M-M"))
    gen = torch.Generator().manual_seed(2)
    params = model.init(gen, torch.float32, "cpu")
    caches = model.cache_init(2, 16, "cpu")
    caches["ssm"].normal_(generator=gen)
    fresh = {k: v.clone() for k, v in caches.items()}
    tokens = torch.tensor([[3], [8]])
    with _Copies() as spy:
        got, new = model.decode(params, caches, tokens, 5)
    into_ssm = [t for t in spy.into if _shares(t, caches["ssm"])]
    assert len(into_ssm) == model.mixers.count("mamba") == 3
    monkeypatch.setattr(S, "ssd_step", ops.ssd_step_plain)
    want, fresh = model.decode(params, fresh, tokens, 5)
    assert torch.equal(got, want)
    assert all(torch.equal(new[k], fresh[k]) for k in fresh)


# ------------------------------------------------------------------ card ---

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


SHAPES = {                   # (B, H, G, N, P)
    "nemotron_h": (32, 256, 8, 256, 64),
    "jamba": (4, 128, 1, 16, 64),
    "tiny": (4, 4, 2, 4, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_card_kernel_state_bit_equal_and_in_place(card, shape, dtype):
    """The new state equals the plain step's bit for bit (the kernel rounds
    each product and sum of the update as the plain step does, in its
    order) and lands in the state tensor it was given.  y sums N products
    in another order than the plain step's batched product: each of the
    two sums is within (N - 1)·eps·sum|C·h'| of the exact one, so they lie
    within twice that of each other."""
    b, h, g, n, p = SHAPES[shape]
    args = _inputs(b, h, g, n, p, dtype, device=card, seed=7, row_pad=5)
    want_y, want = ops.ssd_step_plain(*args)
    state = args[-1]
    ptr = state.data_ptr()
    before = ops.ssd_step.launches
    y, got = ops.ssd_step(*args)
    torch.cuda.synchronize()
    assert ops.ssd_step.launches == before + 1
    assert got is state and got.data_ptr() == ptr
    assert torch.equal(got, want)
    c = args[4].float().reshape(b, g, 1, n, 1)
    mag = (c.abs() * want.abs().view(b, g, h // g, n, p)).sum(3)
    bound = 2 * n * torch.finfo(torch.float32).eps * mag.reshape(b, h, p)
    assert y.dtype == torch.float32 and y.shape == (b, h, p)
    assert torch.all((y - want_y).abs() <= bound)


@pytest.mark.cuda
def test_card_kernel_repeats_the_same_bits(card):
    """Two runs from the same state give the same state and y, bit for
    bit (the readout's sum has a fixed order)."""
    args = _inputs(*SHAPES["nemotron_h"], torch.bfloat16, device=card,
                   seed=3)
    start = args[-1].clone()
    y1, s1 = ops.ssd_step(*args)
    s1 = s1.clone()
    args[-1].copy_(start)
    y2, s2 = ops.ssd_step(*args)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_card_wrapper_raises_on_a_strided_state(card):
    args = _inputs(*SHAPES["tiny"], torch.bfloat16, device=card)
    args[-1] = args[-1].transpose(2, 3).contiguous().transpose(2, 3)
    before = ops.ssd_step.launches
    with pytest.raises(ValueError, match="state not contiguous"):
        ops.ssd_step(*args)
    assert ops.ssd_step.launches == before


@pytest.mark.cuda
def test_card_model_decode_step_writes_the_cache_in_place(card):
    """The tiny Nemotron-H's decode step on the card: each Mamba layer's
    state is updated where the cache holds it, the first to the plain
    pass's bits, and the kernel launches once a Mamba layer; the logits
    stay within 1% of the plain pass's spread."""
    # K1's widths: 16 query heads over 2 of 128
    model = Model(nemotron_h_47b.reduced(num_heads=16, num_kv_heads=2,
                                         head_dim=128))
    params = model.init(torch.Generator(device=card).manual_seed(0),
                        torch.bfloat16, card)
    caches = model.cache_init(4, 32, card)
    caches["ssm"].normal_()
    plain = {k: v.clone() for k, v in caches.items()}
    tokens = torch.tensor([[1], [5], [7], [9]], device=card)
    lengths = torch.tensor([3, 4, 5, 6], dtype=torch.int32, device=card)
    ptr = caches["ssm"].data_ptr()
    before = ops.ssd_step.launches
    got, new = model.decode(params, caches, tokens, lengths,
                            decode_impl="pallas")
    assert ops.ssd_step.launches - before == model.mixers.count("mamba")
    assert new["ssm"].data_ptr() == ptr
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "ssd_step", ops.ssd_step_plain)
        want, plain = model.decode(params, plain, tokens, lengths,
                                   decode_impl="pallas")
    # the first Mamba layer's inputs are the plain pass's, so its state is
    # too, bit for bit; later layers see the readout's last-bit
    # differences, carried through bf16 activations
    assert torch.equal(new["ssm"][0], plain["ssm"][0])
    torch.testing.assert_close(new["ssm"], plain["ssm"], atol=2e-2,
                               rtol=2e-2)
    spread = want.max(-1).values - want.min(-1).values
    assert torch.all((got - want).abs().max(-1).values < 1e-2 * spread)


def test_shapes_cover_the_ports_mamba_configs():
    """The card tests' shapes are the ones the port runs: Nemotron-H's
    published Mamba layer, Jamba's and the tiny test configs'."""
    from repro_torch.configs import get_config
    for name, cfg in (("nemotron_h", nemotron_h_47b.CONFIG),
                      ("jamba", get_config("jamba-v0.1-52b"))):
        s = cfg.ssm
        h = s.expand * cfg.d_model // s.head_dim
        _, hh, g, n, p = SHAPES[name]
        assert (hh, g, n, p) == (h, S._groups(s), s.d_state, s.head_dim)
    tiny = nemotron_h_47b.reduced().ssm
    assert (SHAPES["tiny"][3], SHAPES["tiny"][4]) == (tiny.d_state,
                                                      tiny.head_dim)
    assert all(shape[4] in ops.HEAD_DIMS for shape in SHAPES.values())
    assert all(shape[1] % shape[2] == 0 for shape in SHAPES.values())
