"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip on a machine without a
CUDA device (the kernels' arithmetic is tested on the CPU through the plain
versions in tests/test_torch_kernels.py).  On the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a machine with
only the port need not have.)

Tolerances: 2e-5 in fp32, 2e-2 in bf16 (atol and rtol), the repo's kernel
bounds; the model walk holds logits to 0.02 x the logit spread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.models import Model  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd", [(1, 64), (3, 128), (4, 32), (8, 128),
                                  (8, 64), (4, 128), (1, 96), (3, 96)])
def test_decode_kernel_matches_plain(dev, g, hd, dtype):
    rng = np.random.default_rng(g * hd)
    b, t, kh = 4, 700, 2
    q = _t(rng, (b, kh * g, hd), dtype, dev)
    k, v = (_t(rng, (b, t, kh, hd), dtype, dev) for _ in range(2))
    lengths = torch.tensor([0, 1, 257, t], dtype=torch.int32, device=dev)
    before = dops.decode_attention.launches
    out = dops.decode_attention(q, k, v, lengths)
    assert dops.decode_attention.launches == before + 1
    torch.testing.assert_close(out, dops.decode_attention_plain(
        q, k, v, lengths), atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.all(out[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["split", "empty"])
def test_decode_kernel_split_edges_and_repeated_calls(dev, edge, dtype):
    """Lengths at the kernel's split boundaries and the full cache, or an
    empty slot beside full windows and a length past T (clamped); two
    calls in a row on the same combine counters give the same bits."""
    rng = np.random.default_rng(5 if edge == "split" else 6)
    b, t, kh, g, hd = 4, 1088, 8, 3, 128
    split = dops.split_plan(b, t, kh, g, hd).chunk
    lens = ([split - 1, split, split + 1, t] if edge == "split"
            else [0, t, t + 9, 2 * split + 1])
    q = _t(rng, (b, kh * g, hd), dtype, dev)
    k, v = (_t(rng, (b, t, kh, hd), dtype, dev) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = dops.decode_attention.launches
    first = dops.decode_attention(q, k, v, lengths)
    again = dops.decode_attention(q, k, v, lengths)
    assert dops.decode_attention.launches == before + 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first, dops.decode_attention_plain(
        q, k, v, lengths), atol=TOL[dtype], rtol=TOL[dtype])
    if edge == "empty":
        assert torch.all(first[0] == 0)


# (B, S, T, G, hd) at the fp32 flash body's task edges: S*G one short of,
# at and one past a 64-row block; one row block over keys one short of, at
# and one past a 64-key chunk and two; one query over T - S = 37
F32_EDGES = {
    "rows": [(1, 63, 63, 1, 64), (1, 64, 101, 1, 64), (2, 65, 65, 1, 32)],
    "keys": [(1, 16, t, 4, hd) for t in (63, 64, 65, 127, 128, 129)
             for hd in (64, 128)],
    "s1": [(2, 1, 38, g, hd) for g in (1, 8) for hd in (96, 128)],
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("edge", list(F32_EDGES))
def test_flash_f32_split_edges_and_repeated_calls(dev, edge, causal):
    """K3's fp32 body where its tasks end: each case launched twice on the
    same inputs (bit-equal: no state between calls) and held to the plain
    version; the launch splits keys wherever its plan says so."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (b, s, t, g, hd) in enumerate(F32_EDGES[edge]):
        rng = np.random.default_rng(100 * i + t)
        q = _t(rng, (b, s, 2 * g, hd), torch.float32, dev)
        k, v = (_t(rng, (b, t, 2, hd), torch.float32, dev) for _ in range(2))
        plan = fops.split_plan(b, s, t, 2, g, hd, causal, sms)
        if edge == "keys":
            assert plan.chunks == -(-t // plan.chunk) and plan.chunk == 64
        before = (fops.flash_attention.launches,
                  fops.flash_attention.launches_f32)
        first = fops.flash_attention(q, k, v, causal=causal)
        again = fops.flash_attention(q, k, v, causal=causal)
        assert (fops.flash_attention.launches,
                fops.flash_attention.launches_f32) == (before[0] + 2,
                                                       before[1] + 2)
        assert torch.equal(first, again)
        torch.testing.assert_close(first, fops.flash_attention_plain(
            q, k, v, causal=causal), atol=2e-5, rtol=2e-5)


def test_flash_f32_one_chunk_against_many(dev):
    """bench_kernels.py's shape through the plan's split (8 chunks of 64
    keys) and in one chunk of all 512 keys (``flash_attention_f32_launch``
    with one slot a row block and no scratch): both within 2e-5 of the
    plain version.  A bf16 launch does not count as an fp32 one, and the
    bf16 entry refuses fp32."""
    rng = np.random.default_rng(23)
    q = _t(rng, (1, 512, 8, 64), torch.float32, dev)
    k, v = (_t(rng, (1, 512, 2, 64), torch.float32, dev) for _ in range(2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fops.split_plan(1, 512, 512, 2, 4, 64, True, sms).chunks > 1
    many = fops.flash_attention(q, k, v)
    one = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    _, fn = fops._f32_launcher()
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), one.data_ptr(), None,
              1, 512, 512, 2, 4, 64, 1, 512, 1, stream) == 0
    want = fops.flash_attention_plain(q, k, v)
    for got in (many, one):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    _, bf16_fn = fops._launcher()
    assert bf16_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), one.data_ptr(),
                   1, 512, 512, 2, 4, 64, 1, 0, stream) == -1
    before = fops.flash_attention.launches_f32
    fops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert fops.flash_attention.launches_f32 == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [1, 4, 68])
def test_paged_kernel_matches_plain(dev, w, dtype):
    rng = np.random.default_rng(w)
    b, n, kh, g, hd = 4, 4 * 68 + 1, 8, 3, 128
    q = _t(rng, (b, kh * g, hd), dtype, dev)
    kp, vp = (_t(rng, (n, 16, kh, hd), dtype, dev) for _ in range(2))
    table = torch.from_numpy(rng.integers(0, n, (b, w)).astype(np.int32))
    table[1] = table[2]
    table[3, -1] = n + 4                        # clamped into the pool
    table = table.to(dev)
    lengths = torch.tensor([0, 16 * w - 3, 16 * w, 16 * w + 5],
                           dtype=torch.int32, device=dev)
    out = pops.paged_attention(q, kp, vp, table, lengths)
    torch.testing.assert_close(out, pops.paged_attention_plain(
        q, kp, vp, table, lengths), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["split", "empty"])
def test_paged_kernel_split_edges_and_repeated_calls(dev, edge, dtype):
    """Lengths at the kernel's split boundaries and the full window, or an
    empty slot beside full windows; two calls in a row on the same combine
    counters give the same bits."""
    rng = np.random.default_rng(7 if edge == "split" else 8)
    b, n, w, kh, g, hd = 4, 4 * 68 + 1, 68, 8, 3, 128
    split = pops.split_plan(b, w, 16, kh, g, hd).chunk
    lens = ([split - 1, split, split + 1, 16 * w] if edge == "split"
            else [0, 16 * w, 16 * w + 9, 2 * split + 1])
    q = _t(rng, (b, kh * g, hd), dtype, dev)
    kp, vp = (_t(rng, (n, 16, kh, hd), dtype, dev) for _ in range(2))
    table = torch.from_numpy(rng.integers(1, n, (b, w)).astype(np.int32))
    table = table.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = pops.paged_attention.launches
    first = pops.paged_attention(q, kp, vp, table, lengths)
    again = pops.paged_attention(q, kp, vp, table, lengths)
    assert pops.paged_attention.launches == before + 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first, pops.paged_attention_plain(
        q, kp, vp, table, lengths), atol=TOL[dtype], rtol=TOL[dtype])
    if edge == "empty":
        assert torch.all(first[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["w1", "w4", "w68", "split", "empty"])
def test_paged_kernel_at_qwen3_shape(dev, case, dtype):
    """Qwen3-30B-A3B's attention shape, K = 4 KV heads of G = 8 query heads
    at hd = 64: page-table widths 1, 4 and 68, then lengths at the split
    boundaries, or an empty slot beside full windows, at W = 68; two calls
    in a row give the same bits."""
    rng = np.random.default_rng(len(case) * 10 + (dtype == torch.float32))
    b, n, kh, g, hd = 4, 4 * 68 + 1, 4, 8, 64
    w = {"w1": 1, "w4": 4}.get(case, 68)
    split = pops.split_plan(b, w, 16, kh, g, hd).chunk
    lens = {"split": [split - 1, split, split + 1, 16 * w],
            "empty": [0, 16 * w, 16 * w + 9, 2 * split + 1]}.get(
                case, [0, 16 * w - 3, 16 * w, 16 * w + 5])
    q = _t(rng, (b, kh * g, hd), dtype, dev)
    kp, vp = (_t(rng, (n, 16, kh, hd), dtype, dev) for _ in range(2))
    table = torch.from_numpy(rng.integers(1, n, (b, w)).astype(np.int32))
    table = table.to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    first = pops.paged_attention(q, kp, vp, table, lengths)
    again = pops.paged_attention(q, kp, vp, table, lengths)
    assert torch.equal(first, again)
    torch.testing.assert_close(first, pops.paged_attention_plain(
        q, kp, vp, table, lengths), atol=TOL[dtype], rtol=TOL[dtype])
    if lens[0] == 0:
        assert torch.all(first[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["split", "empty"])
@pytest.mark.parametrize("kernel", ["dense", "paged"])
def test_decode_kernels_at_phi3_vision_shape(dev, kernel, edge, dtype):
    """Phi-3-vision's attention shape, 32 KV heads of G = 1 at hd = 96 (a
    head_dim that does not divide the kernels' 256 column pairs), T = 1664
    (W = 104 pages): lengths at the split boundaries, or an empty slot
    beside full windows; two calls in a row give the same bits."""
    rng = np.random.default_rng(96 + (edge == "split") * 2
                                + (dtype == torch.float32))
    b, t, kh, g, hd = 4, 1664, 32, 1, 96
    w = t // 16
    q = _t(rng, (b, kh * g, hd), dtype, dev)
    if kernel == "dense":
        split = dops.split_plan(b, t, kh, g, hd).chunk
        kv = [_t(rng, (b, t, kh, hd), dtype, dev) for _ in range(2)]
        call, plain = dops.decode_attention, dops.decode_attention_plain
    else:
        split = pops.split_plan(b, w, 16, kh, g, hd).chunk
        n = b * w + 1
        kv = [_t(rng, (n, 16, kh, hd), dtype, dev) for _ in range(2)]
        kv.append(torch.from_numpy(rng.integers(1, n, (b, w))
                                   .astype(np.int32)).to(dev))
        call, plain = pops.paged_attention, pops.paged_attention_plain
    lens = ([split - 1, split, split + 1, t] if edge == "split"
            else [0, t, t + 9, 2 * split + 1])
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = call.launches
    first = call(q, *kv, lengths)
    again = call(q, *kv, lengths)
    assert call.launches == before + 2
    assert torch.equal(first, again)
    torch.testing.assert_close(first, plain(q, *kv, lengths),
                               atol=TOL[dtype], rtol=TOL[dtype])
    if edge == "empty":
        assert torch.all(first[0] == 0)


def test_wrapper_raises_on_strided_input(dev):
    q = torch.zeros((2, 6, 64), device=dev)
    k = torch.zeros((2, 64, 2, 128), device=dev)[..., ::2]
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        dops.decode_attention(q, k, k, lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g,hd,s,extra", [(1, 32, 64, 0), (3, 128, 200, 37),
                                          (2, 96, 128, 0), (8, 64, 77, 37)])
def test_flash_kernel_matches_plain(dev, g, hd, s, extra, causal, dtype):
    rng = np.random.default_rng(g * hd + s)
    b, kh = 2, 2
    q = _t(rng, (b, s, kh * g, hd), dtype, dev)
    k, v = (_t(rng, (b, s + extra, kh, hd), dtype, dev) for _ in range(2))
    before = fops.flash_attention.launches
    out = fops.flash_attention(q, k, v, causal=causal)
    assert fops.flash_attention.launches == before + 1
    torch.testing.assert_close(out, fops.flash_attention_plain(
        q, k, v, causal=causal), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 96])
@pytest.mark.parametrize("g,s,extra", [(3, 43, 0), (5, 51, 37), (6, 22, 0),
                                       (7, 19, 5), (3, 1, 37), (7, 1, 37)])
def test_flash_kernel_row_block_edges(dev, g, s, extra, hd, dtype):
    """S*G off a multiple of the kernel's 128-row blocks (G = 3, 5, 6, 7),
    and a single query over an offset cache."""
    rng = np.random.default_rng(g * 1000 + s * 10 + hd)
    b, kh = 2, 2
    q = _t(rng, (b, s, kh * g, hd), dtype, dev)
    k, v = (_t(rng, (b, s + extra, kh, hd), dtype, dev) for _ in range(2))
    for causal in (True, False):
        out = fops.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(out, fops.flash_attention_plain(
            q, k, v, causal=causal), atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_wrapper_raises(dev):
    q = torch.zeros((1, 128, 4, 64), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 128, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no gradient"):
        fops.flash_attention(q.clone().requires_grad_(), k, k)
    with torch.no_grad():           # no gradient needed: the kernel runs
        fops.flash_attention(q.clone().requires_grad_(), k, k)
    with pytest.raises(ValueError, match="T >= S"):
        fops.flash_attention(q, k[:, :100], k[:, :100])
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention(q, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), k)
    hd80 = torch.zeros((1, 128, 2, 80), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel built"):
        fops.flash_attention(hd80, hd80, hd80)


def test_train_loss_flash_kernel_vs_plain(dev):
    cfg = get_reduced("phi4-mini-3.8b", num_heads=6, num_kv_heads=2,
                      head_dim=128)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        plain = model.train_loss(params, {"tokens": toks})
        model.use_flash = True
        before = fops.flash_attention.launches
        flash = model.train_loss(params, {"tokens": toks})
    assert fops.flash_attention.launches == before + cfg.num_layers
    assert abs(float(flash) - float(plain)) < 2e-3


@pytest.mark.parametrize("impls", [("pallas", "sdpa"),
                                   ("paged", "paged_sdpa")])
def test_model_walk_kernel_vs_plain(dev, impls):
    cfg = get_reduced("phi4-mini-3.8b", num_heads=6, num_kv_heads=2,
                      head_dim=128)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    lengths = torch.tensor([37, 22], device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    logits, caches = model.prefill_batched(params, toks, lengths, max_len=96)
    table = None
    if impls[0] == "paged":
        pool = model.paged_cache_init(8, 16, dev)
        table = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32,
                             device=dev)
        from repro_torch.serving.engine import adopt_prefill_pages
        adopt_prefill_pages(pool, caches, 0, table[0], block=16)
        adopt_prefill_pages(pool, caches, 1, table[1, :2], block=16)
        caches = pool
    other = {n: t.clone() for n, t in caches.items()}
    tok = logits.argmax(-1)
    for step in range(8):
        cur = (lengths + step).to(torch.int32)
        lk, _ = model.decode(params, caches, tok[:, None], cur,
                             decode_impl=impls[0], page_table=table)
        lp, _ = model.decode(params, other, tok[:, None], cur,
                             decode_impl=impls[1], page_table=table)
        spread = (lp.max(-1).values - lp.min(-1).values)
        assert torch.all((lk - lp).abs().max(-1).values < 0.02 * spread)
        tok = lp.argmax(-1)


@pytest.mark.parametrize("name,stub,hd", [
    ("phi-3-vision-4.2b", "patches", 96), ("seamless-m4t-medium", "frames",
                                           64)])
def test_encdec_vlm_walk_kernel_vs_plain(dev, name, stub, hd):
    """The reduced VLM (hd 96, as the full model) and encoder-decoder on
    the card: a prefill with patches or frames, then 8 forced decode steps
    from the prompt's end, ``"pallas"`` (K1, once a self-attention layer
    and step) against ``"sdpa"`` within 0.02 x the logit spread."""
    cfg = get_reduced(name, head_dim=hd)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                         generator=gen)
    n = cfg.num_patches if stub == "patches" else 57
    extra = torch.randn((2, n, cfg.frontend_dim), device=dev, generator=gen)
    logits, caches = model.prefill(params, {"tokens": toks, stub: extra},
                                   max_len=96)
    other = {k: t.clone() for k, t in caches.items()}
    pos = 40 + (cfg.num_patches if stub == "patches" else 0)
    tok = logits.argmax(-1)
    for step in range(8):
        cur = torch.full((2,), pos + step, dtype=torch.int32, device=dev)
        before = dops.decode_attention.launches
        lk, _ = model.decode(params, caches, tok[:, None], cur,
                             decode_impl="pallas")
        assert dops.decode_attention.launches == before + cfg.num_layers
        lp, _ = model.decode(params, other, tok[:, None], cur,
                             decode_impl="sdpa")
        spread = (lp.max(-1).values - lp.min(-1).values)
        assert torch.all((lk - lp).abs().max(-1).values < 0.02 * spread)
        tok = lp.argmax(-1)


@pytest.mark.parametrize("name,kind", [("jamba-v0.1-52b", "mamba"),
                                       ("xlstm-125m", "mlstm"),
                                       ("xlstm-125m", "slstm")])
def test_recurrent_block_on_card_matches_cpu(dev, name, kind, monkeypatch):
    """A recurrent block (no kernel: einsum and loop code) on the card
    against the same block on the CPU in fp32, prompt pass and cached
    step: the CUDA ops (cummax, logaddexp, the batched products) agree."""
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "COMPUTE_DTYPE", torch.float32)
    cfg = get_reduced(name)
    params = getattr(ssm, f"{kind}_init")(torch.Generator().manual_seed(0),
                                          cfg, torch.float32, "cpu")
    block = getattr(ssm, f"{kind}_block")
    x = torch.randn((2, 41, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    on_card = {k: v.to(dev) for k, v in params.items()
               if isinstance(v, torch.Tensor)}
    on_card.update({k: {"scale": v["scale"].to(dev)} for k, v in
                    params.items() if isinstance(v, dict)})
    y_cpu, c_cpu = block(params, x[:, :40], cfg)
    y_dev, c_dev = block(on_card, x[:, :40].to(dev), cfg)
    torch.testing.assert_close(y_dev.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    s_cpu, _ = block(params, x[:, 40:], cfg, cache=c_cpu)
    s_dev, _ = block(on_card, x[:, 40:].to(dev), cfg, cache=c_dev)
    torch.testing.assert_close(s_dev.cpu(), s_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,kw", [
    ("phi4-mini-3.8b", dict(num_heads=6, num_kv_heads=2, head_dim=128)),
    ("qwen3-moe-30b-a3b", dict(num_heads=8, num_kv_heads=1)),
    ("jamba-v0.1-52b", {}), ("xlstm-125m", {})])
def test_sharded_walk_on_a_one_rank_nccl_mesh(dev, tmp_path, name, kw):
    """chip_smoke.py phase 13 at the reduced size, for every family with a
    recurrent or MoE core too: under a (1, 1) mesh policy (a one-rank NCCL
    world from a file store) the model walks as the plain params do, with
    K1 launched on local shards once per attention layer and step, and its
    loss and the unembedding's gradient agree; ``compressed_psum`` over
    the NCCL group equals ``compress_grads`` bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import ShardingPolicy, use_policy
    from repro_torch.sharding.specs import device_put, param_shardings
    from repro_torch.training.compression import (compress_grads,
                                                  compressed_psum,
                                                  init_error_feedback)
    cfg = get_reduced(name, **kw)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        torch.bfloat16, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    card = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0, device_id=card)

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def walk(p, feed=None):
        out, fed = [], []
        logits, caches = model.prefill(p, {"tokens": toks}, max_len=64)
        for step in range(8):
            tok = full(logits).argmax(-1) if feed is None else feed[step]
            fed.append(tok)
            logits, caches = model.decode(p, caches, tok[:, None], 48 + step,
                                          decode_impl="pallas")
            out.append(full(logits))
        return out, fed

    def loss_and_grad(p):
        p["unembed"].requires_grad_(True)
        loss = model.train_loss(p, {"tokens": toks})
        grad, = torch.autograd.grad(loss, [p["unembed"]])
        p["unembed"].requires_grad_(False)
        return full(loss).detach().float(), full(grad).float()

    try:
        policy = ShardingPolicy(make_test_mesh((1, 1)))
        sharded = device_put(params, param_shardings(params, policy))
        with torch.no_grad():
            plain, fed = walk(params)
            before = dops.decode_attention.launches
            with use_policy(policy):
                got, _ = walk(sharded, fed)
        assert dops.decode_attention.launches == \
            before + 8 * model.mixers.count("attn")
        for a, b in zip(got, plain):
            spread = b.max(-1).values - b.min(-1).values
            assert torch.all((a - b).abs().max(-1).values < 0.02 * spread)
        loss, grad = loss_and_grad(params)
        with use_policy(policy):
            sloss, sgrad = loss_and_grad(sharded)
        assert abs(float(sloss - loss)) < 2e-3
        torch.testing.assert_close(sgrad, grad, atol=2e-2, rtol=2e-2)
        grads = [torch.randn(s, device=dev, generator=torch.Generator(
            device=dev).manual_seed(i)) for i, s in enumerate([(64, 33), (7,)])]
        err = init_error_feedback(grads)
        got, got_err = compressed_psum(grads, None, err)
        want, want_err = compress_grads(grads, err)
        assert all(torch.equal(a, b) for a, b in
                   zip(got + got_err, want + want_err))
    finally:
        dist.destroy_process_group()


def test_kernel_bench_holds_every_kernel(dev, tmp_path, monkeypatch):
    """``benchmarks/bench_torch_kernels.py`` at ``bench_kernels.py``'s fp32
    shapes: every kernel within 2e-5 of its plain version, and every time
    positive (its report goes to ``tmp_path``)."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    from benchmarks import bench_torch_kernels, common
    monkeypatch.setattr(common, "REPORT_DIR", tmp_path)
    before = {fn: fn.launches for fn in (dops.decode_attention,
                                         pops.paged_attention,
                                         fops.flash_attention)}
    results = bench_torch_kernels.run()
    assert results["device"] and "chip_smoke" in sys.modules
    for name in ("flash_attention", "decode_attention", "paged_attention"):
        r = results[name]
        assert r["agrees"] and r["max_abs_err"] <= TOL[torch.float32], name
        assert min(r["ms"], r["plain_ms"], r["library_ms"],
                   r["bound_ms"]) > 0, name
    assert all(fn.launches > n for fn, n in before.items())
    assert (tmp_path / "bench_torch_kernels.json").is_file()
