"""The decode engine's CUDA graphs: which engines replay them, their
staging, their launch counts, and the RoPE frequencies they depend on.

On the CPU: :func:`graphs_decode`'s rule, one case per kind of engine (a
card by a device stand-in); the graph path's staging with the capture
replaced by a direct call of the pass (the same static buffers, widths and
staging), served against the eager step over admits, releases and page
growth across table widths; the launch-count arithmetic against a stub;
and the cached RoPE frequencies against the numpy-built ones.

On the card (marked ``cuda``; they skip without one):

    PYTHONPATH=src python -m pytest -q -s --noconftest -m cuda \
        tests/test_torch_decode_graph.py

the reduced Phi-4-mini's replayed logits against the eager pass's, bit for
bit, over 200 steps, dense and paged, and a tiny Nemotron-H's (Mamba,
attention and MLP-only layers; K1 at its G = 8, hd = 128), whose Mamba
layers write their state in place through the ``ssd_step`` kernel inside
the graph; engines that switch between replay and eager steps serve the
eager engine's tokens; K1/K2 and ``ssd_step`` ``launches`` count layers x
steps, and a recorded graph's launches are its layers of each kind; and a
profiler trace holds the replayed kernels, layers x steps of them.
"""
import os
import tempfile
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs import nemotron_h_47b  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention)
from repro_torch.kernels.ssd_step.ops import ssd_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

torch.set_num_threads(1)

KERNEL = {"pallas": decode_attention, "paged": paged_attention}
NEMOTRON_H = "nemotron-h-47b"


def _config(arch):
    """The reduced config of ``arch``: the registry's, or Nemotron-H's
    own module's (K1's widths: 16 query heads over 2 of 128)."""
    if arch == NEMOTRON_H:
        return nemotron_h_47b.reduced(num_heads=16, num_kv_heads=2,
                                      head_dim=128)
    return get_reduced(arch)


@pytest.fixture(scope="module")
def phi():
    model = Model(get_reduced("phi4-mini-3.8b"))
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    return model, params


# ------------------------------------------------------------------ rule ---

CUDA = torch.device("cuda")      # a stand-in: the rule reads the type only


@pytest.mark.parametrize("arch,device,graphed,capturable", [
    ("phi4-mini-3.8b", torch.device("cpu"), False, True),
    ("jamba-v0.1-52b", CUDA, False, False),       # MoE layers
    ("xlstm-125m", CUDA, False, False),           # recurrent mixers
    ("seamless-m4t-medium", CUDA, False, False),  # encoder-decoder
    ("phi-3-vision-4.2b", CUDA, False, False),    # VLM
    ("qwen3-moe-30b-a3b", CUDA, False, False),    # MoE layers
    ("minitron-4b", CUDA, True, True),            # attention only, on a card
    ("phi4-mini-3.8b", CUDA, True, True),
    (NEMOTRON_H, CUDA, True, True),               # Mamba, attention, MLP
    (NEMOTRON_H, torch.device("cpu"), False, True),
])
def test_rule_graphs_attention_only_stacks_on_a_card(arch, device, graphed,
                                                     capturable):
    """The engine's rule (a card, plain parameters) over the model's own
    gate, ``Model.supports_graph_decode``, which reads no device."""
    model = Model(_config(arch))
    params = {"embed": torch.zeros(2), "layers": [{"w": torch.zeros(2)}]}
    assert model.supports_graph_decode is capturable
    assert E.graphs_decode(model, params, device) is graphed


def test_rule_keeps_a_sharded_engine_eager():
    """A DTensor anywhere among the parameters (a sharding policy) keeps
    the step eager, on a card too."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_test_mesh
    model = Model(get_reduced("phi4-mini-3.8b"))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", world_size=1, rank=0,
                                init_method=f"file://{os.path.join(tmp, 's')}")
        try:
            mesh = make_test_mesh((1, 1), device_type="cpu")
            w = DTensor.from_local(torch.zeros(2, 2), mesh, [Replicate()] * 2)
            plain = {"embed": torch.zeros(2),
                     "layers": [{"w": torch.zeros(2)}]}
            sharded = {"embed": torch.zeros(2), "layers": [{"w": w}]}
            assert E.graphs_decode(model, plain, CUDA)
            assert not E.graphs_decode(model, sharded, CUDA)
        finally:
            dist.destroy_process_group()


# --------------------------------------------------------------- staging ---

class DirectGraph:
    """The capture replaced by a direct call: every replay runs the pass
    again and writes its result into the static output."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.out.copy_(self.fn())
        self.replays += 1


def direct_record(fn, pool, stream):
    graph = DirectGraph(fn)
    graph.out = fn()
    return graph, graph.out


def capture_record(engines):
    """``direct_record`` that leaves the caches of the engine being served
    (``engines[-1]``) as it found them, as a capture does, which launches
    nothing: a recurrent layer's state must advance once a step, where
    K/V written twice at one position come out the same."""
    def record(fn, pool, stream):
        caches = engines[-1].caches
        kept = {n: t.clone() for n, t in caches.items()}
        out = direct_record(fn, pool, stream)
        for n, t in kept.items():
            caches[n].copy_(t)
        return out
    return record


def _prompt(vocab, template, n):
    return [(template * 1_000_003 + 7 * i) % vocab for i in range(n)]


# (prompt length, new tokens): admitted in order, each into the first free
# slot as one finishes; the paged tables widen 1 -> 2 -> 4 -> 8
REQUESTS = [(12, 30), (30, 40), (20, 8), (40, 44), (9, 20)]


def serve(model, params, impl, warm, engines=None):
    """Tokens of every step of a 3-slot engine serving REQUESTS (each
    admitted as a slot frees), the engine, and the table widths seen; the
    engine is appended to ``engines`` where given."""
    pre = E.PrefillEngine(model, params, max_len=128, cache_entries=0,
                          device="cpu")
    dec = E.DecodeEngine(model, params, num_slots=3, max_len=128,
                         decode_impl=impl, device="cpu")
    if engines is not None:
        engines.append(dec)
    if warm:
        dec.warmup(dec.width_ladder() if dec.paged else None)
    pending = list(enumerate(REQUESTS))
    steps, widths = [], set()
    while pending or dec.active_count:
        while pending and dec.free_slot() is not None:
            i, (n, new) = pending.pop(0)
            toks = _prompt(model.cfg.vocab_size, i, n)
            logits, caches = pre.prefill(toks)
            dec.admit(dec.free_slot(), f"r{i}", caches,
                      int(np.argmax(logits)), n, new)
        steps.append(dec.step())
        if dec.paged:
            widths.add(dec.page_table.shape[1])
    return steps, dec, widths


@pytest.fixture(scope="module")
def hybrid():
    model = Model(_config(NEMOTRON_H))
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    return model, params


@pytest.mark.parametrize("warm", [False, True], ids=["lazy", "warmed"])
def test_graph_staging_serves_a_hybrids_eager_tokens(hybrid, monkeypatch,
                                                     warm):
    """Nemotron-H's Mamba layers keep their state in the engine's caches,
    which the graph path reads and writes by address as it does K/V (the
    stand-in capture leaves the state as it was, as a capture does)."""
    engines = []
    _staging_serves_the_eager_steps_tokens(
        hybrid, monkeypatch, "pallas", warm,
        record=capture_record(engines), engines=engines)


@pytest.mark.parametrize("warm", [False, True], ids=["lazy", "warmed"])
@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_graph_staging_serves_the_eager_steps_tokens(phi, monkeypatch, impl,
                                                     warm):
    _staging_serves_the_eager_steps_tokens(phi, monkeypatch, impl, warm)


def _staging_serves_the_eager_steps_tokens(built, monkeypatch, impl, warm,
                                           record=direct_record,
                                           engines=None):
    model, params = built
    eager, ref, _ = serve(model, params, impl, warm)
    assert not ref.graphed and ref.eager_steps == len(eager)
    monkeypatch.setattr(E, "graphs_decode", lambda *a: True)
    monkeypatch.setattr(E, "record_graph", record)
    steps, dec, widths = serve(model, params, impl, warm, engines)
    assert dec.graphed
    assert steps == eager
    recorded = sorted(dec._graphs)
    if impl == "paged":
        assert len(widths) >= 3 and set(widths) <= set(recorded)
        ladder = dec.width_ladder()
        assert recorded == (ladder if warm else sorted(widths))
    else:
        assert recorded == [0]
    assert dec.graph_captures == len(recorded)
    # a width recorded in a step ran that step eagerly; every other step
    # replayed
    assert dec.eager_steps == (0 if warm else len(recorded))
    assert dec.graph_replays + dec.eager_steps == len(steps)
    assert sum(g.graph.replays for g in dec._graphs.values()) \
        == dec.graph_replays
    for w, g in dec._graphs.items():
        assert not g.host.is_pinned()              # pinned on a card only
        assert g.inputs.dtype == torch.int32
        assert g.tokens.data_ptr() == g.inputs.data_ptr()
        assert g.table is None if w == 0 else g.table.shape == (3, w)


def test_stage_packs_tokens_lengths_and_table():
    g = E.StepGraph(3, 4, torch.device("cpu"))
    tokens = np.array([[5], [6], [7]], np.int32)
    lengths = np.array([10, 0, 33], np.int32)
    table = np.arange(12, dtype=np.int32).reshape(3, 4) + 1
    g.stage(tokens, lengths, table)
    assert g.tokens.tolist() == [[5], [6], [7]]
    assert g.lengths.tolist() == [10, 0, 33]
    assert torch.equal(g.table, torch.from_numpy(table))
    dense = E.StepGraph(3, 0, torch.device("cpu"))
    dense.stage(tokens, lengths, None)
    assert dense.table is None and dense.inputs.tolist() == [5, 6, 7, 10, 0,
                                                             33]


# -------------------------------------------------------------- launches ---

class Wrapper:
    """A kernel wrapper's stand-in: its ``launches`` counter."""

    def __init__(self, launches):
        self.launches = launches


def test_capture_launches_are_put_back_and_added_per_replay():
    a, b = Wrapper(5), Wrapper(2)

    def capture():
        a.launches += 3              # the wrappers' host code, run once
        return "graph"
    out, made = E.recorded_launches((a, b), capture)
    assert out == "graph" and made == {a: 3, b: 0}
    assert (a.launches, b.launches) == (5, 2)
    g = E.StepGraph(2, 0, torch.device("cpu"))
    g.graph = types.SimpleNamespace(replay=lambda: None)
    g.out = torch.zeros(2, dtype=torch.long)
    g.launches = made
    for _ in range(4):
        assert g.replay() is g.out
    assert (a.launches, b.launches) == (5 + 3 * 4, 2)


def test_a_failed_capture_leaves_the_counters():
    a = Wrapper(7)

    def capture():
        a.launches += 1
        raise RuntimeError("capture refused")
    with pytest.raises(RuntimeError, match="refused"):
        E.recorded_launches((a,), capture)
    assert a.launches == 7


# ------------------------------------------------------------------ rope ---

@pytest.mark.parametrize("hd,theta", [(32, 10_000.0), (128, 10_000.0),
                                      (96, 1_000_000.0), (64, 500_000.0)])
def test_rope_freqs_are_the_numpy_float32_ones(hd, theta):
    half = hd // 2
    want = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    got = L.rope_freqs(hd, theta, torch.device("cpu"))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want, np.float32))
    assert L.rope_freqs(hd, theta, torch.device("cpu")) is got   # cached
    pos = torch.arange(40)
    cos, sin = L.rope_table(pos, hd, theta)
    angles = pos.float()[:, None] * torch.from_numpy(
        np.asarray(want, np.float32))
    assert torch.equal(cos, torch.cos(angles))
    assert torch.equal(sin, torch.sin(angles))


# ------------------------------------------------------------------ card ---

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and kernels run there")
    return torch.device("cuda")


@pytest.fixture
def phi_card(card):
    model = Model(get_reduced("phi4-mini-3.8b"))
    params = model.init(torch.Generator(device=card).manual_seed(0),
                        torch.bfloat16, device=card)
    return model, params


@pytest.fixture
def hybrid_card(card):
    model = Model(_config(NEMOTRON_H))
    params = model.init(torch.Generator(device=card).manual_seed(0),
                        torch.bfloat16, device=card)
    return model, params


CARD_STEPS = 200
CARD_LEN = 512


def _card_engines(model, params, impl, n, warm=True):
    """``n`` decode engines of 4 slots on the card, warmed up (which
    records their graphs) unless ``warm`` is False, then each admitted the
    same four prompts (25-61 tokens) with room for CARD_STEPS new tokens
    (a dense warm-up writes every slot's position 0, so it comes first)."""
    pre = E.PrefillEngine(model, params, max_len=CARD_LEN, cache_entries=0,
                          device="cuda")
    decs = [E.DecodeEngine(model, params, num_slots=4, max_len=CARD_LEN,
                           decode_impl=impl, device="cuda")
            for _ in range(n)]
    for d in decs if warm else ():
        d.warmup(d.width_ladder() if d.paged else None)
    for slot, plen in enumerate((25, 61, 40, 33)):
        toks = _prompt(model.cfg.vocab_size, slot, plen)
        logits, caches = pre.prefill(toks)
        for d in decs:
            d.admit(slot, f"r{slot}", caches, int(np.argmax(logits)), plen,
                    CARD_STEPS)
    return decs


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_card_replayed_logits_equal_eager_bit_for_bit(phi_card, impl):
    """The pass recorded once and replayed against the eager pass on a
    copy of the same caches, fed the same tokens, 200 steps: the logits
    agree bit for bit (paged: one table wide enough for every step)."""
    _replayed_logits_equal_eager(*phi_card, impl)


@pytest.mark.cuda
def test_card_hybrid_replayed_logits_equal_eager_bit_for_bit(hybrid_card):
    """As above for a tiny Nemotron-H: its Mamba states (SSM and conv),
    rewritten in place at every step, agree bit for bit too."""
    _replayed_logits_equal_eager(*hybrid_card, "pallas")


def _replayed_logits_equal_eager(model, params, impl):
    (dec,) = _card_engines(model, params, impl, 1, warm=False)
    if dec.paged:
        for i in range(dec.num_slots):   # map every page the steps reach
            while len(dec.allocator.owned[i]) < dec.allocator.pages_for(
                    dec.slots[i].length + CARD_STEPS + 1):
                dec.allocator.grow(i)
            pages = dec.allocator.owned[i]
            dec._widen_table(dec._table_width(len(pages)))
            dec.page_table[i, :len(pages)] = pages
    table = dec.page_table if dec.paged else None
    lengths = dec._lengths()
    # the engine's own recording: the pass once on the capture stream,
    # then its capture, which writes nothing; the capture's logits are a
    # static tensor that every replay rewrites
    seen = []

    def decode(*args, **kw):
        logits, caches = inner(*args, **kw)
        seen.append(logits)
        return logits, caches
    inner, model.decode = model.decode, decode
    try:
        dec._run(lengths, table)
    finally:
        del model.decode
    assert dec.graph_captures == 1 and dec.eager_steps == 1
    (g,) = dec._graphs.values()
    logits = seen[-1]
    # the copy after that pass, which has advanced a recurrent state (K/V
    # it wrote again at the same positions)
    eager_caches = {n: t.clone() for n, t in dec.caches.items()}
    tokens = dec.tokens.copy()
    for step in range(CARD_STEPS):
        g.stage(tokens, lengths, table)
        g.graph.replay()
        want, _ = model.decode(
            params, eager_caches,
            torch.as_tensor(tokens, device="cuda"),
            torch.as_tensor(lengths, device="cuda"), decode_impl=impl,
            page_table=None if table is None
            else torch.as_tensor(table, device="cuda"))
        assert torch.equal(logits, want), f"step {step}"
        assert torch.equal(g.out, torch.argmax(want, dim=-1)), f"step {step}"
        tokens = want.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
        lengths = lengths + 1
    for n, t in eager_caches.items():
        assert torch.equal(dec.caches[n], t), n


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_card_replay_and_eager_steps_serve_the_same_tokens(phi_card, impl):
    """Three engines on the same requests: one eager throughout (its
    ``graphed`` set False), one replaying throughout after ``warmup``, one
    that switches every few steps (a combine counter left non-zero by either
    would change the next step).  The tokens agree at every step, and K1
    or K2 counts layers x steps launches for each engine's steps."""
    _replay_and_eager_serve_the_same(*phi_card, impl)


@pytest.mark.cuda
def test_card_hybrid_replay_and_eager_serve_the_same_tokens(hybrid_card):
    """As above for a tiny Nemotron-H: K1 launches once a step in each of
    its attention layers and ``ssd_step`` once in each Mamba layer, and
    its recorded graph holds that many of each."""
    _replay_and_eager_serve_the_same(*hybrid_card, "pallas")


def _replay_and_eager_serve_the_same(model, params, impl):
    eager, graphed, mixed = _card_engines(model, params, impl, 3)
    assert eager.graphed and graphed.graphed and mixed.graphed
    eager.graphed = False
    # launches a step: one a layer of the kernel's kind
    layers = {KERNEL[impl]: model.mixers.count("attn"),
              ssd_step: model.mixers.count("mamba")}
    recorded = dict.fromkeys(E.DECODE_KERNELS, 0) | layers
    assert all(g.launches == recorded for g in graphed._graphs.values())
    for step in range(CARD_STEPS):
        # switch mixed between eager and replayed steps: 3 of each in turn
        mixed.graphed = step // 3 % 2 == 0
        outs = []
        for dec in (eager, graphed, mixed):
            before = {k: k.launches for k in layers}
            outs.append(dec.step())
            made = {k: k.launches - n for k, n in before.items()}
            assert made == layers, (step, dec is eager)
        assert outs[0] == outs[1] == outs[2], f"step {step}"
    assert graphed.graph_replays == CARD_STEPS and graphed.eager_steps == 0
    assert mixed.graph_replays == sum(s // 3 % 2 == 0
                                      for s in range(CARD_STEPS))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "paged"])
def test_card_profiler_sees_every_replayed_kernel(phi_card, impl):
    """Under ``torch.profiler`` the replayed steps' K1/K2 kernels appear
    once per layer and step (the benchmark's roofline readers count them);
    the host's launches and the device's operations a step, eager and
    replayed, are printed."""
    model, params = phi_card
    eager, graphed = _card_engines(model, params, impl, 2)
    eager.graphed = False
    name = {"pallas": "dense_split_kernel", "paged": "paged_split_kernel"}
    steps = 10
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = {}
    for label, dec in (("eager", eager), ("graphed", graphed)):
        dec.step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                dec.step()
            torch.cuda.synchronize()
        evs = prof.events()
        dev = [e for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = [e for e in evs if e.name in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaGraphLaunch")]
        kern = sum(name[impl] in e.name for e in dev)
        counts[label] = kern
        print(f"{torch.cuda.get_device_name(0)} {impl} {label}: "
              f"{len(dev) / steps:.1f} device operations a step, "
              f"{len(launches) / steps:.1f} host launch calls a step, "
              f"{kern / steps:.1f} {name[impl]} a step")
    layers = model.cfg.num_layers
    assert counts["eager"] == layers * steps
    assert counts["graphed"] == layers * steps
