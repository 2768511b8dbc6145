"""The architecture a configuration names, and the harness's calls into it.

The dense GQA architecture reads what the harness read before it became a
module of its own: ``dense_gqa_goldens.json`` holds its leaves, weights,
FLOP counts and a tiny cell's logit gaps as the harness computed them
before the move.  A test-only architecture, written with its configuration
under a temporary root, runs a tiny cell through ``report.run_cell`` with
no file of the harness changed, and every hook it supplies is called."""
import hashlib
import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

import architectures
import tiny
from harness import check, readers, report, spec, weights
from harness.serve import Harness
from harness.spec import ROOT
from harness.trace import Trace

GOLD = json.loads((Path(__file__).parent / "dense_gqa_goldens.json")
                  .read_text())
DENSE = tiny.dense()
PUBLISHED = ("phi4-mini-3.8b", "minitron-4b")


def _model(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def tree_digest(tree) -> str:
    """sha256 over every leaf of a parameter tree: its path, shape, type
    and bits, in path order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            h.update(repr(path).encode())
            h.update(repr((tuple(node.shape), str(node.dtype))).encode())
            h.update(node.detach().cpu().contiguous().view(torch.int16)
                     .numpy().tobytes())
    walk(tree, ())
    return h.hexdigest()


@pytest.mark.parametrize("name", PUBLISHED)
def test_leaves_match_the_parent(name):
    gold = GOLD["leaves"][name]
    spec_ = [[list(p), list(s), sc]
             for p, s, sc in DENSE.leaves(_model(name))]
    assert len(spec_) == gold["n"]
    assert spec_[:9] == gold["first"] and spec_[-1] == gold["last"]
    assert hashlib.sha256(json.dumps(spec_).encode()).hexdigest() == \
        gold["sha256"]


@pytest.mark.parametrize("seed", sorted(GOLD["weights"]))
def test_weights_match_the_parent(seed):
    m = tiny.cell("open").config["model"]
    assert m == GOLD["tiny_model"]
    got = weights.make_weights(DENSE, m, int(seed), "cpu")
    assert tree_digest(got) == GOLD["weights"][seed]


@pytest.mark.parametrize("name", PUBLISHED)
def test_flops_match_the_parent(name):
    m = _model(name)
    for start, length, want in GOLD["prompt_flops"][name]:
        assert DENSE.prompt_flops(m, start, length) == want, (start, length)
    for positions, want in GOLD["decode_flops"][name]:
        assert DENSE.decode_flops(m, positions) == want


def test_logit_gaps_match_the_parent():
    """The tiny cell's served tokens from a run of the parent's harness
    (``report.run_cell`` at the golden seed, its checked sample kept), judged
    again: the same widest gap and the same fp8 control gap."""
    gold = GOLD["logit_gap"]
    m = GOLD["tiny_model"]
    w = weights.make_weights(DENSE, m, gold["seed"], "cpu")
    chosen = [types.SimpleNamespace(**r) for r in gold["records"]]
    got = check.logit_gaps(DENSE.reference, w, m, chosen, control=True)
    assert got == {"gap": gold["gap"], "control_gap": gold["control_gap"],
                   "tokens": gold["tokens"]}


# ---------------------------------------------------------------- dispatch --

TOY = '''
"""A test-only architecture: dense GQA under other published key names, a
layer pattern held to the program as a string, the dense reference
wrapped.  Every hook records its call."""
from types import SimpleNamespace

import torch

from architectures import differ
from reference import dense_gqa

CALLS = []
KEYS = {"n_layer": "num_layers", "n_embd": "d_model", "n_head": "num_heads",
        "n_head_kv": "num_kv_heads", "head_size": "resolved_head_dim",
        "ffn_hidden_size": "d_ff", "padded_vocab_size": "vocab_size",
        "rotary_base": "rope_theta", "layernorm_epsilon": "norm_eps",
        "activation": "activation"}


def _dense(m):
    return {"num_hidden_layers": m["n_layer"], "hidden_size": m["n_embd"],
            "num_attention_heads": m["n_head"],
            "num_key_value_heads": m["n_head_kv"], "head_dim": m["head_size"],
            "intermediate_size": m["ffn_hidden_size"],
            "vocab_size": m["padded_vocab_size"],
            "rope_theta": m["rotary_base"],
            "rms_norm_eps": m["layernorm_epsilon"], "hidden_act": "silu"}


def mismatches(m, cfg):
    CALLS.append("mismatches")
    out = []
    for key, attr in KEYS.items():
        out += differ(key, m[key], getattr(cfg, attr))
    return out + differ("layer_pattern", m["layer_pattern"],
                        "*" * cfg.num_layers)


def leaves(m):
    CALLS.append("leaves")
    d, v, f = m["n_embd"], m["padded_vocab_size"], m["ffn_hidden_size"]
    h, k, hd = m["n_head"], m["n_head_kv"], m["head_size"]
    out = [(("embed",), (v, d), 0.02), (("unembed",), (d, v), d ** -0.5)]
    for i in range(len(m["layer_pattern"])):
        a, p = ("layers", i, "attn"), ("layers", i, "mlp")
        out += [(a + (n,), s, 0.1) for n, s in (
            ("wq", (d, h, hd)), ("wk", (d, k, hd)), ("wv", (d, k, hd)),
            ("wo", (h, hd, d)))]
        out += [(p + (n,), s, 0.1) for n, s in (
            ("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d)))]
    return out


def skeleton(m, device):
    CALLS.append("skeleton")

    def norm():
        return {"scale": torch.full((m["n_embd"],), 1.0,
                                    dtype=torch.bfloat16, device=device)}
    return {"layers": [{"attn": {"norm": norm()}, "mlp": {"norm": norm()}}
                       for _ in m["layer_pattern"]],
            "final_norm": norm()}


def _logits_at(weights, m, seqs, wanted, visit, precision="fp32"):
    CALLS.append("logits_at." + precision)
    dense_gqa.logits_at(weights, _dense(m), seqs, wanted, visit, precision)


reference = SimpleNamespace(logits_at=_logits_at)


def prompt_flops(m, start, length):
    CALLS.append("prompt_flops")
    return 1.0 * (length - start)


def decode_flops(m, positions):
    CALLS.append("decode_flops")
    return 2.0 * len(list(positions))


def decode_attention_layers(m):
    CALLS.append("decode_attention_layers")
    return m["layer_pattern"].count("*")


def attention_widths(m):
    CALLS.append("attention_widths")
    return m["n_head"], m["n_head_kv"], m["head_size"]


def vocab(m):
    CALLS.append("vocab")
    return m["padded_vocab_size"]
'''


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A root holding ``BENCHMARK.json`` with one tiny cell whose
    configuration names the test-only architecture ``toy_gqa`` and the
    program's config, a reduced registry model under ``repro_torch``; the
    program's ``Model`` counts the configs it is built with.  Returns a
    function that writes the configuration with some keys replaced."""
    reg = tiny.registry()
    built = []

    from repro_torch.models import model as program_model

    class Counted(program_model.Model):
        def __init__(self, cfg):
            built.append(cfg)
            super().__init__(cfg)

    monkeypatch.setattr(program_model, "Model", Counted)
    program = types.ModuleType("repro_torch.perfbench_toy")
    program.CONFIG = reg
    monkeypatch.setitem(sys.modules, "repro_torch.perfbench_toy", program)
    bench = tmp_path / "perfbench"
    for d in ("architectures", "configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True)
    (bench / "architectures" / "toy_gqa.py").write_text(TOY)
    (bench / "traffic" / "toy-open.json").write_text(json.dumps(tiny.OPEN))
    (bench / "limits" / "toy.open.json").write_text(
        json.dumps({"logit_gap": 0.25, "requests": 4}))
    e2e = [{"name": n, "unit": u} for n, u in tiny.E2E]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "toy.open", "config": "toy",
                       "traffic": "toy-open", "chips": 1}],
        "end_to_end": e2e, "per_layer": []}))
    model = {"n_layer": reg.num_layers, "n_embd": reg.d_model,
             "n_head": reg.num_heads, "n_head_kv": reg.num_kv_heads,
             "head_size": reg.resolved_head_dim, "ffn_hidden_size": reg.d_ff,
             "padded_vocab_size": reg.vocab_size,
             "rotary_base": reg.rope_theta,
             "layernorm_epsilon": reg.norm_eps, "activation": "swiglu",
             "layer_pattern": "*" * reg.num_layers}

    def write(**changes):
        config = {"name": "toy", "architecture": "toy_gqa",
                  "program": {"config": "repro_torch.perfbench_toy:CONFIG"},
                  "model": dict(model, **changes.pop("model", {}))}
        config.update(changes)
        (bench / "configs" / "toy.json").write_text(json.dumps(config))
        return spec.load_cell("toy.open", root=tmp_path)
    write.built = built
    return write


def test_a_new_architecture_runs_through_the_harness(toy_root, monkeypatch):
    loaded = []
    load = architectures.load

    def spy(config, *a, **k):
        mod = load(config, *a, **k)
        loaded.append(Path(mod.__file__).name)
        return mod
    monkeypatch.setattr(architectures, "load", spy)
    cell = toy_root()
    res = report.run_cell(cell, 2 ** 31 + 17, 2.0, False, "cpu",
                          time.perf_counter(), control=True)
    run = res["_run"]
    toy = run.arch
    assert loaded == ["toy_gqa.py"]
    assert len(toy_root.built) == 1
    assert toy_root.built[0] is sys.modules["repro_torch.perfbench_toy"].CONFIG
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] < 0.25 / 3
    assert res["_control_gap"] > res["checks"]["logit_gap"]["value"]
    # the prompt passes were counted by the toy's own count: a token each
    assert run.passes and all(f == int(f) for _, f in run.passes)
    # the readers that count a step's work or a kernel's launches ask it
    run.device, run.device_kind = "cuda", "NVIDIA H100 80GB HBM3"
    assert readers.step_mfu_pct(run) is not None
    run.traced_steps = [([9, 0], [9])]
    run.trace = Trace(1.0, 0.5, {"dense_split_kernel": (1e-6, 4)})
    assert report.read_metric("k1_roofline", run) is not None
    assert set(toy.CALLS) == {"mismatches", "leaves", "skeleton",
                              "logits_at.fp32", "logits_at.fp8",
                              "prompt_flops", "decode_flops",
                              "decode_attention_layers", "attention_widths",
                              "vocab"}


def test_a_string_key_that_differs_stops_the_run(toy_root):
    cell = toy_root(model={"layer_pattern": "**-*"})
    with pytest.raises(ValueError, match=r"layer_pattern: file \*\*-\*, "
                                         r"program \*\*\*\*"):
        Harness(cell, 1, "cpu")
    assert toy_root.built == []


def test_an_unknown_architecture_stops_the_run(toy_root):
    cell = toy_root(architecture="mamba9")
    with pytest.raises(ValueError, match=r"no architecture 'mamba9'; there "
                                         r"are \['toy_gqa'\]"):
        Harness(cell, 1, "cpu")
    with pytest.raises(ValueError, match="'dense_gqa'"):
        architectures.load({"name": "x", "architecture": "mamba9"})


def test_a_program_entry_outside_the_port_stops_the_run(toy_root):
    cell = toy_root(program={"config": "os:getcwd"})
    with pytest.raises(ValueError, match="under repro_torch"):
        Harness(cell, 1, "cpu")


def test_a_file_without_the_keys_is_dense_gqa_from_the_registry():
    cfg = json.loads((ROOT / "perfbench/configs/minitron-4b.json").read_text())
    assert "architecture" not in cfg and "program" not in cfg
    assert Path(architectures.load(cfg).__file__).name == "dense_gqa.py"
    assert spec.program_config(cfg).name == cfg["registry"]


@pytest.mark.parametrize("want,have,same", [
    (32, 32.0, True), (1e-05, 1e-05, True), (10000, 10000.0, True),
    (32, 31, False), ("M-M*", "M-M*", True), ("M-M*", "M-MM", False),
    ("32", 32, False), (True, 1, False), ([0, None], [0, None], True)])
def test_differ_compares_numbers_as_numbers_and_strings_as_strings(
        want, have, same):
    got = architectures.differ("k", want, have)
    assert got == ([] if same else [f"k: file {want}, program {have}"])
