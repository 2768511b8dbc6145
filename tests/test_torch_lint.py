"""The port's lint pass (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``), rule by rule.

* A mirror of ``tests/test_analysis_rules.py``: every fixture pair fires
  and stays clean (the reference's minima for the rules the two share, one
  finding per shape for RA003, RA004 and RA010), pragmas, the allowlist,
  the CLI's exit codes 0/1/2, ``--list-rules`` and ``--select``, and the
  fixture corpus outside the tree walk.
* Held against the reference: on every ``.py`` file of ``src/repro/`` (its
  fixtures included) and of ``src/repro_torch/`` (and the port's
  ``.py.txt`` fixtures), linted under the same path on both sides with
  ``src/repro/`` mapped to ``src/repro_torch/``, the seven rules the port
  keeps unchanged give exactly the reference's ``(rule, line, col)``
  findings, and RA005 does on every file without a torch call.
* The port's tree lints clean with no allowlist, over what
  ``chip_smoke.py``'s lint phase lints; four mutations of the real sources
  fire RA010 (a) and (b), RA004 and RA003.
* ``runtime_flags.Q_CHUNK_OVERRIDE`` blocks the port's prompt attention as
  it blocks the reference's.

Every violating snippet lives in a string: this file is itself linted by
both passes.
"""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as ref_lint  # noqa: E402
from repro_torch.analysis.__main__ import main as lint_main  # noqa: E402
from repro_torch.analysis.lint import (RULES, iter_python_files,  # noqa: E402
                                       lint_file, lint_paths, lint_source)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "src" / "repro_torch" / "analysis" / "fixtures"
REF_FIXTURES = ROOT / "src" / "repro" / "analysis" / "fixtures"

# RA009 is scoped by module path (event-clock modules only), so its
# fixtures are linted under a spoofed in-scope path.
_SPOOF_PATH = {"RA009": "src/repro_torch/serving/simulator.py"}

# minimum finding count the bad fixture must produce: the reference's for
# the rules the port keeps; RA005 is the reference's 4 plus 4 torch draws;
# RA003, RA004 and RA010 one per finding shape
_MIN_BAD = {"RA001": 4, "RA002": 3, "RA003": 5, "RA004": 4, "RA005": 8,
            "RA006": 3, "RA007": 3, "RA008": 1, "RA009": 3, "RA010": 4,
            "RA011": 5}
UNCHANGED = ("RA001", "RA002", "RA006", "RA007", "RA008", "RA009", "RA011")
# a phrase of each finding shape's message, for the rules the port rewrote
SHAPES = {
    "RA003": ("impure call `time.perf_counter()`", "impure call "
              "`random.random()`", "mutation `_log.append(...)`",
              "host sync `.item()`", "host sync `torch.cuda.synchronize()`"),
    "RA004": ("rebound at module level", "rebound inside `set_split`",
              "`dops.SPLIT_KEYS` rebinds", "`monkeypatch.setattr("),
    "RA005": ("`np.random.default_rng()` without", "`random.Random()` "
              "without", "numpy's process-global", "`random` module",
              "seeds torch's", "`torch.randn()` without", "`.uniform_()` "
              "without", "`torch.multinomial()` without"),
    "RA010": ("outside an `if <tensor>.device.type", "falls back to the "
              "plain version", "returns instead of raising",
              "defaults `use_kernel=True`"),
}

ALL_CODES = sorted(r.code for r in RULES)


def _lint_fixture(code: str, kind: str):
    path = FIXTURES / f"{code.lower()}_{kind}.py.txt"
    lint_as = _SPOOF_PATH.get(code, str(path))
    return lint_source(lint_as, path.read_text(), select=[code])


@pytest.mark.parametrize("code", ALL_CODES)
def test_bad_fixture_fires(code):
    findings = _lint_fixture(code, "bad")
    assert len(findings) >= _MIN_BAD[code], \
        f"{code} bad fixture produced {findings}"
    assert all(f.rule == code for f in findings)


@pytest.mark.parametrize("code", ALL_CODES)
def test_good_fixture_clean(code):
    assert _lint_fixture(code, "good") == []


@pytest.mark.parametrize("code", sorted(SHAPES))
def test_bad_fixture_shows_every_shape(code):
    """Each rewritten rule's bad fixture gives every finding shape, once."""
    messages = [f.message for f in _lint_fixture(code, "bad")]
    for phrase in SHAPES[code]:
        assert sum(phrase in m for m in messages) == 1, (phrase, messages)


def test_every_rule_has_fixture_pair():
    for rule in RULES:
        stem = rule.code.lower()
        assert (FIXTURES / f"{stem}_bad.py.txt").is_file()
        assert (FIXTURES / f"{stem}_good.py.txt").is_file()


def test_codes_equal_the_references():
    assert [r.code for r in RULES] == [r.code for r in ref_lint.RULES]
    assert len({r.code for r in RULES}) == len(RULES) == 11


@pytest.mark.parametrize("code", UNCHANGED + ("RA005",))
def test_shared_fixtures_are_the_references(code):
    """The unchanged rules' fixtures are byte-equal copies; RA005's are the
    reference's text with torch cases added."""
    for kind in ("bad", "good"):
        port = (FIXTURES / f"{code.lower()}_{kind}.py.txt").read_text()
        ref = (REF_FIXTURES / f"{code.lower()}_{kind}.py").read_text()
        if code == "RA005":
            body = ref.split('"""', 2)[2].replace("import numpy as np\n",
                                                  "import numpy as np\n"
                                                  "import torch\n", 1)
            assert body in port
        else:
            assert port == ref


# ------------------------------------------------------------ suppression ---


def test_pragma_suppresses_single_rule():
    src = "def f(w):\n    w._healthy = False   # ra: allow[RA001]\n"
    assert lint_source("src/repro_torch/x.py", src, select=["RA001"]) == []


def test_pragma_with_wrong_code_does_not_suppress():
    src = "def f(w):\n    w._healthy = False   # ra: allow[RA005]\n"
    assert len(lint_source("src/repro_torch/x.py", src,
                           select=["RA001"])) == 1


def test_blanket_pragma_suppresses_everything():
    src = "def f(w):\n    w._healthy = False   # ra: allow\n"
    assert lint_source("src/repro_torch/x.py", src, select=["RA001"]) == []


def test_allowlist_drops_matching_findings(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "mod.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(w):\n    w._healthy = False\n")
    assert len(lint_paths([str(tmp_path)], select=["RA001"])) == 1
    allowed = lint_paths([str(tmp_path)], select=["RA001"],
                         allowlist=[f"RA001 {bad.name}"])
    assert allowed == []
    # a different rule code in the allowlist must not mask RA001
    still = lint_paths([str(tmp_path)], select=["RA001"],
                       allowlist=[f"RA005 {bad.name}"])
    assert len(still) == 1


# -------------------------------------------------------------------- CLI ---


def test_cli_clean_tree_exits_zero(tmp_path, capsys):
    ok = tmp_path / "clean.py"
    ok.write_text("def f():\n    return 1\n")
    assert lint_main([str(tmp_path)]) == 0


def test_cli_findings_exit_one(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "mod.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(w):\n    w._healthy = False\n")
    assert lint_main([str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert "RA001" in out.out


@pytest.mark.parametrize("argv", [[], ["--select", "RA099", "src"],
                                  ["no/such/path.py"]])
def test_cli_usage_error_exits_two(argv, capsys):
    """No path, an unknown rule code, a missing path: 2, as the
    reference's CLI returns."""
    from repro.analysis.__main__ import main as ref_main
    assert lint_main(argv) == 2
    assert ref_main(argv) == 2


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule.code in out


def test_cli_select(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "mod.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(w):\n    w._healthy = False\n")
    assert lint_main(["--select", "RA005", str(tmp_path)]) == 0
    assert lint_main(["--select", "RA001", str(tmp_path)]) == 1


# ------------------------------------------------------------- clean tree ---


def test_fixture_corpus_is_excluded_from_tree_walk():
    """Neither pass's walk takes either fixture corpus, and the port's
    fixtures are still lintable file by file."""
    for walk in (iter_python_files, ref_lint.iter_python_files):
        files = walk([str(ROOT / "src")])
        assert files and not any("fixtures" in f.as_posix() for f in files)
    assert lint_file(FIXTURES / "ra001_good.py.txt") == []
    assert not list(FIXTURES.glob("*.py"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_tree_is_lint_clean():
    """What the card's lint phase lints, with NO allowlist."""
    cs = _chip_smoke()
    paths = [str(ROOT / p) for p in cs.lint_paths_here()]
    assert len(iter_python_files(paths)) > 80
    findings = lint_paths(paths)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_card_phase_stages_each_fixture_in_scope(tmp_path):
    """``chip_smoke.py``'s lint phase copies each bad fixture to a ``.py``
    path its rule scopes; the CLI then exits 1 with the stated minimum."""
    cs = _chip_smoke()
    assert cs.LINT_MIN_BAD == _MIN_BAD
    staged = cs.stage_bad_fixtures(tmp_path)
    assert sorted(staged) == ALL_CODES
    for code, path in staged.items():
        assert len(lint_paths([str(path)], select=[code])) >= _MIN_BAD[code]
        assert lint_main(["--select", code, str(path)]) == 1


# ------------------------------------------------- held against reference ---


def _corpus():
    """(reference path, port path, text) for every file of both packages,
    each linted under its path in both packages, and RA009's bad fixtures
    as an event-clock module."""
    out = []
    for pkg in ("repro", "repro_torch"):
        base = ROOT / "src" / pkg
        files = sorted(base.rglob("*.py"))
        if pkg == "repro_torch":
            files += sorted(FIXTURES.glob("*.py.txt"))
        for f in files:
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(base).as_posix()
            out.append((f"src/repro/{rel}", f"src/repro_torch/{rel}",
                        f.read_text()))
    # RA009's fixtures under an event-clock module's path, as RA009 scopes
    for f in (REF_FIXTURES / "ra009_bad.py", FIXTURES / "ra009_bad.py.txt"):
        out.append(("src/repro/serving/simulator.py",
                     "src/repro_torch/serving/simulator.py", f.read_text()))
    return out


def _torch_free(text):
    return not any(isinstance(n, ast.Name) and n.id == "torch"
                   for n in ast.walk(ast.parse(text)))


@pytest.mark.parametrize("code", UNCHANGED + ("RA005",))
def test_rule_matches_the_reference(code):
    corpus = _corpus()
    assert len(corpus) > 150
    checked = hits = 0
    for ref_path, port_path, text in corpus:
        if code == "RA005" and not _torch_free(text):
            continue
        want = [(f.rule, f.line, f.col)
                for f in ref_lint.lint_source(ref_path, text, select=[code])]
        got = [(f.rule, f.line, f.col)
               for f in lint_source(port_path, text, select=[code])]
        assert got == want, ref_path
        checked += 1
        hits += len(want)
    assert checked > 100 and hits > 0


# -------------------------------------------------------------- mutations ---


def _source(rel):
    return (ROOT / rel).read_text()


def _mutated(rel, old, new):
    src = _source(rel)
    assert src.count(old) == 1, old
    return src.replace(old, new)


DECODE_OPS = "src/repro_torch/kernels/decode_attention/ops.py"
PAGED_OPS = "src/repro_torch/kernels/paged_attention/ops.py"


def test_dropped_cpu_guard_fires_ra010():
    src = _mutated(DECODE_OPS, '    if q.device.type == "cpu":\n'
                   '        return decode_attention_plain(q, k, v, lengths)',
                   '    return decode_attention_plain(q, k, v, lengths)')
    found = lint_source(DECODE_OPS, src, select=["RA010"])
    assert len(found) == 1 and "device.type" in found[0].message


def test_plain_fallback_around_the_launch_fires_ra010():
    src = _source(DECODE_OPS)
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef)
              and n.name == "decode_attention")
    launch = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and ast.unparse(n.targets[0]) == "rc")
    lines = src.splitlines()
    pad = " " * launch.col_offset
    body = lines[launch.lineno - 1:launch.end_lineno]
    wrapped = ([f"{pad}try:"] + [f"    {line}" for line in body]
               + [f"{pad}except OSError:",
                  f"{pad}    return decode_attention_plain(q, k, v, "
                  f"lengths)"])
    src = "\n".join(lines[:launch.lineno - 1] + wrapped
                    + lines[launch.end_lineno:])
    found = lint_source(DECODE_OPS, src, select=["RA010"])
    assert [f.message.split(":")[0] for f in found] == [
        "a failed kernel launch falls back to the plain version"]


def test_global_split_keys_rebinding_fires_ra004():
    src = _source(PAGED_OPS) + (
        "\n\ndef set_split_keys(n):\n"
        "    global SPLIT_KEYS\n"
        "    SPLIT_KEYS = n\n")
    found = lint_source(PAGED_OPS, src, select=["RA004"])
    assert len(found) == 1 and "`SPLIT_KEYS` is rebound inside " \
        "`set_split_keys`" in found[0].message


def test_item_inside_time_ms_capture_fires_ra003():
    line = "            fn(*arg_sets[i % len(arg_sets)])"
    src = _mutated("chip_smoke.py", line, line + ".float().sum().item()")
    found = lint_source("chip_smoke.py", src, select=["RA003"])
    assert len(found) == 1 and "host sync `.item()`" in found[0].message


# ----------------------------------------------------------- q-chunk flag ---


def test_q_chunk_override_blocks_both_packages(monkeypatch):
    """``Q_CHUNK_OVERRIDE`` = 16 on both packages over a reduced model's
    prompt pass of 40 tokens (fp32 compute and weights): the reference's
    scan traces one 16-row block, the port runs 16, 16 and 8 rows; each
    package's logits agree within 1e-5 with its default blocking (one
    40-row block), and the two packages within the prompt-logit bound
    2e-3; the flags are restored after."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_reduced
    from repro.models import layers as JL
    from repro.models import runtime_flags as jflags
    from repro.models.model import Model as JaxModel
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.models import layers as TL
    from repro_torch.models import runtime_flags as tflags

    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    jm = JaxModel(jax_reduced("phi4-mini-3.8b"))
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = Model(get_reduced("phi4-mini-3.8b"))
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), tm.cfg, dtype=torch.float32,
                           device="cpu")
    toks = np.array([[(7 * i + 3) % 512 for i in range(40)]], np.int32)
    blocks = {"ref": [], "port": []}

    def spy(side, inner):
        def _sdpa(q, *args):
            blocks[side].append(int(q.shape[1]))
            return inner(q, *args)
        return _sdpa

    monkeypatch.setattr(JL, "_sdpa", spy("ref", JL._sdpa))
    monkeypatch.setattr(TL, "_sdpa", spy("port", TL._sdpa))

    def run():
        for side in blocks:
            blocks[side].clear()
        jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
        return (np.asarray(jl, np.float32), tl.numpy(),
                {k: list(v) for k, v in blocks.items()})

    ref_default, port_default, seen = run()
    assert seen["port"] == [40] * tm.n_layers
    assert set(seen["ref"]) == {40}
    with monkeypatch.context() as mp:
        mp.setattr(jflags, "Q_CHUNK_OVERRIDE", 16)
        mp.setattr(tflags, "Q_CHUNK_OVERRIDE", 16)
        ref_16, port_16, seen = run()
    assert seen["port"] == [16, 16, 8] * tm.n_layers
    assert set(seen["ref"]) == {16}
    assert jflags.Q_CHUNK_OVERRIDE is None and tflags.Q_CHUNK_OVERRIDE is None
    np.testing.assert_allclose(port_16, port_default, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref_16, ref_default, rtol=0, atol=1e-5)
    # across the packages, the prompt-logit bound (ROADMAP "How each slice
    # is held"): the two frameworks' fp32 sums differ by ~1e-3 here
    np.testing.assert_allclose(port_16, ref_16, rtol=2e-3, atol=2e-3)
    # an explicit q_chunk still wins over the flag
    q = torch.randn(1, 40, 2, 8, generator=torch.Generator().manual_seed(0))
    kv = torch.randn(1, 40, 1, 8, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(40)[None]
    with monkeypatch.context() as mp:
        mp.setattr(tflags, "Q_CHUNK_OVERRIDE", 16)
        blocks["port"].clear()
        TL._sdpa_chunked(q, kv, kv, pos, 2, kind="causal", q_chunk=32)
    assert blocks["port"] == [32, 8]
