"""Architectures: what the harness needs to know of a model's shape.

A configuration file names its architecture with ``"architecture":
"<name>"``, which is the module ``architectures/<name>.py`` of the
benchmark's folder; a file without the key is ``dense_gqa``.  The harness
reaches every architecture-specific fact through that module, so a model
of another kind gets a cell by adding one, with no edit to the harness.

An architecture module supplies, for ``model`` (a configuration file's
``"model"`` object, the published keys):

``mismatches(model, cfg) -> list of str``
    Where the program's config ``cfg`` departs from ``model``, one line a
    key (empty when they agree).  Numbers compare as numbers and strings
    as strings (:func:`differ`).  A run stops on any line.
``leaves(model) -> [(path, shape, scale), ...]``
    The random leaves of the parameter tree, in the order one generator
    draws them into one flat buffer: each leaf is N(0, 1) times ``scale``.
``skeleton(model, device) -> tree``
    The parameter tree without its random leaves: the nested dicts and
    lists they go into, and every deterministic leaf (norm scales, a
    state-space layer's decay and skip terms) with its value, on
    ``device`` in the type it is served in.
``reference``
    The module of ``reference/`` whose ``logits_at(weights, model, seqs,
    wanted, visit, precision)`` judges ``correct`` (``precision="fp8"``
    is the control).
``prompt_flops(model, start, length) -> float``
    A prompt pass computing positions start..length-1 and the logits of
    the last one.
``decode_flops(model, positions) -> float``
    One decode step of the slots whose new token sits at ``positions``.
``decode_attention_layers(model) -> int``
    The layers that launch decode attention once a step (the kernels'
    roofline readers count their launches with it).
``attention_widths(model) -> (heads, kv_heads, head_dim)``
    The widths of an attention layer; the kernels' roofline readers count
    a launch's bytes from them (``harness/work.decode_attention_bytes``).
``vocab(model) -> int``
    The vocabulary's size; the traffic's tokens lie below it.

The harness reads no key of ``model`` itself, so a configuration file
keeps its source's key names and no others.  An architecture module
imports only torch, the standard library, ``architectures`` and
``reference``: nothing of the program or the harness.
"""
from __future__ import annotations

import importlib.util
from numbers import Real
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
DEFAULT = "dense_gqa"


def load(config: dict, bench_dir: Path = HERE.parent):
    """The architecture module ``config`` names, from ``bench_dir``'s
    ``architectures/`` (raises, naming those there, where it is not)."""
    folder = Path(bench_dir) / "architectures"
    name = config.get("architecture", DEFAULT)
    path = folder / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in folder.glob("*.py")
                      if p.stem != "__init__")
        raise ValueError(f"{config.get('name', '?')}: no architecture "
                         f"{name!r}; there are {have}")
    spec = importlib.util.spec_from_file_location(
        f"architecture_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def differ(key: str, want, have) -> List[str]:
    """``["key: file <want>, program <have>"]`` where the file's ``want``
    and the program's ``have`` differ, else ``[]``.  Numbers (not bools)
    compare as numbers, so 10000 equals 10000.0; anything else compares
    as it is, so a string equals only the same string."""
    def number(x):
        return isinstance(x, Real) and not isinstance(x, bool)
    if number(want) and number(have):
        same = float(want) == float(have)
    else:
        same = type(want) is type(have) and want == have
    return [] if same else [f"{key}: file {want}, program {have}"]
