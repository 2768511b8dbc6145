"""The shape of generated traffic, and the loader of its generators.

A mix's file names its generator (``"generator"``), a module of
``traffic/`` that builds the run's requests from the mix's parameters and
the seed.  An open loop has requests due at fixed times; a closed loop has
clients, each sending its next request once the last one has finished."""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from harness.spec import BENCH_DIR


@dataclass
class Request:
    rid: str
    prompt_len: int
    max_new: int
    make_tokens: Callable[[], List[int]]   # drawn when first needed
    due: Optional[float] = None            # traffic seconds (open loop)
    client: int = -1                       # closed loop
    group: int = -1                        # shared prefix, -1 for none


@dataclass
class OpenLoop:
    """``requests`` sorted by ``due``; the first ``lead_in_s`` seconds of
    arrivals fill the caches and slots before the window opens."""
    requests: List[Request]
    lead_in_s: float


@dataclass
class ClosedLoop:
    """``queues[c]`` is client c's requests, in the order it sends them;
    client c sends its first at ``starts[c]`` traffic seconds."""
    queues: List[List[Request]] = field(default_factory=list)
    starts: List[float] = field(default_factory=list)


def load_module(path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_traffic(mix: dict, seed: int, seconds: float, vocab: int):
    gen = load_module(BENCH_DIR / "traffic" / f"{mix['generator']}.py")
    return gen.build(mix, seed, seconds, vocab)
