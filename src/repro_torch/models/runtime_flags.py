"""Global model-execution flags.

``unroll_for_analysis`` — the dry-run sets this so every bounded loop
(layer-stack scan, attention q-chunking, loss chunking, SSD/mLSTM chunk
scans) is fully unrolled in the lowered HLO.  XLA's ``cost_analysis()``
counts a ``while`` body once rather than multiplying by trip count, so
unrolling is what makes the roofline FLOP/byte numbers exact.  (The sLSTM
per-token recurrence stays a loop: its in-loop compute — the small recurrent
block-diagonal matmuls — is <2% of xLSTM model FLOPs; noted in
EXPERIMENTS.md.)

Execution paths (tests, examples, serving) keep loops rolled.
"""
from __future__ import annotations

import contextlib

UNROLL_FOR_ANALYSIS = False


@contextlib.contextmanager
def unroll_for_analysis():
    global UNROLL_FOR_ANALYSIS
    prev = UNROLL_FOR_ANALYSIS
    UNROLL_FOR_ANALYSIS = True
    try:
        yield
    finally:
        UNROLL_FOR_ANALYSIS = prev


def scan_unroll(length: int) -> int:
    """Outer loops (layer stack, encoder stack, CE loss chunks): unrolled in
    analysis mode so per-depth XLA costs and collectives are visible."""
    return length if UNROLL_FOR_ANALYSIS else 1


def inner_scan_unroll(length: int) -> int:
    """Inner chunk loops (SSD/mLSTM chunk scans, attention q-blocks): always
    rolled — tracing/compiling hundreds of unrolled chunk bodies is
    intractable on big models.  Their exact costs come from the jaxpr
    counter (launch/jaxpr_cost.py), which multiplies scan trip counts."""
    return 1


# §Perf knob: overrides layers.Q_CHUNK when set (attention q-block length).
Q_CHUNK_OVERRIDE = None
