"""repro_torch.analysis — the port's correctness tooling.

The **runtime coherence sanitizer** (:mod:`repro_torch.analysis.sanitize`,
a copy of ``src/repro/analysis/sanitize.py``), opt-in via
``REPRO_SANITIZE=1`` or ``sanitize=True`` on
``Simulator``/``ControlPlane``/``DisaggregatedCluster``, asserts the
load-bearing cross-structure invariants at event boundaries, with
recent-event-trace context on failure.  Its engine checks read the port's
engines through the attribute names the reference engines carry.

The reference's static lint pass (``lint.py``, rules RA001-RA011) is not
here: its jit/Pallas rules have torch counterparts still to be written
(ROADMAP.md, queue item "port lint rules").
"""
from repro_torch.analysis.sanitize import (SanitizeError, sanitize_enabled,
                                           attach_control_sanitizer,
                                           attach_engine_sanitizer,
                                           attach_sim_sanitizer)

__all__ = [
    "SanitizeError", "sanitize_enabled", "attach_sim_sanitizer",
    "attach_engine_sanitizer", "attach_control_sanitizer",
]
