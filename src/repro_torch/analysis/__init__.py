"""repro_torch.analysis — the port's correctness tooling.

Two instruments, as in the reference's ``repro.analysis``:

* a **static lint pass** (:mod:`repro_torch.analysis.lint`, a port of
  ``src/repro/analysis/lint.py``, run as ``python -m repro_torch.analysis
  src/repro_torch tests benchmarks examples``) with AST rules RA001-RA011;
  its RA003, RA004, RA005 and RA010 check the port's own contracts
  (CUDA-graph captures, kernel-shaping constants, torch's global RNG, the
  kernel wrappers' device guard) where the reference's check jit and
  Pallas code;
* a **runtime coherence sanitizer** (:mod:`repro_torch.analysis.sanitize`,
  a copy of ``src/repro/analysis/sanitize.py``), opt-in via
  ``REPRO_SANITIZE=1`` or ``sanitize=True`` on
  ``Simulator``/``ControlPlane``/``DisaggregatedCluster``, that asserts
  the load-bearing cross-structure invariants at event boundaries, with
  recent-event-trace context on failure.  Its engine checks read the
  port's engines through the attribute names the reference engines carry.
"""
from repro_torch.analysis.lint import (Finding, RULES, lint_file, lint_paths,
                                       rule_catalog)
from repro_torch.analysis.sanitize import (SanitizeError, sanitize_enabled,
                                           attach_control_sanitizer,
                                           attach_engine_sanitizer,
                                           attach_sim_sanitizer)

__all__ = [
    "Finding", "RULES", "lint_file", "lint_paths", "rule_catalog",
    "SanitizeError", "sanitize_enabled", "attach_sim_sanitizer",
    "attach_engine_sanitizer", "attach_control_sanitizer",
]
