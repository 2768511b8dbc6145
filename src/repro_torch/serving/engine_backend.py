"""Engine backend of the scenario registry, on torch: port of
``src/repro/serving/engine_backend.py``.

Materializes a named scenario's request stream onto the port's
:class:`~repro_torch.serving.disagg.DisaggregatedCluster`, so every
registered scenario can run against real forward passes instead of the
analytic latency model::

    from repro_torch.serving.scenarios import build_backend

    runner = build_backend("parity-2d-warm", backend="engine", seed=0)
    result = runner.run()
    result.decisions          # [(index, worker, overlap)] routing record
    result.regime_transitions # saturation-regime transition sequence
    result.prefill_stats      # warm-vs-cold prefix-cache accounting

The runner runs on ``cuda`` unless the caller passes ``device`` (or
``params`` that live elsewhere, whose device it then takes).  With no
``model`` it builds the reduced config of ``model_name`` with random
weights from seed 0; a caller may pass any model the port builds, at any
width (``chip_smoke.py`` passes full-width Phi-4-mini).

The adapter *reduces* the workload (prompt/output lengths and request
counts are capped by ``input_tokens``/``output_tokens``/``num_requests``),
but the control-plane stream is faithful: templates come from the same
:func:`~repro_torch.serving.workload.template_mix` popularity skew (or the
trace's explicit template sequence), each template maps to a
deterministic in-vocab prompt that is distinct per template (prime
re-striding: a plain ``template_tokens % vocab`` would alias templates
16 apart on the 512-token reduced vocab), and routing runs through the
same :class:`~repro_torch.serving.control_plane.ControlPlane` code path
the analytic simulator uses.

``serialize=True`` (default) runs each request to completion before
submitting the next.  That is the backend-parity protocol: with zero
concurrent load on both backends, a τ=0 routing decision depends only on
the indexer's insert history, which both backends build identically — so
decision sequences are comparable request-by-request
(``tests/test_backend_parity.py``).  ``serialize=False`` floods the
cluster (backpressure + continuous batching exercise the real engines).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.core.saturation import DetectorConfig
from repro_torch.models import Model
from repro_torch.serving.disagg import DisaggregatedCluster, ServeRequest
from repro_torch.serving.workload import template_mix


@dataclass(frozen=True)
class EngineRequestSpec:
    """One materialized request (template resolved, tokens in-vocab)."""
    template: int
    tokens: Tuple[int, ...]
    max_new: int


@dataclass
class EngineRunResult:
    """What an engine-backend scenario run reports for parity analysis."""
    requests: List[ServeRequest]              # completion order
    decisions: List[Tuple[int, int, float]]   # (req index, worker, overlap)
    regime_transitions: List[Tuple[float, int, int]]
    final_regime: int
    prefill_stats: dict
    transferred_blocks: List[int]             # per decode worker

    def ttfts(self) -> List[float]:
        return [r.charged_ttft for r in self.requests]


class EngineScenarioRunner:
    """Drives one named scenario through the engine backend."""

    def __init__(self, scenario, *, seed: int = 0,
                 model_name: str = "phi4-mini-3.8b",
                 num_requests: Optional[int] = None,
                 input_tokens: int = 48,
                 output_tokens: int = 4,
                 slots_per_worker: int = 2,
                 serialize: bool = True,
                 warmup: bool = True,
                 model=None, params=None,
                 device=None,
                 **cluster_kw):
        # given params fix the device (the engines raise on a mismatch
        # with an explicit one); otherwise cuda unless the caller names one
        if params is not None and device is None:
            device = params["embed"].device
        device = resolve_device(device)
        self.scenario = scenario
        self.serialize = serialize
        self.warmup_enabled = warmup
        sim_kw = dict(scenario.sim_kwargs)
        cluster_kw.setdefault("routing_policy",
                              sim_kw.get("routing_policy", "kv"))
        cluster_kw.setdefault("adaptive", sim_kw.get("adaptive", False))
        if sim_kw.get("router_config") is not None:
            cluster_kw.setdefault("router_config", sim_kw["router_config"])
        # Mirror the analytic backend's control-plane defaults, so the
        # regime-sequence parity observable compares like against like:
        # same saturation thresholds (DetectorConfig.for_model) and the
        # scenario's own cache TTL (claim churn on the engine clock).
        cluster_kw.setdefault(
            "detector_config",
            sim_kw.get("detector_config")
            or DetectorConfig.for_model(scenario.cluster.name))
        cluster_kw.setdefault("cache_ttl", scenario.cluster.cache_ttl)
        # fabric scenarios carry the FabricConfig in sim_kwargs; the engine
        # cluster builds its own Fabric instance from the same config
        if sim_kw.get("fabric") is not None:
            cluster_kw.setdefault("fabric", sim_kw["fabric"])
            cluster_kw.setdefault("network_aware",
                                  sim_kw.get("network_aware", False))
        if model is None:
            model = Model(get_reduced(model_name))
            params = model.init(torch.Generator(device).manual_seed(0),
                                torch.bfloat16, device)
        self.device = device
        self.model = model
        self.vocab = model.cfg.vocab_size
        self.specs = self._materialize(seed, num_requests, input_tokens,
                                       output_tokens)
        max_len = max((len(s.tokens) + s.max_new for s in self.specs),
                      default=input_tokens + output_tokens) + 4
        self.cluster = DisaggregatedCluster(
            model, params,
            num_decode=scenario.cluster.num_decode,
            slots_per_worker=slots_per_worker,
            max_len=max_len, seed=seed, device=device, **cluster_kw)

    # ------------------------------------------------------- request stream --

    def _materialize(self, seed: int, num_requests: Optional[int],
                     input_tokens: int, output_tokens: int
                     ) -> List[EngineRequestSpec]:
        wl = self.scenario.workload
        specs: List[EngineRequestSpec] = []
        if wl.mode == "trace":
            # default: replay the full trace (parity runs must see every
            # decision the analytic backend makes)
            entries = list(wl.trace)[:num_requests]
            probs = template_mix(wl.num_templates)
            rng = np.random.default_rng(seed)
            for e in entries:
                template = e.template
                if template < 0:
                    template = int(rng.choice(len(probs), p=probs))
                specs.append(self._spec(template,
                                        min(e.input_tokens, input_tokens),
                                        min(e.output_tokens, output_tokens)))
        else:
            # closed-loop / open-loop: same popularity skew as the analytic
            # backend's template sampling, reduced to a fixed request count
            probs = template_mix(wl.num_templates)
            rng = np.random.default_rng(seed)
            for _ in range(num_requests if num_requests is not None else 12):
                template = int(rng.choice(len(probs), p=probs))
                specs.append(self._spec(
                    template, min(wl.input_tokens, input_tokens),
                    min(wl.output_tokens, output_tokens)))
        return specs

    def _spec(self, template: int, n_in: int, n_out: int) -> EngineRequestSpec:
        # In-vocab reduction must stay injective ACROSS templates: the
        # naive `token % vocab` aliases templates 16 apart on a 512-vocab
        # reduced model (16·100_000 ≡ 0 mod 512), silently merging distinct
        # templates' prefix caches and overlap claims.  Re-striding the
        # template id by a large prime keeps templates distinct mod any
        # realistic vocab (collision needs Δt·1_000_003 ≡ 0 mod vocab).
        toks = tuple((template * 1_000_003 + 7 * i) % self.vocab
                     for i in range(n_in))
        return EngineRequestSpec(template, toks, max(n_out, 1))

    # ---------------------------------------------------------------- run ---

    def _warmup(self) -> None:
        """Run every pass shape this run will hit once, outside the
        measured path (one-time costs such as library initialisation and
        allocator growth would otherwise read as slow TTFTs and drive the
        saturation detector across θ1)."""
        block = self.cluster.prefill.block_size
        lengths = sorted(set(len(s.tokens) for s in self.specs))
        suffixes = set()
        for n in lengths:
            for m in range(1, n // block + 1):
                start = min(m * block, n - 1)
                suffixes.add(n - start)
        # serialized runs only ever issue width-1 batched passes; flood
        # runs can fill a whole tick's admissions, so warm every
        # power-of-two width the bucketing can emit
        widths = [1]
        cap = min(self.cluster.prefill.max_batch, max(len(self.specs), 1))
        while self.cluster.batch_prefill and not self.serialize \
                and widths[-1] * 2 <= cap:
            widths.append(widths[-1] * 2)
        self.cluster.prefill.warmup(lengths, sorted(suffixes),
                                    batch_sizes=widths)
        # the admit path (cache insertion scatter) and the decode step
        # pay first-use costs too; run one dummy admit→step→auto-release
        # per decoder (empty hash list: no residency/transfer pollution)
        caches = self.cluster.prefill.dummy_caches(lengths[-1])
        for dec in self.cluster.decoders:
            if dec.paged:
                # warm every page-table ladder width up to the widest table
                # this run's longest (prompt + output) span can grow a slot
                # to, so a mid-run block-boundary crossing pays no first
                # launch at a new width
                span = max((len(s.tokens) + s.max_new + 1
                            for s in self.specs), default=lengths[-1] + 2)
                dec.warmup(table_widths=dec.width_ladder(span))
                # the adopt scatter: one dummy admit+release per distinct
                # mapped-page count the prompts map
                reps = {}
                for n in lengths:
                    reps.setdefault(dec.pages_for_prompt(n), n)
                top = dec.pages_for_prompt(lengths[-1])
                for n_map, n in sorted(reps.items()):
                    if n_map == top:
                        continue    # covered by the shared admit below
                    dec.admit(0, "__warmup__", caches, 0,
                              prompt_len=n, max_new=1, hashes=())
                    dec.release(0)
            else:
                dec.warmup()
            dec.admit(0, "__warmup__", caches, 0,
                      prompt_len=lengths[-1], max_new=1, hashes=())
            dec.step()                      # done=True → slot auto-released
            assert dec.active_count == 0
        # the first non-empty PoA evaluation lazily imports scipy's
        # Hungarian solver (~1 s) inside route()'s gauge export — a wall
        # the detector would read as a saturating TTFT; PoA falls back to
        # its pure-python solve when scipy is absent
        with contextlib.suppress(ImportError):
            import scipy.optimize  # noqa: F401

    def run(self) -> EngineRunResult:
        if self.warmup_enabled:
            self._warmup()
        cl = self.cluster
        for i, spec in enumerate(self.specs):
            cl.submit(ServeRequest(f"r{i}", list(spec.tokens),
                                   max_new_tokens=spec.max_new))
            if self.serialize:
                cl.run_until_done()
        cl.run_until_done()
        decisions = [(int(d.rid[1:]), d.worker, d.overlap)
                     for d in cl.control.decision_log]
        return EngineRunResult(
            requests=list(cl.done),
            decisions=decisions,
            regime_transitions=cl.control.regime_transitions(),
            final_regime=int(cl.control.detector.regime),
            prefill_stats=cl.prefill.stats.as_dict(),
            transferred_blocks=[d.transferred_blocks for d in cl.decoders])
