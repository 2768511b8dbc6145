"""Named, reusable serving scenarios — the registry behind tests,
examples and benchmarks.

A *scenario* bundles the three inputs a simulator run needs:

* a :class:`~repro.serving.simulator.ClusterConfig` (possibly with a
  heterogeneous ``decode_workers`` pool and/or multiple prefill workers),
* a :class:`~repro.serving.workload.WorkloadConfig` (closed-loop ramp,
  open-loop Poisson/burst/diurnal, or JSONL trace replay),
* simulator keyword arguments (router config, routing policy, adaptive
  controller flag).

Usage::

    from repro.serving.scenarios import build_simulator, list_scenarios

    sim = build_simulator("hetero-decode-mixed", seed=0, fast=True)
    result = sim.run()

``get_scenario(name, **overrides)`` returns the :class:`Scenario` without
building; every factory accepts ``fast=True`` for a short-horizon variant
(used by the smoke tests) plus factory-specific knobs (``concurrency``,
``hold_s``, ``rate``, ``duration_s``, …).  Benchmarks parameterize the
``ramp``/``spike`` factories directly; examples and tests look scenarios
up by name.  Registered names span both cluster axes (homogeneous /
heterogeneous decode pools, single / pooled prefill) and all workload
modes — the paper's claim is that the three-regime PoA structure is a
property of the *mechanics*, so it should survive every one of these.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.planner import PlannerConfig
from repro_torch.serving.fabric import FabricConfig
from repro_torch.serving.simulator import (ClusterConfig, DecodeWorkerSpec,
                                     Simulator)
from repro_torch.serving.workload import WorkloadConfig


@dataclass(frozen=True)
class Scenario:
    """A named (cluster, workload, simulator-kwargs) bundle."""
    name: str
    description: str
    cluster: ClusterConfig
    workload: WorkloadConfig
    sim_kwargs: Mapping[str, Any] = field(default_factory=dict)

    def build(self, seed: int = 0, **overrides) -> Simulator:
        """Instantiate the simulator; ``overrides`` win over the
        scenario's own ``sim_kwargs`` (e.g. ``adaptive=True``)."""
        kw = {**self.sim_kwargs, **overrides}
        return Simulator(self.cluster, self.workload, seed=seed, **kw)


# ------------------------------------------------------------ factories ----

def ramp(model: str, topo: str, concurrency: int, hold_s: float = 120.0,
         ramp_s: float = 30.0, **sim_kwargs) -> Scenario:
    """Closed-loop single-level ramp — the paper's Experiment 1/2 shape."""
    return Scenario(
        name=f"{model}-{topo}-ramp-C{concurrency}",
        description=f"closed-loop ramp to C={concurrency} on {model} {topo}",
        cluster=ClusterConfig.for_model(model, topo),
        workload=WorkloadConfig.single_level(concurrency, hold_s=hold_s,
                                             ramp_s=ramp_s),
        sim_kwargs=sim_kwargs)


def spike(model: str, topo: str, low: int = 32, high: int = 128,
          durations=(120.0, 180.0, 120.0), **sim_kwargs) -> Scenario:
    """Closed-loop three-phase load spike — Experiment 3's shape."""
    return Scenario(
        name=f"{model}-{topo}-spike",
        description=f"C={low}→{high}→{low} spike on {model} {topo}",
        cluster=ClusterConfig.for_model(model, topo),
        workload=WorkloadConfig.load_spike(low=low, high=high,
                                           durations=durations),
        sim_kwargs=sim_kwargs)


def _mixed_pool(big_cap: int = 56, small_cap: int = 24) -> Tuple[DecodeWorkerSpec, ...]:
    """A mixed-generation decode pool: one current-gen card plus two
    previous-gen cards with fewer slots, less HBM, slower decode and a
    slower interconnect."""
    big = DecodeWorkerSpec(decode_cap=big_cap, g1_blocks=100_000,
                           itl_base=0.0090, kv_transfer=0.012)
    small = DecodeWorkerSpec(decode_cap=small_cap, g1_blocks=40_000,
                             itl_base=0.0135, itl_slope=0.00001,
                             kv_transfer=0.020)
    return (big, small, small)


# ------------------------------------------------------------- registry ----

SCENARIOS: Dict[str, Callable[..., Scenario]] = {}


def register(name: str, factory: Callable[..., Scenario]) -> None:
    SCENARIOS[name] = factory


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def parity_scenarios() -> List[str]:
    """The backend-parity family — single source of truth for the parity
    test suite and ``benchmarks/bench_backend_parity.py`` (a scenario added
    to one must be covered by the other)."""
    return [n for n in list_scenarios() if n.startswith("parity-")]


def get_scenario(name: str, **overrides) -> Scenario:
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {', '.join(list_scenarios())}") from None
    return factory(**overrides)


def build_simulator(name: str, seed: int = 0, **overrides) -> Simulator:
    """Look up ``name`` and instantiate its simulator.  Factory knobs
    (``fast``, ``concurrency``, …) and simulator kwargs (``adaptive``,
    ``routing_policy``, …) are split automatically: anything the factory
    does not consume is forwarded to ``Scenario.build``."""
    sim_keys = {"router_config", "adaptive", "detector_config",
                "routing_policy", "regime_params", "planner_config",
                "lean_completed", "sanitize", "replicas", "staleness",
                "fabric", "network_aware"}
    sim_kw = {k: overrides.pop(k) for k in list(overrides)
              if k in sim_keys}
    return get_scenario(name, **overrides).build(seed=seed, **sim_kw)


# Engine-runner knobs build_backend() routes to EngineScenarioRunner
# (everything else is a factory knob or a DisaggregatedCluster kwarg).
_ENGINE_KEYS = {"model_name", "num_requests", "input_tokens",
                "output_tokens", "slots_per_worker", "serialize", "warmup",
                "model", "params", "adaptive", "router_config",
                "detector_config", "routing_policy", "cache_ttl",
                "prefill_cache_entries", "kv_transfer_per_block",
                "batch_prefill", "max_prefill_batch", "decode_impl",
                "num_pages", "sanitize", "replicas", "staleness_ticks",
                "fabric", "network_aware"}


def build_backend(name: str, backend: str = "analytic", seed: int = 0,
                  **overrides):
    """Instantiate a named scenario on either backend.

    ``backend="analytic"`` returns the event-driven :class:`Simulator`
    (identical to :func:`build_simulator`); ``backend="engine"`` returns an
    :class:`~repro.serving.engine_backend.EngineScenarioRunner` that drives
    the scenario's request stream through real jitted-JAX engines on a
    reduced CPU-testable model.  Both route through the shared
    :class:`~repro.serving.control_plane.ControlPlane`."""
    if backend == "analytic":
        return build_simulator(name, seed=seed, **overrides)
    if backend == "engine":
        from repro_torch.serving.engine_backend import EngineScenarioRunner
        engine_kw = {k: overrides.pop(k) for k in list(overrides)
                     if k in _ENGINE_KEYS}
        return EngineScenarioRunner(get_scenario(name, **overrides),
                                    seed=seed, **engine_kw)
    raise ValueError(f"unknown backend {backend!r}; "
                     f"expected 'analytic' or 'engine'")


def _reg(name: str, doc: str):
    """Decorator: register ``factory`` under ``name`` with ``doc``."""
    def wrap(factory):
        def named(**kw) -> Scenario:
            sc = factory(**kw)
            return replace(sc, name=name, description=doc)
        register(name, named)
        return factory
    return wrap


# Closed-loop ramps (the paper's calibrated topologies) -----------------------

@_reg("70b-1p2d-ramp", "70B 1P/2D closed-loop ramp (paper Exp. 1 shape)")
def _70b_ramp(concurrency: int = 64, hold_s: float = 120.0,
              fast: bool = False, **kw) -> Scenario:
    if fast:
        kw.setdefault("ramp_s", 5.0)
        hold_s = 20.0
    return ramp("llama-3.1-70b", "1P/2D", concurrency, hold_s=hold_s, **kw)


@_reg("340b-1p2d-ramp", "340B 1P/2D closed-loop ramp (paper Exp. 1 shape)")
def _340b_ramp(concurrency: int = 64, hold_s: float = 120.0,
               fast: bool = False, **kw) -> Scenario:
    if fast:
        kw.setdefault("ramp_s", 5.0)
        hold_s = 20.0
    return ramp("nemotron-4-340b", "1P/2D", concurrency, hold_s=hold_s, **kw)


# Closed-loop spikes (Experiment 3) ------------------------------------------

def _register_spike(name: str, doc: str, model: str, topo: str) -> None:
    @_reg(name, doc)
    def _spike(low: int = 32, high: int = 128, fast: bool = False,
               **kw) -> Scenario:
        durations = (15.0, 20.0, 15.0) if fast else (120.0, 180.0, 120.0)
        return spike(model, topo, low=low, high=high,
                     durations=kw.pop("durations", durations), **kw)


_register_spike("70b-1p2d-spike", "70B 1P/2D C=32→128→32 spike",
                "llama-3.1-70b", "1P/2D")
_register_spike("70b-1p5d-spike", "70B 1P/5D C=32→128→32 spike",
                "llama-3.1-70b", "1P/5D")
_register_spike("340b-1p2d-spike", "340B 1P/2D C=32→128→32 spike",
                "nemotron-4-340b", "1P/2D")


# Open-loop arrival processes ------------------------------------------------

@_reg("70b-2p4d-poisson",
      "70B with a 2-worker prefill pool and 4 decode workers under "
      "open-loop Poisson arrivals")
def _70b_poisson(rate: float = 12.0, duration_s: float = 120.0,
                 fast: bool = False, **kw) -> Scenario:
    if fast:
        duration_s = 25.0
    return Scenario(
        name="", description="",
        cluster=ClusterConfig.for_model("llama-3.1-70b", "2P/4D"),
        workload=WorkloadConfig.poisson(rate=rate, duration_s=duration_s),
        sim_kwargs=kw)


@_reg("340b-1p5d-burst",
      "340B 1P/5D under bursty on/off arrivals (quiet 4 rps, bursts 24 rps)")
def _340b_burst(rate: float = 4.0, burst_rate: float = 24.0,
                duration_s: float = 180.0, fast: bool = False, **kw) -> Scenario:
    if fast:
        duration_s = 25.0
    return Scenario(
        name="", description="",
        cluster=ClusterConfig.for_model("nemotron-4-340b", "1P/5D"),
        workload=WorkloadConfig.bursty(rate=rate, burst_rate=burst_rate,
                                       duration_s=duration_s,
                                       on_s=8.0, off_s=20.0),
        sim_kwargs=kw)


@_reg("70b-1p2d-diurnal",
      "70B 1P/2D under a diurnal sinusoid arrival rate (period 120 s)")
def _70b_diurnal(rate: float = 10.0, duration_s: float = 240.0,
                 period_s: float = 120.0, fast: bool = False, **kw) -> Scenario:
    if fast:
        duration_s, period_s = 24.0, 12.0
    return Scenario(
        name="", description="",
        cluster=ClusterConfig.for_model("llama-3.1-70b", "1P/2D"),
        workload=WorkloadConfig.diurnal(rate=rate, duration_s=duration_s,
                                        period_s=period_s, amplitude=0.8),
        sim_kwargs=kw)


# Heterogeneous decode pools -------------------------------------------------

@_reg("hetero-decode-mixed",
      "70B with a mixed-generation decode pool (1 big + 2 small cards), "
      "closed-loop ramp")
def _hetero_mixed(concurrency: int = 64, hold_s: float = 120.0,
                  fast: bool = False, **kw) -> Scenario:
    if fast:
        hold_s = 20.0
    base = ClusterConfig.for_model("llama-3.1-70b", "1P/3D")
    return Scenario(
        name="", description="",
        cluster=replace(base, decode_workers=_mixed_pool()),
        workload=WorkloadConfig.single_level(concurrency, hold_s=hold_s,
                                             ramp_s=5.0 if fast else 30.0),
        sim_kwargs=kw)


@_reg("hetero-decode-burst",
      "mixed-generation decode pool under bursty open-loop arrivals — "
      "capacity-normalized routing is what keeps the small cards sane")
def _hetero_burst(rate: float = 6.0, burst_rate: float = 30.0,
                  duration_s: float = 180.0, fast: bool = False,
                  **kw) -> Scenario:
    if fast:
        duration_s = 25.0
    base = ClusterConfig.for_model("llama-3.1-70b", "1P/3D")
    return Scenario(
        name="", description="",
        cluster=replace(base, decode_workers=_mixed_pool()),
        workload=WorkloadConfig.bursty(rate=rate, burst_rate=burst_rate,
                                       duration_s=duration_s,
                                       on_s=6.0, off_s=18.0),
        sim_kwargs=kw)


# Cache pressure (Game 2 / Prop. 5) ------------------------------------------
#
# Tiny per-worker G1 HBM against the skewed template mix: resident blocks
# outgrow G1 mid-run, ρ crosses 1, and the KVBM starts demoting into
# G2/G3 — the contested regime where router overlap must stay coherent
# with actual HBM residency and G2/G3 hits pay Eq. 6 onboarding latency
# instead of full recompute.

def _pressure_cluster(g1_blocks: int, g2_blocks: Optional[int] = None,
                      g3_blocks: Optional[int] = None,
                      topo: str = "1P/2D") -> ClusterConfig:
    base = ClusterConfig.for_model("llama-3.1-70b", topo)
    return replace(base, g1_blocks=g1_blocks,
                   g2_blocks=g2_blocks if g2_blocks is not None else 2 * g1_blocks,
                   g3_blocks=g3_blocks if g3_blocks is not None else 4 * g1_blocks)


def _pressure_workload(workload: WorkloadConfig, input_tokens: int,
                       num_templates: int = 12) -> WorkloadConfig:
    # longer prompts (more blocks per template) and a wider Zipf-skewed
    # template universe, so the resident working set outgrows the
    # shrunken G1 within the run and keeps churning
    return replace(workload, input_tokens=input_tokens,
                   num_templates=num_templates)


@_reg("cache-pressure-70b",
      "70B 1P/2D ramp with tiny G1 HBM (Prop. 5: ρ crosses 1 mid-run, "
      "demotions + G2/G3 onboarding on the TTFT path)")
def _cache_pressure_ramp(concurrency: int = 48, hold_s: float = 90.0,
                         g1_blocks: int = 48, input_tokens: int = 256,
                         fast: bool = False, **kw) -> Scenario:
    if fast:
        hold_s = 20.0
    return Scenario(
        name="", description="",
        cluster=_pressure_cluster(g1_blocks),
        workload=_pressure_workload(
            WorkloadConfig.single_level(concurrency, hold_s=hold_s,
                                        ramp_s=5.0 if fast else 30.0),
            input_tokens),
        sim_kwargs=kw)


@_reg("cache-pressure-burst",
      "tiny-G1 cluster under bursty open-loop arrivals — tier churn plus "
      "the overload drain tail")
def _cache_pressure_burst(rate: float = 5.0, burst_rate: float = 25.0,
                          duration_s: float = 120.0, g1_blocks: int = 48,
                          input_tokens: int = 256, fast: bool = False,
                          **kw) -> Scenario:
    if fast:
        duration_s = 25.0
    return Scenario(
        name="", description="",
        cluster=_pressure_cluster(g1_blocks),
        workload=_pressure_workload(
            WorkloadConfig.bursty(rate=rate, burst_rate=burst_rate,
                                  duration_s=duration_s, on_s=6.0,
                                  off_s=14.0),
            input_tokens),
        sim_kwargs=kw)


@_reg("cache-pressure-hetero",
      "mixed-generation pool where only the small cards are G1-starved — "
      "per-worker ρ diverges and cache-affinity must follow residency")
def _cache_pressure_hetero(concurrency: int = 64, hold_s: float = 90.0,
                           input_tokens: int = 256, fast: bool = False,
                           **kw) -> Scenario:
    if fast:
        hold_s = 20.0
    big = DecodeWorkerSpec(decode_cap=56, g1_blocks=100_000,
                           itl_base=0.0090, kv_transfer=0.012)
    small = DecodeWorkerSpec(decode_cap=24, g1_blocks=32, g2_blocks=64,
                             g3_blocks=128, itl_base=0.0135,
                             itl_slope=0.00001, kv_transfer=0.020)
    base = ClusterConfig.for_model("llama-3.1-70b", "1P/3D")
    return Scenario(
        name="", description="",
        cluster=replace(base, decode_workers=(big, small, small)),
        workload=_pressure_workload(
            WorkloadConfig.single_level(concurrency, hold_s=hold_s,
                                        ramp_s=5.0 if fast else 30.0),
            input_tokens),
        sim_kwargs=kw)


# Elastic worker-role pools (Game 1 / Prop. 1) -------------------------------
#
# One unified pool of workers whose P/D split the Planner repartitions at
# runtime (drain protocol: stop admitting, drain decodes, flush KVBM +
# indexer claims).  The elastic calibration makes *both* pool objectives
# load-sensitive — prefill is slowed (long-prompt regime) so the prefill
# pool can saturate, and decode ITL gets a real load slope so shrinking
# the decode pool raises ITL violations.  Knobs documented in
# EXPERIMENTS.md ("Game 1 repartitioning calibration").

def _elastic_cluster(model: str, topo: str, *, prefill_rate: float,
                     itl_slope: float, decode_cap: int) -> ClusterConfig:
    base = ClusterConfig.for_model(model, topo)
    return replace(base, prefill_rate=prefill_rate, itl_slope=itl_slope,
                   decode_cap=decode_cap)


def _elastic_planner(fast: bool, *, itl_slo: float, ttft_slo: float,
                     adjust_interval: Optional[float] = None,
                     grace_intervals: Optional[int] = None) -> PlannerConfig:
    if adjust_interval is None:
        adjust_interval = 6.0 if fast else 20.0
    if grace_intervals is None:
        grace_intervals = 1 if fast else 2
    return PlannerConfig(adjust_interval=adjust_interval,
                         grace_intervals=grace_intervals,
                         ttft_slo=ttft_slo, itl_slo=itl_slo,
                         hysteresis=0.3)


@_reg("elastic-70b",
      "70B unified 6-worker pool starting decode-heavy (1P/5D); the "
      "Planner repartitions toward the Prop. 1 variational equilibrium "
      "under stationary closed-loop load")
def _elastic_70b(concurrency: int = 64, hold_s: float = 150.0,
                 topo: str = "1P/5D", fast: bool = False,
                 planner: bool = True, **kw) -> Scenario:
    if fast:
        hold_s = 60.0
    if planner:
        kw.setdefault("planner_config",
                      _elastic_planner(fast, itl_slo=0.016, ttft_slo=0.30))
    return Scenario(
        name="", description="",
        cluster=_elastic_cluster("llama-3.1-70b", topo,
                                 prefill_rate=16.0, itl_slope=4e-4,
                                 decode_cap=64),
        workload=WorkloadConfig.single_level(concurrency, hold_s=hold_s,
                                             ramp_s=5.0),
        sim_kwargs=kw)


@_reg("elastic-340b",
      "340B unified 6-worker pool (1P/5D start) under stationary "
      "closed-loop load with runtime P/D repartitioning")
def _elastic_340b(concurrency: int = 48, hold_s: float = 150.0,
                  topo: str = "1P/5D", fast: bool = False,
                  planner: bool = True, **kw) -> Scenario:
    if fast:
        hold_s = 60.0
    if planner:
        kw.setdefault("planner_config",
                      _elastic_planner(fast, itl_slo=0.035, ttft_slo=0.60))
    return Scenario(
        name="", description="",
        cluster=_elastic_cluster("nemotron-4-340b", topo,
                                 prefill_rate=8.0, itl_slope=8e-4,
                                 decode_cap=64),
        workload=WorkloadConfig.single_level(concurrency, hold_s=hold_s,
                                             ramp_s=5.0),
        sim_kwargs=kw)


@_reg("elastic-burst",
      "elastic 70B pool under a diurnal open-loop wave: the equilibrium "
      "split shifts with the arrival rate and the Planner re-splits "
      "across the cycle")
def _elastic_burst(rate: float = 10.0, duration_s: float = 240.0,
                   period_s: float = 120.0, topo: str = "1P/5D",
                   fast: bool = False, planner: bool = True,
                   **kw) -> Scenario:
    if fast:
        duration_s, period_s = 60.0, 30.0
    if planner:
        kw.setdefault("planner_config",
                      _elastic_planner(fast, itl_slo=0.016, ttft_slo=0.30,
                                       adjust_interval=5.0 if fast else 10.0))
    return Scenario(
        name="", description="",
        cluster=_elastic_cluster("llama-3.1-70b", topo,
                                 prefill_rate=16.0, itl_slope=4e-4,
                                 decode_cap=64),
        workload=WorkloadConfig.diurnal(rate=rate, duration_s=duration_s,
                                        period_s=period_s, amplitude=0.8),
        sim_kwargs=kw)


# Production-scale pools (large-pool hot path) -------------------------------
#
# Pools the size production disaggregated deployments run (tens to hundreds
# of decode workers) under open-loop Poisson traffic with a wide Zipf
# template mix — the regime where the per-worker radix walk, repeated
# request hashing and the dense frozen-OPT matrix used to melt the control
# plane.  The full variants push ~100k requests through the event loop
# (``benchmarks/bench_scale.py`` tracks their wall time); ``fast=True``
# keeps the pool size but shortens the horizon for smoke tests.

def _scale_pool(num_decode: int, hetero: bool) -> ClusterConfig:
    topo = f"{max(2, num_decode // 16)}P/{num_decode}D"
    base = ClusterConfig.for_model("llama-3.1-70b", topo)
    if not hetero:
        return base
    # mixed-generation pool: every fourth card is current-gen, the rest
    # are previous-gen with fewer slots, less HBM and slower decode
    big = DecodeWorkerSpec(decode_cap=56, g1_blocks=100_000,
                           itl_base=0.0090, kv_transfer=0.012)
    small = DecodeWorkerSpec(decode_cap=24, g1_blocks=40_000,
                             itl_base=0.0135, itl_slope=0.00001,
                             kv_transfer=0.020)
    pool = tuple(big if w % 4 == 0 else small for w in range(num_decode))
    return replace(base, decode_workers=pool)


def _scale_scenario(num_decode: int, hetero: bool, num_requests: int,
                    num_templates: int, fast: bool, **kw) -> Scenario:
    if fast:
        num_requests = min(num_requests, 1500)
    rate = 2.0 * num_decode          # load scales with the pool
    kw.setdefault("lean_completed", True)
    return Scenario(
        name="", description="",
        cluster=_scale_pool(num_decode, hetero),
        workload=replace(
            WorkloadConfig.poisson(rate=rate,
                                   duration_s=num_requests / rate),
            num_templates=num_templates, output_tokens=32),
        sim_kwargs=kw)


@_reg("scale-64",
      "64 homogeneous decode workers (4P/64D), 100k open-loop Poisson "
      "requests over a 64-template Zipf mix")
def _scale_64(num_requests: int = 100_000, num_templates: int = 64,
              fast: bool = False, **kw) -> Scenario:
    return _scale_scenario(64, False, num_requests, num_templates, fast, **kw)


@_reg("scale-128",
      "128-worker mixed-generation decode pool (8P/128D), 100k open-loop "
      "Poisson requests over a 96-template Zipf mix")
def _scale_128(num_requests: int = 100_000, num_templates: int = 96,
               fast: bool = False, **kw) -> Scenario:
    return _scale_scenario(128, True, num_requests, num_templates, fast, **kw)


@_reg("scale-256",
      "256 homogeneous decode workers (16P/256D), 100k open-loop Poisson "
      "requests over a 128-template Zipf mix")
def _scale_256(num_requests: int = 100_000, num_templates: int = 128,
               fast: bool = False, **kw) -> Scenario:
    return _scale_scenario(256, False, num_requests, num_templates, fast, **kw)


# Replicated control plane at scale ------------------------------------------
#
# The scale pools routed by R router replicas on bounded-staleness state
# views (ReplicatedControlPlane): each replica refreshes its snapshot
# every ``staleness`` metrics intervals and sees only its own placements
# in between.  ``replicas``/``staleness`` are first-class knobs so the
# staleness sweep in benchmarks/bench_scale.py (and the deterministic
# replay tests) can parameterize the grid through the registry.

def _scale_replica(num_decode: int, hetero: bool, num_requests: int,
                   num_templates: int, fast: bool, replicas: int,
                   staleness: float, **kw) -> Scenario:
    kw["replicas"] = replicas
    kw["staleness"] = staleness
    return _scale_scenario(num_decode, hetero, num_requests, num_templates,
                           fast, **kw)


@_reg("scale-replica-64",
      "scale-64 pool routed by R router replicas on bounded-staleness "
      "views (default R=4, staleness=4 sync intervals)")
def _scale_replica_64(num_requests: int = 100_000, num_templates: int = 64,
                      fast: bool = False, replicas: int = 4,
                      staleness: float = 4.0, **kw) -> Scenario:
    return _scale_replica(64, False, num_requests, num_templates, fast,
                          replicas, staleness, **kw)


@_reg("scale-replica-128",
      "scale-128 mixed-generation pool routed by R router replicas on "
      "bounded-staleness views (default R=4, staleness=4 sync intervals)")
def _scale_replica_128(num_requests: int = 100_000, num_templates: int = 96,
                       fast: bool = False, replicas: int = 4,
                       staleness: float = 4.0, **kw) -> Scenario:
    return _scale_replica(128, True, num_requests, num_templates, fast,
                          replicas, staleness, **kw)


@_reg("scale-replica-256",
      "scale-256 pool routed by R router replicas on bounded-staleness "
      "views (default R=4, staleness=4 sync intervals)")
def _scale_replica_256(num_requests: int = 100_000, num_templates: int = 128,
                       fast: bool = False, replicas: int = 4,
                       staleness: float = 4.0, **kw) -> Scenario:
    return _scale_replica(256, False, num_requests, num_templates, fast,
                          replicas, staleness, **kw)


# Trace replay ---------------------------------------------------------------

def example_trace_records(n: int = 120, horizon_s: float = 30.0) -> List[dict]:
    """A deterministic synthetic trace following the JSONL schema: arrival
    times thicken toward the middle of the horizon (a mini load wave),
    templates cycle with the popularity skew, output lengths alternate."""
    records = []
    for i in range(n):
        u = i / max(n - 1, 1)
        # quadratic time warp: denser arrivals mid-horizon
        t = horizon_s * (u - 0.35 * u * (1.0 - u) * 2.0)
        records.append({
            "t": round(max(t, 0.0), 4),
            "template": (i * 7) % 5,
            "input_tokens": 96 if i % 3 else 160,
            "output_tokens": 128 if i % 2 else 256,
        })
    return records


@_reg("trace-replay",
      "deterministic synthetic JSONL-schema trace replayed on 70B 1P/2D")
def _trace_replay(n: int = 120, horizon_s: float = 30.0,
                  fast: bool = False, **kw) -> Scenario:
    if fast:
        n, horizon_s = 60, 20.0
    return Scenario(
        name="", description="",
        cluster=ClusterConfig.for_model("llama-3.1-70b", "1P/2D"),
        workload=WorkloadConfig.from_records(
            example_trace_records(n, horizon_s)),
        sim_kwargs=kw)


# Backend parity (analytic vs engine) ----------------------------------------
#
# Tiny trace scenarios crafted so a τ=0 routing decision is a pure function
# of the indexer's insert history on BOTH backends: explicit template
# sequences (no sampling), zero service jitter, a metrics interval longer
# than the run (the analytic router's load view stays frozen at zero, like
# the engine's between serialized requests) and a cache TTL longer than the
# horizon.  Under that protocol the two backends must agree decision-for-
# decision (tests/test_backend_parity.py) — any drift is a control-plane
# coherence bug, not timing noise.

def _parity_cluster(topo: str, decode_workers: Tuple[DecodeWorkerSpec, ...] = ()
                    ) -> ClusterConfig:
    base = ClusterConfig.for_model("llama-3.1-70b", topo)
    return replace(base, service_sigma=0.0, metrics_interval=1000.0,
                   cache_ttl=1000.0,
                   decode_workers=decode_workers)


def _parity_trace(templates, n: int, spacing: float = 0.45,
                  input_tokens: int = 48, output_tokens: int = 16
                  ) -> WorkloadConfig:
    records = [{"t": round(i * spacing, 4),
                "template": templates[i % len(templates)],
                "input_tokens": input_tokens,
                "output_tokens": output_tokens}
               for i in range(n)]
    return replace(WorkloadConfig.from_records(records), num_templates=12)


@_reg("parity-2d-warm",
      "1P/2D backend-parity trace, warm-heavy template cycle (0,1,0,2): "
      "cache-affinity decisions must agree across backends")
def _parity_2d_warm(n: int = 16, fast: bool = False,
                    templates: Tuple[int, ...] = (0, 1, 0, 2),
                    **kw) -> Scenario:
    if fast:
        n = 8
    return Scenario(
        name="", description="",
        cluster=_parity_cluster("1P/2D"),
        workload=_parity_trace(templates, n),
        sim_kwargs=kw)


@_reg("parity-3d-hetero",
      "1P/3D mixed-generation backend-parity trace (cycle 0,1,2,0,1) — "
      "capacity-normalized routing must agree across backends")
def _parity_3d_hetero(n: int = 15, fast: bool = False, **kw) -> Scenario:
    if fast:
        n = 10
    return Scenario(
        name="", description="",
        cluster=_parity_cluster("1P/3D", _mixed_pool()),
        workload=_parity_trace((0, 1, 2, 0, 1), n),
        sim_kwargs=kw)


@_reg("parity-3d-rr",
      "1P/3D backend-parity trace under round-robin routing: templates "
      "spread across the pool, so per-worker overlap VECTORS (not just "
      "the chosen worker) must agree across backends")
def _parity_3d_rr(n: int = 15, fast: bool = False, **kw) -> Scenario:
    if fast:
        n = 9
    kw.setdefault("routing_policy", "round_robin")
    return Scenario(
        name="", description="",
        cluster=_parity_cluster("1P/3D"),
        workload=_parity_trace((0, 1, 2, 0, 1), n),
        sim_kwargs=kw)


@_reg("parity-2d-cold",
      "1P/2D backend-parity trace of all-distinct templates — the full-"
      "miss path (zero overlap everywhere) must agree across backends")
def _parity_2d_cold(n: int = 10, fast: bool = False, **kw) -> Scenario:
    if fast:
        n = 6
    return Scenario(
        name="", description="",
        cluster=_parity_cluster("1P/2D"),
        workload=_parity_trace(tuple(range(10)), n),
        sim_kwargs=kw)


# Routing-policy baseline ----------------------------------------------------

@_reg("70b-1p2d-rr-baseline",
      "70B 1P/2D ramp under static round-robin routing (§9.2 baseline)")
def _70b_rr(concurrency: int = 64, hold_s: float = 120.0,
            fast: bool = False, **kw) -> Scenario:
    if fast:
        kw.setdefault("ramp_s", 5.0)
        hold_s = 20.0
    kw.setdefault("routing_policy", "round_robin")
    return ramp("llama-3.1-70b", "1P/2D", concurrency, hold_s=hold_s, **kw)


# Fabric-aware KV transfer (Game 4) ------------------------------------------
#
# Variants that attach the explicit datacenter-fabric model
# (repro.serving.fabric): every P→D KV transfer becomes a sized
# transmission serializing store-and-forward across NIC / rack-switch /
# spine links, and ``network_aware=True`` adds the congestion-aware quote
# to decode selection.  The congested variant pins a deliberately thin
# NIC so sync-window herding visibly queues transfers — the regime where
# network-aware selection beats cache-affinity-only routing
# (benchmarks/bench_fabric.py gates the win in CI).

def default_fabric() -> FabricConfig:
    """The calibrated default fabric: 25 Gbps NICs price one full 8-block
    transfer at ≈ the legacy flat kv_transfer charge (~13 ms), so
    attaching the fabric preserves the uncongested timing scale."""
    return FabricConfig()


def congested_fabric() -> FabricConfig:
    """A deliberately thin fabric (8 Gbps NICs, halved switching tiers)
    for the congestion experiments: herded transfers queue visibly on
    the victim decode NIC."""
    return FabricConfig(nic_gbps=8.0, rack_gbps=50.0, spine_gbps=50.0)


@_reg("fabric-ramp",
      "70B 1P/4D closed-loop ramp with the explicit fabric attached "
      "(store-and-forward KV transmissions over NIC/rack/spine links)")
def _fabric_ramp(concurrency: int = 64, hold_s: float = 120.0,
                 fast: bool = False, **kw) -> Scenario:
    if fast:
        kw.setdefault("ramp_s", 5.0)
        hold_s = 20.0
    kw.setdefault("fabric", default_fabric())
    return ramp("llama-3.1-70b", "1P/4D", concurrency, hold_s=hold_s, **kw)


@_reg("fabric-drain",
      "elastic 70B pool with fabric attached: Planner flips re-path "
      "future transfers and the drain protocol cancels in-flight "
      "transmissions, refunding their reserved link time")
def _fabric_drain(concurrency: int = 64, hold_s: float = 150.0,
                  fast: bool = False, **kw) -> Scenario:
    kw.setdefault("fabric", default_fabric())
    return _elastic_70b(concurrency=concurrency, hold_s=hold_s, fast=fast,
                        **kw)


@_reg("fabric-scale-64",
      "scale-64 pool on a deliberately thin fabric (8 Gbps NICs): "
      "sync-window herding queues KV transfers on shared decode NICs — "
      "the congested regime where network_aware=True should win")
def _fabric_scale_64(num_requests: int = 100_000, num_templates: int = 64,
                     fast: bool = False, **kw) -> Scenario:
    kw.setdefault("fabric", congested_fabric())
    return _scale_scenario(64, False, num_requests, num_templates, fast,
                           **kw)
