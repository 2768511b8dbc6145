# The paper's primary contribution: the three coupled games of disaggregated
# inference, the empirical PoA estimator, and the adaptive routing controller.
from repro_torch.core.controller import AdaptiveRouter, DualFrontend, REGIME_PARAMS  # noqa: F401
from repro_torch.core.games import CacheGame, RoutingGame, singular_game  # noqa: F401
from repro_torch.core.kvbm import KVBlockManager  # noqa: F401
from repro_torch.core.latency import LatencyParams, latency, routing_cost  # noqa: F401
from repro_torch.core.metrics import MetricsRegistry  # noqa: F401
from repro_torch.core.planner import Planner, PlannerConfig, variational_equilibrium  # noqa: F401
from repro_torch.core.poa import CompletedRequest, PoATracker, hungarian  # noqa: F401
from repro_torch.core.radix import KvIndexer, block_hashes  # noqa: F401
from repro_torch.core.router import (KvPushRouter, KvRouterConfig,  # noqa: F401
                               PowerOfTwoRouter, RandomRouter, RoundRobinRouter)
from repro_torch.core.saturation import DetectorConfig, Regime, SaturationDetector  # noqa: F401
