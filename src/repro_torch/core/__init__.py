"""repro_torch.core — the SPDL pipeline engine (the paper's contribution).

Public API mirrors the paper's Listing 1: ``PipelineBuilder`` chains plain
Python functions into a thread-pool-backed, queue-connected pipeline driven
by an asyncio event loop on a dedicated scheduler thread.

The engine has no framework code; its modules are copies of
``repro.core``'s: the engine, and beside it the health monitor, the
metrics exporter, fault injection and autotuning.
"""

from .autotune import Suggestion, autotune, suggest
from .builder import PipelineBuilder
from .chaos import ChaosError, FaultInjectingStage
from .errors import OnError, PipelineFailure, PipelineStalled, PipelineStopped
from .health import (
    DegradeAction,
    HealthMonitor,
    StageHealth,
    disable_verify,
    origin_only,
    shrink_replication,
    widen_sparse_threshold,
)
from .metrics import MetricsExporter, MetricsServer, StatsHistory, WindowRates
from .pipeline import Pipeline
from .stats import ResourceSampler, StageStatsSnapshot, format_stats
from .trace import NULL_TRACER, Tracer, get_tracer, set_tracer, tracing

__all__ = [
    "PipelineBuilder",
    "autotune",
    "suggest",
    "Suggestion",
    "Pipeline",
    "OnError",
    "PipelineFailure",
    "PipelineStalled",
    "PipelineStopped",
    "HealthMonitor",
    "StageHealth",
    "ChaosError",
    "FaultInjectingStage",
    "DegradeAction",
    "disable_verify",
    "widen_sparse_threshold",
    "shrink_replication",
    "origin_only",
    "ResourceSampler",
    "StageStatsSnapshot",
    "format_stats",
    "Tracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "tracing",
    "StatsHistory",
    "WindowRates",
    "MetricsExporter",
    "MetricsServer",
]
