"""repro_torch.core — the SPDL pipeline engine (the paper's contribution).

Public API mirrors the paper's Listing 1: ``PipelineBuilder`` chains plain
Python functions into a thread-pool-backed, queue-connected pipeline driven
by an asyncio event loop on a dedicated scheduler thread.

The engine has no framework code; its modules are copies of
``repro.core``'s.  This package holds the ones the image loader runs.
"""

from .builder import PipelineBuilder
from .errors import OnError, PipelineFailure, PipelineStalled, PipelineStopped
from .pipeline import Pipeline
from .stats import ResourceSampler, StageStatsSnapshot, format_stats
from .trace import NULL_TRACER, Tracer, get_tracer, set_tracer, tracing

__all__ = [
    "PipelineBuilder",
    "Pipeline",
    "OnError",
    "PipelineFailure",
    "PipelineStalled",
    "PipelineStopped",
    "ResourceSampler",
    "StageStatsSnapshot",
    "format_stats",
    "Tracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "tracing",
]
