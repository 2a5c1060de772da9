"""Observability: span tracer, metrics registry, trace exporters."""
from repro_torch.obs.perfetto import (
    export_perfetto,
    export_trace_jsonl,
    trace_annotation,
)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer, make_tracer

__all__ = [
    "MetricsRegistry",
    "NULL_TRACER",
    "Tracer",
    "export_perfetto",
    "export_trace_jsonl",
    "make_tracer",
    "trace_annotation",
]
