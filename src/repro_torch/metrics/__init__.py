from repro_torch.metrics.runtime_metrics import (
    LagHistogram,
    RuntimeQueueStats,
    collect_runtime_stats,
    collect_serve_stats,
    serve_latency_counts,
    serve_latency_stats,
)

__all__ = [
    "LagHistogram",
    "RuntimeQueueStats",
    "collect_runtime_stats",
    "collect_serve_stats",
    "serve_latency_counts",
    "serve_latency_stats",
]
