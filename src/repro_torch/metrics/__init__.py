from repro_torch.metrics.aggregate import (
    aggregate_metrics,
    auc,
    iqm,
    mean,
    median,
    minmax_normalize,
    optimality_gap,
    stratified_bootstrap_ci,
)
from repro_torch.metrics.runtime_metrics import (
    LagHistogram,
    RuntimeQueueStats,
    collect_runtime_stats,
    collect_serve_stats,
    serve_latency_counts,
    serve_latency_stats,
)

__all__ = [
    "aggregate_metrics",
    "auc",
    "iqm",
    "mean",
    "median",
    "minmax_normalize",
    "optimality_gap",
    "stratified_bootstrap_ci",
    "LagHistogram",
    "RuntimeQueueStats",
    "collect_runtime_stats",
    "collect_serve_stats",
    "serve_latency_counts",
    "serve_latency_stats",
]
