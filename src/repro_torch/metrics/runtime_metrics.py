# Copied from src/repro/metrics/runtime_metrics.py; keep the two in step.
"""Observability for the async actor-learner runtime.

Per-version lag histograms, queue depth, and admission-drop rates — the
paper's Fig. 1 "degree of asynchronicity" made measurable on a live run
instead of being a configuration constant.  Everything is host-side
Python (no jax), cheap enough to update on every queue operation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


class LagHistogram:
    """Counter over integer policy lags (learner_version - behavior_version)."""

    def __init__(self) -> None:
        self._counts: Dict[int, int] = {}

    def record(self, lag: int, n: int = 1) -> None:
        lag = int(lag)
        self._counts[lag] = self._counts.get(lag, 0) + n

    def snapshot(self) -> Dict[int, int]:
        return dict(sorted(self._counts.items()))


@dataclass(frozen=True)
class RuntimeQueueStats:
    """One consistent snapshot of a TrajectoryQueue's counters."""

    depth: int
    puts: int
    admitted: int
    dropped: int
    downweighted: int
    admission_drop_rate: float
    drops_by_reason: Dict[str, int] = field(default_factory=dict)
    lag_histogram: Dict[int, int] = field(default_factory=dict)
    controller: str = ""
    downweights_by_reason: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "depth": self.depth,
            "puts": self.puts,
            "admitted": self.admitted,
            "dropped": self.dropped,
            "downweighted": self.downweighted,
            "admission_drop_rate": self.admission_drop_rate,
            "drops_by_reason": dict(self.drops_by_reason),
            "lag_histogram": {
                str(k): v for k, v in self.lag_histogram.items()
            },
            "controller": self.controller,
            "downweights_by_reason": dict(self.downweights_by_reason),
        }


def collect_serve_stats(engine: Any) -> Dict[str, Any]:
    """JSON-ready view of a ServeEngine: decode/occupancy counters plus
    the paged-pool and scheduler state (the serve-side analogue of
    :func:`collect_runtime_stats`).

    Speculative runs additionally report the acceptance rate (accepted
    draft tokens / drafted; ``as_dict`` computes it), drafted-vs-emitted
    token counts, the draft slot's policy version, the
    **draft-version lag histogram**: per emitted token, how many
    publishes the draft policy lagged the verifier — the serve-side
    mirror of the runtime's behavior-policy lag histograms — and the
    **chosen-k histogram**: how many speculative rounds ran each draft
    length (constant at ``speculate_k`` unless ``speculate_adaptive``
    shrinks low-acceptance rounds).

    Sharded engines (``mesh``) add per-shard pool and placement
    counters: free pages and live decode slots by shard.

    Prefix-cached engines (``prefix_cache=True``) add the cache's
    effectiveness counters: admission hit rate, matched vs computed
    prefill tokens (the token-level hit rate), COW copies, resident
    zero-ref cached pages and LRU evictions; window-reclaiming engines
    report pages released behind the sliding window.

    Engines carrying an ``obs.MetricsRegistry`` (all of them, since
    the engine creates one by default) additionally report serve-time
    latency percentiles straight from the registry's histograms —
    TTFT (submit -> first token) plus its queue-wait vs
    prefill-compute decomposition, inter-token gap, admission
    queue-wait, end-to-end request latency and swap-to-first-stale-
    token — as ``{ttft,ttft_queue,ttft_prefill,inter_token,queue_wait,
    request_latency,swap_to_stale}_{count,mean_ms,p50_ms,p99_ms}``.
    Benchmarks source
    their timing columns from the same histograms, so benchmark
    numbers and live telemetry cannot disagree.
    """
    alloc = engine.allocator
    sched = engine.scheduler
    out = dict(engine.stats.as_dict())
    out.update({
        "policy_version": engine.version,
        "pool_blocks": alloc.num_blocks,
        "pool_blocks_free": alloc.num_free,
        "pool_utilization": (
            1.0 - alloc.num_free / alloc.num_blocks
            if alloc.num_blocks else 0.0
        ),
        "block_size": alloc.block_size,
        "waiting": len(sched.waiting),
        "running": len(sched.running),
        "speculate_k": getattr(engine, "speculate_k", 0),
    })
    draft = getattr(engine, "draft", None)
    if draft is not None:
        out["draft_version"] = draft.version
        out["draft_version_lag_histogram"] = {
            str(k): v
            for k, v in engine._draft_lag_hist.snapshot().items()
        }
        out["speculate_adaptive"] = getattr(
            engine, "speculate_adaptive", False)
        out["chosen_k_histogram"] = {
            str(k): v
            for k, v in engine._chosen_k_hist.snapshot().items()
        }
    if getattr(alloc, "num_shards", 1) > 1:
        out["num_shards"] = alloc.num_shards
        out["pool_free_by_shard"] = alloc.free_by_shard()
        out["live_slots_by_shard"] = sched._live_slots_by_shard()
    if getattr(alloc, "prefix_cache", False):
        matched = sched.prefix_matched_tokens
        computed = engine.stats.prefill_tokens
        out.update({
            "prefix_cache": True,
            "prefix_queries": sched.prefix_queries,
            "prefix_hits": sched.prefix_hits,
            "prefix_hit_rate": (
                sched.prefix_hits / sched.prefix_queries
                if sched.prefix_queries else 0.0),
            "prefix_matched_tokens": matched,
            "prefix_token_hit_rate": (
                matched / (matched + computed)
                if (matched + computed) else 0.0),
            "cached_pages": alloc.num_cached,
            "cache_evictions": alloc.evictions,
        })
    if getattr(engine, "_reclaim_window", None) is not None:
        out["reclaim_window"] = engine._reclaim_window
        out["reclaimed_window_pages"] = sched.reclaimed_pages
    out["spec_disabled"] = bool(getattr(engine, "spec_disabled", False))
    out["timeouts_by_state"] = dict(getattr(sched, "timeouts_by_state", {}))
    metrics = getattr(engine, "metrics", None)
    if metrics is not None:
        out.update(serve_latency_stats(metrics))
        resilience = collect_resilience_stats(
            metrics, store=getattr(engine, "store", None),
            injector=getattr(engine, "injector", None))
        if resilience:
            out["resilience"] = resilience
    return out


# Registry histogram name -> flat-key prefix in collect_serve_stats.
# ttft decomposes exactly into ttft_queue (submit -> the admission that
# produced the first token) + ttft_prefill (that admission -> first
# token): under chunked prefill the second term is what the dispatch
# budget bounds, so the split shows whether a slow first token is
# queueing or prompt compute.
SERVE_LATENCY_HISTOGRAMS = (
    ("serve_ttft_s", "ttft"),
    ("serve_ttft_queue_s", "ttft_queue"),
    ("serve_ttft_prefill_s", "ttft_prefill"),
    ("serve_inter_token_s", "inter_token"),
    ("serve_queue_wait_s", "queue_wait"),
    ("serve_request_latency_s", "request_latency"),
    ("serve_swap_to_stale_s", "swap_to_stale"),
)


def serve_latency_stats(metrics: Any,
                        starts: Any = None) -> Dict[str, Any]:
    """Flat latency keys (ms) from a registry's serve histograms.

    ``starts`` (a ``{hist_name: count}`` dict, e.g. captured before a
    benchmark run) restricts each histogram to observations made after
    that count — the windowed read benchmarks use on a registry shared
    across repeats.
    """
    out: Dict[str, Any] = {}
    for name, key in SERVE_LATENCY_HISTOGRAMS:
        h = metrics.histogram(name)
        s = h.summary(start=None if starts is None else starts.get(name))
        out[f"{key}_count"] = int(s["count"])
        out[f"{key}_mean_ms"] = s["mean"] * 1e3
        out[f"{key}_p50_ms"] = s["p50"] * 1e3
        out[f"{key}_p99_ms"] = s["p99"] * 1e3
    return out


def serve_latency_counts(metrics: Any) -> Dict[str, int]:
    """Current observation counts per serve histogram — pass back to
    :func:`serve_latency_stats` as ``starts`` for a windowed read."""
    return {name: metrics.histogram(name).count
            for name, _ in SERVE_LATENCY_HISTOGRAMS}


# Fault/recovery counters surfaced by collect_{runtime,serve}_stats —
# the names the resilience layer increments (repro.resilience plus the
# hooks in policy_store/queue/scheduler/engine/trainer).
RESILIENCE_COUNTERS = (
    "fault_injected_total",
    "watchdog_restart_total",
    "request_timeout_total",
    "publish_quarantined_total",
    "admission_fallback_total",
    "restart_admitted_total",
    "learner_nonfinite_total",
    "spec_autodisable_total",
)


def collect_resilience_stats(registry: Any, store: Any = None,
                             injector: Any = None) -> Dict[str, Any]:
    """Fault-injection and recovery counters as one JSON-ready block.

    Reads labelled counters via ``registry.counter_values`` (never
    ``snapshot()`` — this function runs *inside* snapshot producers),
    plus the store's quarantine ledger and the injector's fired-fault
    tally when available.
    """
    out: Dict[str, Any] = {}
    if registry is not None and hasattr(registry, "counter_values"):
        out["counters"] = registry.counter_values(*RESILIENCE_COUNTERS)
    if store is not None and hasattr(store, "quarantined_versions"):
        out["quarantined_versions"] = sorted(store.quarantined_versions())
    if injector is not None and getattr(injector, "active", False):
        out["faults_fired"] = dict(injector.fired_counts())
    return out


def collect_runtime_stats(store: Any, queue: Any) -> Dict[str, Any]:
    """Joined store+queue view, JSON-ready, for launchers and examples."""
    stats = queue.stats()
    hist = stats.lag_histogram
    total = sum(hist.values())
    mean_lag = (
        sum(k * v for k, v in hist.items()) / total if total else 0.0
    )
    out = {
        "policy_version": store.version,
        "retained_versions": store.retained_versions(),
        "queue": stats.as_dict(),
        "mean_lag": mean_lag,
        "max_lag": max(hist) if hist else 0,
        # The labelled-counter view of the same decisions, keyed by the
        # active controller (satisfies dashboards that join on the
        # queue_admission_total{controller,outcome,reason} counters).
        "admission": {
            "controller": stats.controller,
            "drops_by_reason": dict(stats.drops_by_reason),
            "downweights_by_reason": dict(stats.downweights_by_reason),
        },
    }
    counters_fn = getattr(queue, "admission_counters", None)
    if counters_fn is not None:
        out["admission"]["counters"] = counters_fn()
    resilience = collect_resilience_stats(
        getattr(queue, "registry", None), store=store,
        injector=getattr(queue, "injector", None))
    if resilience:
        out["resilience"] = resilience
    return out
