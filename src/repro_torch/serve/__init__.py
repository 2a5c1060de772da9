"""Continuous-batching serve engine of the port (paged KV cache)."""
from repro_torch.serve.engine import (
    ServedTrajectory,
    ServeEngine,
    ServeStats,
    resolve_device,
)
from repro_torch.serve.paged_cache import BlockAllocator, make_allocator
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)

__all__ = [
    "BlockAllocator",
    "ContinuousBatchingScheduler",
    "Request",
    "RequestState",
    "ServeEngine",
    "ServeStats",
    "ServedTrajectory",
    "make_allocator",
    "resolve_device",
]
