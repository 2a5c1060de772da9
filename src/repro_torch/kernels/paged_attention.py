"""Wrapper of the CUDA paged decode attention (``csrc/paged_attention.cu``).

Replaces the Pallas kernel ``repro.kernels.paged_attention_pallas.
paged_attention``.  The plain version is ``kernels.ref.ref_paged_attention``.

Up to head dim 128 the kernel runs one block per (slot, kv head, 16 group
heads).  Above it (gemma3's 256) the decode is split over each slot's
visible keys (``csrc/paged_attention_split.cuh``): :func:`plan_splits`
picks the split count on the host from the geometry alone, the wrapper
allocates the splits' float32 partials, and a per-(slot, kv head) ticket
(zeros kept per device and stream, which the kernel leaves zero) tells
the last block to merge them in split order.
``kernels.ref.ref_paged_attention_split`` is the split's plain version.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.build import Kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256   # paged::kMaxHeadDim (gemma3)
NARROW_MAX_DIM = 128   # paged::Narrow: the row-tile routine; above, splits
SPLIT_STAGE_KEYS = 16  # paged::split::kKeys: a split's keys round up to it
SPLIT_MIN_KEYS = 64    # the floor of keys a split: short contexts take one
SPLIT_MAX = 32         # paged::split::kMaxSplits: splits a (slot, kv head)
SPLIT_MAX_ROWS = 8     # paged::split::kMaxRows: group heads a block
SPLIT_WAVES = 2        # the most blocks, in multiples of the SM count

# q, k, v, tables, context_lens, out, part, tickets | B H KV NB BS D M
# window n_splits min_keys | scale dtype stream
KERNEL = Kernel("paged_attention",
                [c_void_p] * 8 + [c_int] * 10 + [c_float, c_int, c_void_p])


def plan_splits(groups: int, span: int, sms: int) -> int:
    """Context splits of each of ``groups`` (slot, kv head, row tile)
    triples whose longest visible span is ``span`` keys, on a card of
    ``sms`` SMs: at most ``SPLIT_WAVES`` blocks an SM in all, no split
    under ``SPLIT_MIN_KEYS`` keys (so a short context takes one), at most
    ``SPLIT_MAX``.  The constants come from a sweep of forced counts at
    gemma3's widths on an H100 (``chip_smoke.py --ab SRC d256``'s
    ``ab_paged_splits`` lines; ``PERF.md``)."""
    if span <= SPLIT_MIN_KEYS:
        return 1
    want = SPLIT_WAVES * sms // max(groups, 1)
    return max(1, min(want, -(-span // SPLIT_MIN_KEYS), SPLIT_MAX))


def split_chunk(span: int, n_splits: int, min_keys: int = SPLIT_MIN_KEYS,
                stage: int = SPLIT_STAGE_KEYS) -> int:
    """Keys each non-empty split of a ``span``-key context takes (as
    ``paged::split::split_chunk``): ``span / n_splits`` rounded up, at
    least ``min_keys``, rounded up to a whole ``stage``."""
    c = max(-(-span // n_splits), min_keys)
    return -(-c // stage) * stage


def split_geometry(batch: int, heads: int, kv_heads: int, max_blocks: int,
                   block_size: int, window: Optional[int], sms: int
                   ) -> int:
    """The split count of one call at these sizes: the longest span a
    table of ``max_blocks`` pages of ``block_size`` rows can hold, capped
    by the window; row tiles of up to ``SPLIT_MAX_ROWS`` group heads."""
    span = max_blocks * block_size
    if window is not None:
        span = min(span, int(window))
    tiles = -(-(heads // kv_heads) // SPLIT_MAX_ROWS)
    return plan_splits(batch * kv_heads * tiles, span, sms)


_SMS: Dict[int, int] = {}
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the current stream of ``device``:
    a call leaves them zero, and calls on one stream never overlap."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    return t


def check_inputs(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 lens: Sequence[torch.Tensor]) -> None:
    """Device, dtype, contiguity, shape and alignment checks shared by
    the two paged-attention wrappers (q is [B, H, D] or [B, T, H, D]).
    The kernels stage K/V rows by 16-byte ``cp.async``: the pools must
    start on a 16-byte boundary and the head dim be a multiple of 8."""
    tensors = (q, k_pages, v_pages, block_tables) + tuple(lens)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"{name}: q and pages must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (block_tables,) + tuple(lens)):
        raise TypeError(f"{name}: tables and lengths must be int32")
    b = q.shape[0]
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape or \
            q.shape[-1] != k_pages.shape[3] or \
            q.shape[-2] % k_pages.shape[0] or block_tables.dim() != 2 or \
            block_tables.shape[0] != b or any(t.shape != (b,) for t in lens):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)} tables "
                         f"{tuple(block_tables.shape)}")
    d = k_pages.shape[3]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: k_pages and v_pages must start on a "
                         "16-byte boundary")


def paged_attention_cuda(
    q: torch.Tensor,             # [B, H, D]
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention over the paged pool ([B, H, D]);
    above head dim 128 split over the context (:func:`split_geometry`)."""
    if q.dim() != 3:
        raise ValueError(f"{KERNEL.name}: q must be [B, H, D]")
    check_inputs(KERNEL.name, q, k_pages, v_pages, block_tables,
                 (context_lens,))
    b, h, d = q.shape
    kv, nb, bs, _ = k_pages.shape
    m = block_tables.shape[1]
    out = torch.empty_like(q)
    n_splits, part, tickets = 1, None, None
    if d > NARROW_MAX_DIM:
        n_splits = split_geometry(b, h, kv, m, bs, window,
                                  _sm_count(q.device))
        if n_splits > 1:
            part = torch.empty(b * h * n_splits * (d + 2),
                               dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device, b * h)
    KERNEL.launch(q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_tables.data_ptr(),
                  context_lens.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if tickets is None else tickets.data_ptr(),
                  b, h, kv, nb, bs, d, m,
                  -1 if window is None else int(window), n_splits,
                  SPLIT_MIN_KEYS, d ** -0.5, DTYPES[q.dtype])
    return out
