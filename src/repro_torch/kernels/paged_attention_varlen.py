"""Wrapper of the CUDA ragged paged attention
(``csrc/paged_attention_varlen.cu``).

Replaces the Pallas kernel ``repro.kernels.paged_attention_pallas.
paged_attention_varlen``.  The plain version is
``kernels.ref.ref_paged_attention_varlen``.

Up to head dim 128 the kernel runs one block per (slot, kv head, 16
packed rows).  Above it (gemma3's 256) the rows run on the tensor cores,
``VARLEN_BLOCK_ROWS`` packed rows a block, and each block's visible keys
are split over the context: :func:`varlen_splits`
picks the split count on the host from the geometry alone, the splits'
float32 partials go to the decode's scratch (``paged_attention.
_scratch``, kept per device and stream), and a per-(slot, kv head, row
block) ticket (the decode's zeros, ``paged_attention._tickets``) tells
the last block to merge them in split order.
``kernels.ref.ref_paged_attention_varlen_split`` is its plain version.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel, LaunchCount
from repro_torch.kernels.paged_attention import (DTYPES, NARROW_MAX_DIM,
                                                 SPLIT_MAX, _scratch,
                                                 _sm_count, _tickets,
                                                 check_inputs)

VARLEN_BLOCK_ROWS = 32   # vd::kRows: packed rows a block above head dim 128
VARLEN_STAGE_KEYS = 32   # d256::kKeys: a split's keys round up to it
VARLEN_MIN_KEYS = 64     # the floor of keys a split: short contexts take one

# q, k, v, tables, row_start, row_len, out, part, tickets | B T H KV NB BS
# D M window n_splits min_keys | scale dtype stream
KERNEL = Kernel("paged_attention_varlen",
                [c_void_p] * 9 + [c_int] * 11 + [c_float, c_int, c_void_p])
# Launches of this kernel at the fixed-T verify shape (the launches made
# with ``count=MULTI``; each is counted in ``KERNEL`` as well).
MULTI = LaunchCount("paged_attention_multi")


def plan_varlen_splits(groups: int, span: int, sms: int) -> int:
    """Context splits of each of a slot's ``groups`` (kv head, row block)
    pairs whose rows see at most ``span`` keys, on a card of ``sms`` SMs:
    one slot's blocks fill the SMs once (a block takes an SM: its shared
    memory), none under ``VARLEN_MIN_KEYS`` keys (so a short span takes
    one), at most ``SPLIT_MAX``.  Per slot, not per call: the host does
    not know which slots are idle (the chunked long prompt's round has
    one live slot of four), and a call whose slots are all live runs
    ``B`` such waves.  From a sweep of forced counts at gemma3's widths
    on an H100 (``chip_smoke.py --ab SRC d256``'s ``ab_varlen_splits``
    lines; ``PERF.md``)."""
    if span <= VARLEN_MIN_KEYS:
        return 1
    return max(1, min(sms // max(groups, 1), -(-span // VARLEN_MIN_KEYS),
                      SPLIT_MAX))


def varlen_splits(q_len: int, heads: int, kv_heads: int, max_blocks: int,
                  block_size: int, window: Optional[int], sms: int) -> int:
    """The split count of one call above head dim 128 at these sizes: a
    slot's (kv head, row block) pairs and the longest span a table of
    ``max_blocks`` pages of ``block_size`` rows can hold, capped by the
    window plus the tokens of one block's rows."""
    g = heads // kv_heads
    span = max_blocks * block_size
    if window is not None:
        span = min(span, int(window) + VARLEN_BLOCK_ROWS // g)
    groups = kv_heads * -(-q_len * g // VARLEN_BLOCK_ROWS)
    return plan_varlen_splits(groups, span, sms)


def paged_attention_varlen_cuda(
    q: torch.Tensor,             # [B, T, H, D]
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    row_start: torch.Tensor,     # [B] int32
    row_len: torch.Tensor,       # [B] int32
    *,
    window: Optional[int] = None,
    count: Optional[LaunchCount] = None,
) -> torch.Tensor:
    """Ragged multi-row attention over the paged pool ([B, T, H, D]);
    above head dim 128 split over the context (:func:`varlen_splits`).
    ``count``, when given, adds one once the launch went through (the
    verify shape's ``MULTI``)."""
    if q.dim() != 4:
        raise ValueError(f"{KERNEL.name}: q must be [B, T, H, D]")
    check_inputs(KERNEL.name, q, k_pages, v_pages, block_tables,
                 (row_start, row_len))
    b, t, h, d = q.shape
    kv, nb, bs, _ = k_pages.shape
    m = block_tables.shape[1]
    out = torch.empty_like(q)
    n_splits, part, tickets = 1, None, None
    if d > NARROW_MAX_DIM:
        n_splits = varlen_splits(t, h, kv, m, bs, window,
                                 _sm_count(q.device))
        if n_splits > 1:
            part = _scratch(q.device, b * t * h * n_splits * (d + 2))
            tickets = _tickets(
                q.device, b * kv * -(-t * (h // kv) // VARLEN_BLOCK_ROWS))
    KERNEL.launch(q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_tables.data_ptr(),
                  row_start.data_ptr(), row_len.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if tickets is None else tickets.data_ptr(),
                  b, t, h, kv, nb, bs, d, m,
                  -1 if window is None else int(window), n_splits,
                  VARLEN_MIN_KEYS, d ** -0.5, DTYPES[q.dtype])
    if count is not None:
        count.add()
    return out
