"""Plain PyTorch versions of the kernels (ports of ``repro.kernels.ref``).

Each function is the semantic ground truth its CUDA kernel must
reproduce.  They run on any device: the CPU path of ``kernels.ops``
calls them, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  Scores accumulate in float32 whatever the input dtype,
and probabilities are cast back to the query dtype before the value
product, exactly as the JAX oracles do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e30


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """``[KV, NB, BS, D]`` pool through ``[B, M]`` tables -> ``[KV, B, M*BS, D]``."""
    kv, _, _, d = pages.shape
    b = block_tables.shape[0]
    return pages[:, block_tables.long()].reshape(kv, b, -1, d)


def ref_paged_attention(
    q: torch.Tensor,             # [B, H, D] one query token per request
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,       # [KV, NB, BS, D]
    block_tables: torch.Tensor,  # [B, M] int32 page ids (pads in range)
    context_lens: torch.Tensor,  # [B] int32 (0 = inactive -> zero output)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token decode attention; the query's own K/V row is
    expected at position ``context_lens[b] - 1``."""
    kv, _, _, d = k_pages.shape
    b, h, _ = q.shape
    g = h // kv
    scale = d ** -0.5
    keys = _gather_pages(k_pages, block_tables)
    vals = _gather_pages(v_pages, block_tables)
    qg = q.reshape(b, kv, g, d)
    scores = torch.einsum("bkgd,kbsd->bkgs", (qg * scale).float(),
                          keys.float())
    ctx = context_lens.to(torch.int32)
    pos = torch.arange(keys.shape[2], dtype=torch.int32,
                       device=q.device)[None, :]
    valid = pos < ctx[:, None]
    if window is not None:
        valid = valid & ((ctx[:, None] - 1 - pos) < window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,kbsd->bkgd", probs, vals)
    out = torch.where((ctx > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, h, d)


def ref_paged_attention_varlen(
    q: torch.Tensor,             # [B, T, H, D] ragged query chunks
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,       # [KV, NB, BS, D]
    block_tables: torch.Tensor,  # [B, M] int32
    row_start: torch.Tensor,     # [B] int32 abs position of query row 0
    row_len: torch.Tensor,       # [B] int32 live rows (0 = inactive)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged multi-token paged attention: query ``t < row_len[b]`` sits
    at ``row_start[b] + t`` and attends causally over its own prefix;
    padding rows and ``row_len == 0`` slots come back exactly zero."""
    kv, _, _, d = k_pages.shape
    b, t, h, _ = q.shape
    g = h // kv
    scale = d ** -0.5
    dev = q.device
    row_start = row_start.to(torch.int32)
    row_len = row_len.to(torch.int32)
    keys = _gather_pages(k_pages, block_tables)
    vals = _gather_pages(v_pages, block_tables)
    qg = q.reshape(b, t, kv, g, d)
    scores = torch.einsum("btkgd,kbsd->bkgts", (qg * scale).float(),
                          keys.float())
    pos = torch.arange(keys.shape[2], dtype=torch.int32,
                       device=dev)[None, None, :]
    qpos = (row_start[:, None] + torch.arange(t, dtype=torch.int32,
                                              device=dev)[None, :])[:, :, None]
    valid = pos <= qpos                                    # [B, T, S]
    if window is not None:
        valid = valid & ((qpos - pos) < window)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,kbsd->btkgd", probs, vals)
    row_live = (torch.arange(t, dtype=torch.int32, device=dev)[None, :]
                < row_len[:, None])                        # [B, T]
    out = torch.where(row_live[:, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, t, h, d)


def ref_paged_attention_multi(
    q: torch.Tensor,             # [B, T, H, D] consecutive query tokens
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,  # [B] rows live *including* the T chunk
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fixed-``T`` shape of :func:`ref_paged_attention_varlen`."""
    row_start, row_len = multi_rows(context_lens, q.shape[1])
    return ref_paged_attention_varlen(
        q, k_pages, v_pages, block_tables, row_start, row_len,
        window=window)


def multi_rows(context_lens: torch.Tensor, t: int):
    """``(row_start, row_len)`` of the fixed-``T`` verify shape."""
    ctx = context_lens.to(torch.int32)
    active = ctx > 0
    zero = torch.zeros_like(ctx)
    return (torch.where(active, ctx - t, zero),
            torch.where(active, torch.full_like(ctx, t), zero))


def masked_inplace_update(
    arr: torch.Tensor,
    new: torch.Tensor,
    start: Sequence[int],
    valid,   # bool (or bool tensor broadcastable to `new`)
) -> torch.Tensor:
    """Write ``new`` into ``arr`` at ``start`` where ``valid``, keeping
    the old values elsewhere.  Updates ``arr`` in place and returns it
    (the JAX oracle returns a new array that XLA updates in place)."""
    view = arr[tuple(slice(int(s), int(s) + n)
                     for s, n in zip(start, new.shape))]
    view.copy_(torch.where(torch.as_tensor(valid, device=arr.device),
                           new.to(arr.dtype), view))
    return arr


def ref_paged_kv_write(
    k_pages: torch.Tensor,   # [L, KV, NB, BS, D]
    v_pages: torch.Tensor,   # [L, KV, NB, BS, D]
    k_rows: torch.Tensor,    # [N, KV, D] new key rows
    v_rows: torch.Tensor,    # [N, KV, D]
    page_idx: torch.Tensor,  # [N] int32 destination page per row
    offset: torch.Tensor,    # [N] int32 destination row within the page
    active: torch.Tensor,    # [N] bool; False rows write nothing
    *,
    layer: int,
):
    """Write row n at ``pages[layer, :, page_idx[n], offset[n], :]`` for
    every active n, in place; returns the (same) pools.

    Distinct active rows never share a destination (allocator
    invariant), so one indexed assignment over the active rows equals
    the JAX oracle's per-slot chain."""
    sel = torch.nonzero(active.to(torch.bool)).reshape(-1)
    pidx = page_idx.long()[sel]
    off = offset.long()[sel]
    for pages, rows in ((k_pages, k_rows), (v_pages, v_rows)):
        # [KV, n, D] rows land at [KV, page, offset, D] of this layer.
        pages[layer][:, pidx, off, :] = \
            rows[sel].to(pages.dtype).transpose(0, 1)
    return k_pages, v_pages


# ---------------------------------------------------------------------------
# Fused per-token log-prob (the RLVR learner's hot spot)
# ---------------------------------------------------------------------------


def ref_logprobs_from_logits(
    logits: torch.Tensor,    # [N, V] (callers flatten [B, S, V])
    targets: torch.Tensor,   # [N] int
) -> torch.Tensor:
    """log softmax gathered at targets, float32 accumulation."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, 1, targets.long()[:, None])[:, 0]
    return tgt - lse


def ref_entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-row softmax entropy, float32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(torch.exp(lp) * lp, dim=-1)


def ref_logprobs_backward(
    logits: torch.Tensor,           # [N, V]
    targets: torch.Tensor,          # [N] int
    lse: torch.Tensor,              # [N] float32 logsumexp of each row
    ent: torch.Tensor,              # [N] float32 entropy of each row
    g_lp: Optional[torch.Tensor],   # [N] gradient of logp, or None
    g_ent: Optional[torch.Tensor],  # [N] gradient of ent, or None
) -> torch.Tensor:
    """Gradient of ``sum(g_lp * logp + g_ent * ent)`` w.r.t. the logits,
    in their dtype: with ``p = exp(x - lse)`` and ``H = ent``,
    ``dx = g_lp * (onehot(t) - p) - g_ent * p * (x - lse + H)``.  An
    absent gradient contributes nothing."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    dx = torch.zeros_like(x)
    if g_lp is not None:
        onehot = torch.zeros_like(x).scatter_(1, targets.long()[:, None], 1.0)
        dx = dx + g_lp[:, None] * (onehot - p)
    if g_ent is not None:
        dx = dx - g_ent[:, None] * p * (x - lse[:, None] + ent[:, None])
    return dx.to(logits.dtype)
