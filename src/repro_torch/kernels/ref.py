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

from repro_torch.core.vtrace import vtrace
from repro_torch.kernels.paged_attention import (SPLIT_MIN_KEYS,
                                                 SPLIT_STAGE_KEYS,
                                                 split_chunk)
from repro_torch.kernels.paged_attention_varlen import (VARLEN_BLOCK_ROWS,
                                                        VARLEN_MIN_KEYS,
                                                        VARLEN_STAGE_KEYS)

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


def ref_paged_attention_split(
    q: torch.Tensor,             # [B, H, D]
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32 (0 = inactive -> zero output)
    *,
    window: Optional[int] = None,
    n_splits: int = 1,
    min_keys: int = SPLIT_MIN_KEYS,
    stage: int = SPLIT_STAGE_KEYS,
) -> torch.Tensor:
    """The decode split over the context, as the kernel above head dim
    128 computes it (``csrc/paged_attention_split.cuh``): slot b's visible
    keys ``[first, ctx - 1]`` cut into spans of ``split_chunk`` keys (the
    later of ``n_splits`` splits may see none); per split, in float32,
    its max ``m``, sum ``l`` and unnormalised values ``acc``; then the
    splits that see a key merged in split order: ``M = max m_s``,
    ``l = sum l_s exp(m_s - M)``, ``acc`` likewise, ``out = acc /
    max(l, 1e-30)``.  ``ctx == 0`` gives zeros.  The probabilities stay
    float32 (the kernel's, not the JAX oracle's cast to q's dtype)."""
    kv, _, _, d = k_pages.shape
    b, h, _ = q.shape
    keys = _gather_pages(k_pages, block_tables).float()
    vals = _gather_pages(v_pages, block_tables).float()
    qg = q.reshape(b, kv, h // kv, d).float() * d ** -0.5
    out = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    for bi, ctx in enumerate(context_lens.tolist()):
        if ctx <= 0:
            continue
        first = 0 if window is None else max(0, ctx - int(window))
        chunk = split_chunk(ctx - first, n_splits, min_keys, stage)
        parts = []
        for lo in range(first, ctx, chunk)[:n_splits]:
            hi = min(ctx, lo + chunk)
            s = torch.einsum("kgd,ksd->kgs", qg[bi], keys[:, bi, lo:hi])
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgs,ksd->kgd", p, vals[:, bi, lo:hi])))
        m_all = parts[0][0]
        for m, _, _ in parts[1:]:
            m_all = torch.maximum(m_all, m)
        l_all, acc = torch.zeros_like(m_all), torch.zeros_like(out[bi])
        for m, l, a in parts:
            scale = torch.exp(m - m_all)
            l_all = l_all + l * scale
            acc = acc + a * scale[..., None]
        out[bi] = acc / l_all.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


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


def ref_paged_attention_varlen_split(
    q: torch.Tensor,             # [B, T, H, D] ragged query chunks
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    row_start: torch.Tensor,     # [B] int32 abs position of query row 0
    row_len: torch.Tensor,       # [B] int32 live rows (0 = inactive)
    *,
    window: Optional[int] = None,
    n_splits: int = 1,
    min_keys: int = VARLEN_MIN_KEYS,
    stage: int = VARLEN_STAGE_KEYS,
    block_rows: int = VARLEN_BLOCK_ROWS,
) -> torch.Tensor:
    """The ragged rows split over the context, as the kernel above head
    dim 128 computes them (``csrc/paged_attention_varlen.cu``,
    ``varlen_d256_kernel``): a slot's live rows packed (token x group
    head) into blocks of ``block_rows`` (the kernel's 32 by default); a
    block's visible keys ``[first, last]`` (its
    oldest row's window start, its newest row's position) cut into spans
    of ``split_chunk`` keys (the later of ``n_splits`` splits may see
    none); per split, in float32, each row's max ``m`` over the keys it
    sees (its own causal end and window), its sum ``l`` and unnormalised
    values ``acc``; then the splits merged in split order: ``M = max
    m_s``, ``l = sum l_s exp(m_s - M)``, ``acc`` likewise, ``out = acc /
    max(l, 1e-30)``.  Padding rows and idle slots give zeros.  The
    probabilities stay float32 (the kernel's, not the JAX oracle's cast
    to q's dtype)."""
    kv, _, _, d = k_pages.shape
    b, t, h, _ = q.shape
    g = h // kv
    rows = t * g
    keys = _gather_pages(k_pages, block_tables).float()
    vals = _gather_pages(v_pages, block_tables).float()
    # Packed rows [B, KV, T * G, D]: row r is token r // g, head kv g + r % g.
    qp = (q * d ** -0.5).float().reshape(b, t, kv, g, d).permute(
        0, 2, 1, 3, 4).reshape(b, kv, rows, d)
    out = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
    for bi, (base, n) in enumerate(zip(row_start.tolist(),
                                       row_len.tolist())):
        live = min(max(n, 0), t) * g
        for r0 in range(0, live, block_rows):
            r1 = min(r0 + block_rows, live)
            pos = base + torch.arange(r0, r1, device=q.device) // g
            first = 0 if window is None else max(0, base + r0 // g
                                                 - int(window) + 1)
            last = base + (r1 - 1) // g
            chunk = split_chunk(last - first + 1, n_splits, min_keys, stage)
            parts = []
            for lo in range(first, last + 1, chunk)[:n_splits]:
                hi = min(last + 1, lo + chunk)
                kpos = torch.arange(lo, hi, device=q.device)
                seen = kpos[None, :] <= pos[:, None]
                if window is not None:
                    seen &= pos[:, None] - kpos[None, :] < int(window)
                s = torch.einsum("krd,ksd->krs", qp[bi, :, r0:r1],
                                 keys[:, bi, lo:hi])
                s = torch.where(seen, s, torch.full_like(s, -float("inf")))
                m = s.amax(-1).clamp(min=NEG_INF)
                p = torch.exp(s - m[..., None])
                parts.append((m, p.sum(-1), torch.einsum(
                    "krs,ksd->krd", p, vals[:, bi, lo:hi])))
            m_all = parts[0][0]
            for m, _, _ in parts[1:]:
                m_all = torch.maximum(m_all, m)
            l_all = torch.zeros_like(m_all)
            acc = torch.zeros_like(out[bi, :, r0:r1])
            for m, l, a in parts:
                scale = torch.exp(m - m_all)
                l_all = l_all + l * scale
                acc = acc + a * scale[..., None]
            out[bi, :, r0:r1] = acc / l_all.clamp(min=1e-30)[..., None]
    return out.reshape(b, kv, t, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, t, h, d).to(q.dtype)


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
    """log softmax gathered at targets, float32 accumulation (float64
    for float64 logits)."""
    logits32 = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, 1, targets.long()[:, None])[:, 0]
    return tgt - lse


def ref_entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-row softmax entropy, float32 (float64 for float64 logits)."""
    lp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
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
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    p = torch.exp(x - lse[:, None])
    dx = torch.zeros_like(x)
    if g_lp is not None:
        onehot = torch.zeros_like(x).scatter_(1, targets.long()[:, None], 1.0)
        dx = dx + g_lp[:, None] * (onehot - p)
    if g_ent is not None:
        dx = dx - g_ent[:, None] * p * (x - lse[:, None] + ent[:, None])
    return dx.to(logits.dtype)


# ---------------------------------------------------------------------------
# V-trace (paper Eqs. 14-15)
# ---------------------------------------------------------------------------


def ref_vtrace(
    log_ratios: torch.Tensor,       # [B, T]
    values: torch.Tensor,           # [B, T]
    bootstrap_value: torch.Tensor,  # [B]
    rewards: torch.Tensor,          # [B, T]
    discounts: torch.Tensor,        # [B, T]
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
):
    """``(vs, advantages)`` of ``core.vtrace.vtrace``, in float32 whatever
    the input dtype, as the kernel computes them."""
    f32 = lambda x: x.float()
    out = vtrace(log_ratios=f32(log_ratios), values=f32(values),
                 bootstrap_value=f32(bootstrap_value), rewards=f32(rewards),
                 discounts=f32(discounts), rho_bar=rho_bar, c_bar=c_bar,
                 lam=lam)
    return out.vs, out.advantages


def ref_vtrace_segmented(
    log_ratios: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
    *,
    seg: int,
):
    """:func:`ref_vtrace` in the time-parallel form the card's kernel
    computes, written plainly to pin down its algebra (the tests hold it
    to the step-by-step recurrence).  ``acc_t = delta_t + a_t acc_{t+1}``
    (``a = d c``) is an affine map of ``acc_{t+1}``, and such maps
    compose.  Time is cut into tiles of ``32 * seg`` steps, walked from
    the last; a tile's 32 lanes each own ``seg`` consecutive steps
    (steps past T are identity maps): (1) each lane composes its
    segment's map backwards, (2) an inclusive scan from the right over
    the lanes (offsets 1, 2, 4, 8, 16, as the warp's shuffles run) gives
    each lane the acc at its segment's start from the tile's incoming
    acc, (3) each lane re-runs its segment from the acc its right
    neighbour starts with; the first lane's start is the next tile's
    incoming acc.  Returns ``(vs, advantages)`` float32."""
    from repro_torch.core.gae import _tp1

    lr, val, boot, rew, disc = (x.float() for x in (
        log_ratios, values, bootstrap_value, rewards, discounts))
    ratio = torch.exp(lr)
    rho = torch.clamp(ratio, max=rho_bar)
    a_all = disc * (lam * torch.clamp(ratio, max=c_bar))
    delta_all = rho * (rew + disc * _tp1(val, boot) - val)
    bsz, t_len = val.shape
    tile = 32 * seg
    acc_all = torch.empty_like(val)
    carry = torch.zeros_like(boot)
    for t0 in reversed(range(0, t_len, tile)):
        n = min(tile, t_len - t0)
        delta = torch.zeros((bsz, tile), device=val.device)
        a = torch.ones((bsz, tile), device=val.device)
        delta[:, :n] = delta_all[:, t0:t0 + n]
        a[:, :n] = a_all[:, t0:t0 + n]
        delta, a = delta.view(bsz, 32, seg), a.view(bsz, 32, seg)
        mul = torch.ones((bsz, 32), device=val.device)
        add = torch.zeros((bsz, 32), device=val.device)
        for m in reversed(range(seg)):
            add = delta[:, :, m] + a[:, :, m] * add
            mul = a[:, :, m] * mul
        for off in (1, 2, 4, 8, 16):
            mul_r = torch.cat([mul[:, off:], torch.ones_like(mul[:, :off])], 1)
            add_r = torch.cat([add[:, off:], torch.zeros_like(add[:, :off])],
                              1)
            mul, add = mul * mul_r, mul * add_r + add
        start = mul * carry[:, None] + add          # acc at each lane's start
        acc = torch.cat([start[:, 1:], carry[:, None]], 1)
        out = torch.empty_like(delta)
        for m in reversed(range(seg)):
            acc = delta[:, :, m] + a[:, :, m] * acc
            out[:, :, m] = acc
        acc_all[:, t0:t0 + n] = out.reshape(bsz, tile)[:, :n]
        carry = start[:, 0]
    vs = val + acc_all
    return vs, rew + disc * _tp1(vs, boot) - val


# ---------------------------------------------------------------------------
# WKV6 linear-attention recurrence (rwkv6 time-mix)
# ---------------------------------------------------------------------------


def ref_wkv6(
    r: torch.Tensor,   # [B, S, H, K]
    k: torch.Tensor,   # [B, S, H, K]
    v: torch.Tensor,   # [B, S, H, V]
    w: torch.Tensor,   # [B, S, H, K]   decay in (0, 1)
    u: torch.Tensor,   # [H, K]         bonus
    state: Optional[torch.Tensor] = None,  # [B, H, K, V]
):
    """The WKV6 recurrence step by step (``repro.models.rwkv6.wkv6_scan``):
    ``y_t = (S + diag(u) k_t v_t^T)^T r_t`` then
    ``S <- diag(w_t) S + k_t v_t^T``, in float32 (float64 for float64
    inputs) from the state (zeros when ``state`` is None).  Returns
    ``(y [B, S, H, V]`` in ``r``'s dtype, ``final_state [B, H, K, V]``
    in the compute dtype)``."""
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    acc = torch.promote_types(r.dtype, torch.float32)
    if state is None:
        state = torch.zeros((bsz, h, kd, vd), dtype=acc, device=r.device)
    big_s = state.to(acc)
    u32 = u.to(acc)[None, :, :, None]
    ys = []
    for t in range(s):
        r_t, k_t, v_t, w_t = (a[:, t].to(acc) for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]              # [B,H,K,V]
        ys.append(torch.einsum("bhkv,bhk->bhv", big_s + u32 * kv, r_t))
        big_s = w_t[..., :, None] * big_s + kv
    return torch.stack(ys, dim=1).to(r.dtype), big_s


def _wkv6_decays(w):
    """Decay products of a sub-chunk, w [B, L, H, K], none above 1 and
    none divided, for the forward's and the backward's chunked forms:
    ``pre_t`` over the steps before t, ``suf_t`` over those after it,
    ``total`` over all of them, and ``pair[b, t, i]`` over those strictly
    between i and t for i < t (0 for i >= t)."""
    n = w.shape[1]
    ones = torch.ones_like(w[:, :1])
    pre = torch.cat([ones, torch.cumprod(w, 1)[:, :-1]], 1)
    suf = torch.cat([torch.cumprod(w.flip(1), 1).flip(1)[:, 1:], ones], 1)
    idx = torch.arange(n, device=w.device)
    rows = torch.where((idx[None, :] < idx[:, None])[None, :, :, None, None],
                       w[:, None], torch.ones_like(w[:, None]))  # [B,t,m,H,K]
    between = torch.cumprod(rows.flip(2), 2).flip(2)
    pair = torch.cat([between[:, :, 1:], torch.zeros_like(between[:, :, :1])],
                     2)
    pair = pair * (idx[None, :] < idx[:, None]).to(w.dtype)[None, :, :, None,
                                                             None]
    return pre, suf, torch.cumprod(w, 1)[:, -1], pair


def _wkv6_sub(r, k, v, w, u, big_s):
    """One sub-chunk of L steps from state ``big_s`` [B, H, K, V], every
    operand float32: ``(y [B, L, H, V], the state after it)``.  Decays
    enter only as products of w over spans of steps, each at most 1
    (:func:`_wkv6_decays`).  No logarithm and no division, so w = 0 gives
    an exact 0."""
    pre, suf, total, pair = _wkv6_decays(w)
    scores = torch.einsum("bthk,bihk,btihk->bhti", r, k, pair)
    scores = scores + torch.diag_embed(
        torch.einsum("bthk,hk,bthk->bht", r, u, k))
    y = (torch.einsum("bhti,bihv->bthv", scores, v)
         + torch.einsum("bthk,bhkv->bthv", r * pre, big_s))
    new_s = (total[..., None] * big_s
             + torch.einsum("bihk,bihv->bhkv", k * suf, v))
    return y, new_s


def ref_wkv6_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    chunk: int,
    sub: int = 16,
):
    """:func:`ref_wkv6` in the chunked form the card's kernels compute,
    written plainly to pin down its algebra (the tests hold it to the
    step-by-step recurrence).  Within a sub-chunk of ``sub`` steps from
    state S, with decay products that never exceed 1 (:func:`_wkv6_sub`):
    ``y_t = sum_{i<t} (r_t . (k_i * pair_ti)) v_i + (r_t . u k_t) v_t
    + (r_t * pre_t) S`` and ``S <- diag(total) S + (k * suf)^T v``; the
    off-diagonal blocks of a longer chunk are those sub-chunks' products
    through the state.  Segments of ``chunk`` steps (a multiple of
    ``sub`` on the card) run as its split instantiation does: (1) each
    segment's end state from zero, through its sub-chunks, (2) the carry
    of true start states, ``S <- diag(prod w) S + local``, from
    ``state``, (3) each segment re-run from its true start for y; the
    last segment's end state is the final state.  ``chunk >= S`` is the
    one-segment instantiation.  Returns ``(y`` in r's dtype, the final
    state float32)."""
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    r32, k32, v32, w32 = (x.float() for x in (r, k, v, w))
    u32 = u.float()
    zero = torch.zeros((bsz, h, kd, vd), dtype=torch.float32,
                       device=r.device)
    carry = zero if state is None else state.float()

    def run(t0, t1, big_s):
        ys = []
        for a in range(t0, t1, sub):
            span = slice(a, min(a + sub, t1))
            y, big_s = _wkv6_sub(r32[:, span], k32[:, span], v32[:, span],
                                 w32[:, span], u32, big_s)
            ys.append(y)
        return ys, big_s

    spans = [(t0, min(t0 + chunk, s)) for t0 in range(0, s, chunk)]
    starts = []
    for t0, t1 in spans:
        starts.append(carry)
        _, local = run(t0, t1, zero)
        decay = torch.prod(w32[:, t0:t1], 1)                    # [B, H, K]
        carry = decay[..., None] * carry + local
    ys = []
    for (t0, t1), start in zip(spans, starts):
        y, big_s = run(t0, t1, start)
        ys += y
    return torch.cat(ys, dim=1).to(r.dtype), big_s


# Steps a chunk of the plain WKV6 backward recomputes from its start and
# walks back.
WKV6_BWD_CHUNK = 8


def ref_wkv6_backward(
    r: torch.Tensor,                           # [B, S, H, K]
    k: torch.Tensor,                           # [B, S, H, K]
    v: torch.Tensor,                           # [B, S, H, V]
    w: torch.Tensor,                           # [B, S, H, K]
    u: torch.Tensor,                           # [H, K]
    state: Optional[torch.Tensor],             # [B, H, K, V] or None (zeros)
    y_grad: torch.Tensor,                      # [B, S, H, V]
    state_grad: Optional[torch.Tensor],        # [B, H, K, V] or None (zeros)
    *,
    chunk: int = WKV6_BWD_CHUNK,
):
    """Gradient of :func:`ref_wkv6` by an explicit reverse recurrence,
    step by step (the card's kernel computes the same gradient in the
    chunked form, :func:`ref_wkv6_backward_chunked`).  A forward walk keeps
    the state at the start of every ``chunk`` steps; the chunks are then
    taken last to first, each chunk's states recomputed from its start
    and walked in reverse.  With ``S_t`` the state after step t,
    ``G_t`` the gradient reaching it (``G_{S-1}`` = ``state_grad``) and
    ``g_t = dy_t . v_t``:
    ``dr_t = S_{t-1} dy_t + u k_t g_t``,
    ``dk_t = u r_t g_t + G_t v_t``,
    ``dv_t = (r_t . u k_t) dy_t + G_t^T k_t``,
    ``dw_t = sum_v G_t S_{t-1}``, ``du = sum_{b,t} r_t k_t g_t`` and
    ``G_{t-1} = diag(w_t) G_t + r_t dy_t^T``; the initial state's
    gradient is the last G.  Nothing divides by w or takes its
    logarithm, so w = 0 gives exact, finite gradients.  Everything runs
    in float32 (float64 for float64 inputs).  Returns ``(dr, dk, dv,
    dw)`` in their inputs' dtype, ``du`` in u's, and the initial state's
    gradient in the compute dtype (None when ``state`` is None)."""
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    acc = torch.promote_types(r.dtype, torch.float32)
    r32, k32, v32, w32, dy32 = (x.to(acc) for x in (r, k, v, w, y_grad))
    u32 = u.to(acc)
    zeros = torch.zeros((bsz, h, kd, vd), dtype=acc, device=r.device)
    big_s = zeros if state is None else state.to(acc)
    spans = [(t0, min(t0 + chunk, s)) for t0 in range(0, s, chunk)]
    starts = []
    for t0, t1 in spans:
        starts.append(big_s)
        for t in range(t0, t1):
            big_s = (w32[:, t, ..., None] * big_s
                     + k32[:, t, ..., None] * v32[:, t, :, None, :])
    dr, dk, dw = (torch.empty_like(r32) for _ in range(3))
    dv = torch.empty_like(v32)
    du = torch.zeros_like(u32)
    g_s = zeros if state_grad is None else state_grad.to(acc)
    for (t0, t1), start in zip(reversed(spans), reversed(starts)):
        before, hh = [], start                  # before[j] = S_{t0+j-1}
        for t in range(t0, t1):
            before.append(hh)
            hh = (w32[:, t, ..., None] * hh
                  + k32[:, t, ..., None] * v32[:, t, :, None, :])
        for j in reversed(range(t1 - t0)):
            t = t0 + j
            r_t, k_t, v_t, w_t, dy_t = (x[:, t] for x in (r32, k32, v32,
                                                          w32, dy32))
            g = (dy_t * v_t).sum(-1, keepdim=True)              # [B, H, 1]
            dr[:, t] = (torch.einsum("bhkv,bhv->bhk", before[j], dy_t)
                        + u32 * k_t * g)
            dk[:, t] = u32 * r_t * g + torch.einsum("bhkv,bhv->bhk", g_s,
                                                     v_t)
            dv[:, t] = ((r_t * u32 * k_t).sum(-1, keepdim=True) * dy_t
                        + torch.einsum("bhkv,bhk->bhv", g_s, k_t))
            dw[:, t] = (g_s * before[j]).sum(-1)
            du += (r_t * k_t * g).sum(0)
            g_s = w_t[..., None] * g_s + r_t[..., None] * dy_t[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), None if state is None else g_s)


def _wkv6_bwd_sub(r, k, v, w, u, s0, g_end, dy):
    """The backward of one sub-chunk of L steps (operands [B, L, H, *] in
    the compute dtype) from its start state ``s0`` and the gradient
    ``g_end`` [B, H, K, V] reaching its end state.  With A_ji = dy_j . v_i
    (g_t = A_tt), SdY_t = S0 dy_t, GV_t = G_end v_t, c = rowsum(G_end *
    S0) and P_jt = r_j . (pair_jt * k_t) (P_tt = r_t . u k_t):
    ``dr_t = pre_t SdY_t + sum_{i<t} pair_ti k_i A_ti + u k_t g_t``,
    ``dk_t = suf_t GV_t + sum_{j>t} pair_jt r_j A_jt + u r_t g_t``,
    ``dv_t = G_end^T (k_t suf_t) + sum_{j>=t} P_jt dy_j``,
    ``dw_t = pre_t suf_t c + pre_t Z_t + suf_t W_t + sum_{i<t<j} pair_ti
    pair_jt k_i r_j A_ji`` with ``Z_t = sum_{j>t} pair_jt r_j SdY_j`` and
    ``W_t = sum_{i<t} pair_ti k_i GV_i``, and the gradient before the
    sub-chunk ``diag(total) G_end + (r pre)^T dy``.  Returns ``(dr, dk,
    dv, dw, du`` summed over the L steps [B, H, K], that gradient)."""
    pre, suf, total, pair = _wkv6_decays(w)
    a = torch.einsum("bjhv,bihv->bhji", dy, v)
    g = torch.diagonal(a, dim1=2, dim2=3).permute(0, 2, 1)[..., None]
    sdy = torch.einsum("bhkv,bthv->bthk", s0, dy)
    gv = torch.einsum("bhkv,bthv->bthk", g_end, v)
    c = (g_end * s0).sum(-1)                                   # [B, H, K]
    uu = u[None, None]
    dr = (pre * sdy + torch.einsum("btihk,bihk,bhti->bthk", pair, k, a)
          + uu * k * g)
    dk = (suf * gv + torch.einsum("bjthk,bjhk,bhjt->bthk", pair, r, a)
          + uu * r * g)
    p = (torch.einsum("bjhk,bjthk,bthk->bhjt", r, pair, k)
         + torch.diag_embed(torch.einsum("bthk,hk,bthk->bht", r, u, k)))
    dv = (torch.einsum("bthk,bhkv->bthv", k * suf, g_end)
          + torch.einsum("bhjt,bjhv->bthv", p, dy))
    z = torch.einsum("bjthk,bjhk,bjhk->bthk", pair, r, sdy)
    wsum = torch.einsum("btihk,bihk,bihk->bthk", pair, k, gv)
    cross = torch.einsum("bjthk,btihk,bihk,bjhk,bhji->bthk", pair, pair, k,
                         r, a)
    dw = pre * suf * c[:, None] + pre * z + suf * wsum + cross
    du = (r * k * g).sum(1)
    g_before = (total[..., None] * g_end
                + torch.einsum("bthk,bthv->bhkv", r * pre, dy))
    return dr, dk, dv, dw, du, g_before


def _pairwise_sum(parts):
    """Sum of a list of equal-shaped tensors in a fixed tree: stride 1,
    2, 4, ...: part i takes part i + stride (the order ``wkv6_bwd``'s
    reduction kernel sums du's per-(b, segment) partials in)."""
    parts = list(parts)
    stride = 1
    while stride < len(parts):
        for i in range(0, len(parts) - stride, 2 * stride):
            parts[i] = parts[i] + parts[i + stride]
        stride *= 2
    return parts[0]


def ref_wkv6_backward_chunked(
    r: torch.Tensor,                           # [B, S, H, K]
    k: torch.Tensor,                           # [B, S, H, K]
    v: torch.Tensor,                           # [B, S, H, V]
    w: torch.Tensor,                           # [B, S, H, K]
    u: torch.Tensor,                           # [H, K]
    state: Optional[torch.Tensor],             # [B, H, K, V] or None (zeros)
    y_grad: torch.Tensor,                      # [B, S, H, V]
    state_grad: Optional[torch.Tensor],        # [B, H, K, V] or None (zeros)
    *,
    sub: int = 16,
    seg: Optional[int] = None,
):
    """:func:`ref_wkv6_backward` in the chunked form the card's
    ``wkv6_bwd`` computes, written plainly to pin down its algebra.  The
    sequence is cut into segments of ``seg`` steps (None: one segment,
    the ``chunked`` instantiation; else ``split``, ``seg`` a multiple of
    ``sub`` on the card), each into sub-chunks of ``sub`` steps:
    (1) every segment, from a zero state and a zero end-gradient, gives
    its local end state (sub-chunk by sub-chunk, ``S <- diag(total) S +
    (k suf)^T v``), its local start-gradient ``sum_t (prod_{m<t} w_m) r_t
    dy_t^T`` and its decay product; (2) the carries: segment c + 1
    starts at ``diag(D_c) S_c + local_c`` from ``state``, and segment
    c - 1 ends at ``diag(D_c) G_c + local_c`` from ``state_grad``; (3)
    every segment walks its sub-chunks forward from its true start,
    keeping each sub-chunk's start state, then back from its true
    end-gradient through :func:`_wkv6_bwd_sub`.  du sums over the steps
    of each (b, segment), then over those partials in
    :func:`_pairwise_sum`'s tree.  Nothing divides by w or takes its
    logarithm.  Float32 arithmetic (float64 for float64 inputs); returns
    what :func:`ref_wkv6_backward` returns."""
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    acc = torch.promote_types(r.dtype, torch.float32)
    r32, k32, v32, w32, dy32 = (x.to(acc) for x in (r, k, v, w, y_grad))
    u32 = u.to(acc)
    zero = torch.zeros((bsz, h, kd, vd), dtype=acc, device=r.device)
    seg = s if seg is None else seg
    spans = [(t0, min(t0 + seg, s)) for t0 in range(0, s, seg)]

    def subs(t0, t1):
        return [(a, min(a + sub, t1)) for a in range(t0, t1, sub)]

    # (1) Each segment's local end state, start-gradient and decay.
    local_s, local_g, decay = [], [], []
    for t0, t1 in spans:
        big_s, big_g = zero, zero
        before = torch.ones_like(w32[:, 0])          # prod of w before
        for a, b in subs(t0, t1):
            pre, suf, total, _ = _wkv6_decays(w32[:, a:b])
            big_s = (total[..., None] * big_s
                     + torch.einsum("bthk,bthv->bhkv",
                                    k32[:, a:b] * suf, v32[:, a:b]))
            big_g = big_g + torch.einsum(
                "bthk,bthv->bhkv", r32[:, a:b] * pre * before[:, None],
                dy32[:, a:b])
            before = before * total
        local_s.append(big_s)
        local_g.append(big_g)
        decay.append(before)
    # (2) The carries.
    starts = [zero if state is None else state.to(acc)]
    for c in range(len(spans) - 1):
        starts.append(decay[c][..., None] * starts[c] + local_s[c])
    ends = [zero if state_grad is None else state_grad.to(acc)]
    for c in range(len(spans) - 1, 0, -1):
        ends.insert(0, decay[c][..., None] * ends[0] + local_g[c])
    # (3) Every segment from its true start state and end-gradient.
    dr, dk, dw = (torch.empty_like(r32) for _ in range(3))
    dv = torch.empty_like(v32)
    du_parts = [[None] * len(spans) for _ in range(bsz)]
    for c, (t0, t1) in enumerate(spans):
        sub_starts, big_s = [], starts[c]
        for a, b in subs(t0, t1):
            sub_starts.append(big_s)
            _, suf, total, _ = _wkv6_decays(w32[:, a:b])
            big_s = (total[..., None] * big_s
                     + torch.einsum("bthk,bthv->bhkv",
                                    k32[:, a:b] * suf, v32[:, a:b]))
        big_g, du_c = ends[c], torch.zeros_like(r32[:, 0])
        for (a, b), s0 in zip(reversed(subs(t0, t1)), reversed(sub_starts)):
            out = _wkv6_bwd_sub(r32[:, a:b], k32[:, a:b], v32[:, a:b],
                                w32[:, a:b], u32, s0, big_g, dy32[:, a:b])
            dr[:, a:b], dk[:, a:b], dv[:, a:b], dw[:, a:b] = out[:4]
            du_c = du_c + out[4]
            big_g = out[5]
        for bi in range(bsz):
            du_parts[bi][c] = du_c[bi]
        if c == 0:
            dstate = big_g
    du = _pairwise_sum([p for row in du_parts for p in row])
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), None if state is None else dstate)


# ---------------------------------------------------------------------------
# Flash attention (causal / sliding-window, GQA): full-sequence prefill
# ---------------------------------------------------------------------------


def masked_attention(
    q: torch.Tensor,      # [B, Sq, H, D]
    k: torch.Tensor,      # [B, Sk, KV, D]
    v: torch.Tensor,      # [B, Sk, KV, D]
    mask: torch.Tensor,   # bool, broadcast to [B, 1, Sq, Sk]; True = attend
) -> torch.Tensor:
    """GQA attention under a boolean mask: scores in float32 from
    ``q * d**-0.5``, -1e30 where the mask is False, softmax,
    probabilities cast to q's dtype before the value product.  Returns
    ``[B, Sq, H, D]`` in q's dtype."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", (qg * d ** -0.5).float(),
                          k.float())                 # [B, KV, G, Sq, Sk]
    scores = torch.where(mask[:, :, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def ref_attention(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, KV, D]
    v: torch.Tensor,   # [B, S, KV, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,  # None = global
    kv_valid: Optional[torch.Tensor] = None,   # [B, S] bool key mask
) -> torch.Tensor:
    """Attention of every position over the same sequence
    (``repro.kernels.ref.ref_attention``): ``masked_attention`` inside
    the causal band and the window, and over the keys ``kv_valid``
    keeps when given (``repro.models.attention.make_attention_mask``'s
    padding mask).  Returns ``[B, S, H, D]`` in q's dtype."""
    s = q.shape[1]
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = qi >= ki if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=q.device)
    if window is not None:
        mask = mask & ((qi - ki) < window)
    return masked_attention(q, k, v, _key_mask(mask, kv_valid))


def _key_mask(mask: torch.Tensor, kv_valid: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """``mask`` [Sq, Sk] as ``[1 or B, 1, Sq, Sk]``, and-ed with the key
    mask ``kv_valid`` [B, Sk] when given."""
    if kv_valid is None:
        return mask[None, None]
    return mask[None, None] & kv_valid.to(torch.bool)[:, None, None, :]


def _band(s: int, window: Optional[int], device) -> torch.Tensor:
    """The causal (and windowed) ``[S, S]`` mask, True = attend."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = qi >= ki
    if window is not None:
        mask = mask & ((qi - ki) < window)
    return mask


def _grouped_scores(q: torch.Tensor, k: torch.Tensor, window: Optional[int]
                    ) -> torch.Tensor:
    """float32 scores ``(q * D^-0.5) . k`` ``[B, KV, G, S, S]`` of the
    causal band, -1e30 outside it (the kernel scales q in float32)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d) * d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    return torch.where(_band(s, window, q.device), scores,
                       torch.full_like(scores, NEG_INF))


def ref_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: Optional[int] = None):
    """:func:`ref_attention` and the float32 logsumexp of each row's
    scores, ``[B, S, H]`` (the forward's saved statistic for the
    backward).  Returns ``(out [B, S, H, D]`` in q's dtype, ``lse)``."""
    b, s, h, _ = q.shape
    scores = _grouped_scores(q, k, window)
    lse = torch.logsumexp(scores, dim=-1)                   # [B, KV, G, S]
    out = ref_attention(q, k, v, window=window)
    return out, lse.permute(0, 3, 1, 2).reshape(b, s, h)


def ref_attention_backward(
    q: torch.Tensor,       # [B, S, H, D]
    k: torch.Tensor,       # [B, S, KV, D]
    v: torch.Tensor,       # [B, S, KV, D]
    out: torch.Tensor,     # [B, S, H, D] the forward's output
    lse: torch.Tensor,     # [B, S, H] float32 logsumexp of each row
    d_out: torch.Tensor,   # [B, S, H, D] gradient of out
    *,
    window: Optional[int] = None,
):
    """Gradient of causal (windowed) GQA attention in the FlashAttention-2
    algebra the card's backward kernel computes: ``D = rowsum(dO * O)``,
    ``P = exp(s - lse)`` recomputed from the saved logsumexp,
    ``dS = P * (dO V^T - D)``, ``dQ = D^-0.5 dS K``, ``dK = D^-0.5 dS^T Q``
    and ``dV = P^T dO``, dK and dV summed over each kv head's query
    group; float32 throughout.  Returns ``(dq, dk, dv)`` in the inputs'
    dtype."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = d ** -0.5
    scores = _grouped_scores(q, k, window)                  # [B,KV,G,Sq,Sk]
    lse_g = lse.float().reshape(b, s, kv, g).permute(0, 2, 3, 1)
    p = torch.exp(scores - lse_g[..., None])
    p = torch.where(_band(s, window, q.device), p, torch.zeros_like(p))
    do = d_out.float().reshape(b, s, kv, g, d)
    dvec = (do * out.float().reshape(b, s, kv, g, d)).sum(-1)  # [B,S,KV,G]
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None])
    qg = q.float().reshape(b, s, kv, g, d)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# Above this many query rows the CPU's plain attention is q-chunked, in
# chunks of CHUNK_Q rows (``repro.models.attention``'s constants).
CHUNKED_ATTN_THRESHOLD = 2048
CHUNK_Q = 512


def ref_attention_chunked(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, KV, D]
    v: torch.Tensor,   # [B, S, KV, D]
    *,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,   # [B, S] bool key mask
    chunk: int = CHUNK_Q,
) -> torch.Tensor:
    """:func:`ref_attention` a chunk of ``chunk`` query rows at a time
    against every key (``repro.models.attention._sdpa_chunked``): peak
    score memory ``O(chunk * S)``.  Under autograd each chunk is
    checkpointed, so the backward recomputes its scores instead of
    keeping them, as ``jax.checkpoint`` does there."""
    from torch.utils.checkpoint import checkpoint

    s = q.shape[1]
    pos = torch.arange(s, device=q.device)

    def one_chunk(q_i, k_all, v_all, t0):
        qi = pos[t0:t0 + q_i.shape[1], None]
        mask = qi >= pos[None, :]
        if window is not None:
            mask = mask & ((qi - pos[None, :]) < window)
        return masked_attention(q_i, k_all, v_all, _key_mask(mask, kv_valid))

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for t0 in range(0, s, chunk):
        q_i = q[:, t0:t0 + chunk]
        outs.append(checkpoint(one_chunk, q_i, k, v, t0, use_reentrant=False)
                    if grad else one_chunk(q_i, k, v, t0))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Selective-SSM (Mamba/S6) scan: hymba's SSM branch
# ---------------------------------------------------------------------------


def ref_ssm_scan(
    u: torch.Tensor,     # [B, S, I] post-conv activations
    dt: torch.Tensor,    # [B, S, I]
    b_t: torch.Tensor,   # [B, S, N]
    c_t: torch.Tensor,   # [B, S, N]
    a: torch.Tensor,     # [I, N] (negative)
    h0: Optional[torch.Tensor] = None,  # [B, I, N]
):
    """The selective scan step by step (``repro.models.ssm._ssm_scan``):
    ``h = exp(dt * a) * h + dt * u * b``, ``y = h . c``, every input cast
    to float32, from ``h0`` (zeros when None).  Returns ``(y [B, S, I]``
    in u's dtype, ``h_final [B, I, N]`` float32)``."""
    bsz, s, inner = u.shape
    h = (torch.zeros((bsz, inner, a.shape[1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0.float())
    u32, dt32, b32, c32 = (x.float() for x in (u, dt, b_t, c_t))
    a32 = a.float()[None]
    ys = []
    for t in range(s):
        dt_t = dt32[:, t, :, None]                              # [B, I, 1]
        h = torch.exp(dt_t * a32) * h + (dt_t * u32[:, t, :, None]
                                         * b32[:, t, None, :])
        ys.append(torch.einsum("bin,bn->bi", h, c32[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype), h


def ref_ssm_scan_chunked(
    u: torch.Tensor,
    dt: torch.Tensor,
    b_t: torch.Tensor,
    c_t: torch.Tensor,
    a: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    chunk: int,
):
    """:func:`ref_ssm_scan` in the chunked form the card's long-sequence
    instantiation computes, written plainly to pin down its algebra (the
    tests hold it to the step-by-step scan).  A chunk's recurrence
    composes into ``h_end = exp(a * sum(dt)) * h_start + h_local``, with
    ``h_local`` its end state from zero: (1) each chunk's local end
    state and sum of dt, (2) the carry of true start states across
    chunks from ``h0``, (3) each chunk re-run from its true start for
    ``y``; the last chunk's end state is ``h_final``."""
    s = u.shape[1]
    a32 = a.float()[None]
    carry = (torch.zeros((u.shape[0], u.shape[2], a.shape[1]),
                         dtype=torch.float32, device=u.device)
             if h0 is None else h0.float())
    spans = [slice(t0, min(t0 + chunk, s)) for t0 in range(0, s, chunk)]
    starts = []
    for span in spans:
        starts.append(carry)
        _, local = ref_ssm_scan(u[:, span], dt[:, span], b_t[:, span],
                                c_t[:, span], a)
        decay = torch.exp(a32 * dt[:, span].float().sum(1)[..., None])
        carry = decay * carry + local
    ys = []
    for span, start in zip(spans, starts):
        y, h = ref_ssm_scan(u[:, span], dt[:, span], b_t[:, span],
                            c_t[:, span], a, start)
        ys.append(y)
    return torch.cat(ys, dim=1), h


# Steps a chunk of the SSM backward recomputes from its start and walks
# back (``csrc/ssm_scan_bwd.cu``: kChunk).
SSM_BWD_CHUNK = 8


def ref_ssm_scan_backward(
    u: torch.Tensor,                       # [B, S, I]
    dt: torch.Tensor,                      # [B, S, I]
    b_t: torch.Tensor,                     # [B, S, N]
    c_t: torch.Tensor,                     # [B, S, N]
    a: torch.Tensor,                       # [I, N]
    h0: Optional[torch.Tensor],            # [B, I, N] or None (zeros)
    y_grad: torch.Tensor,                  # [B, S, I]
    h_final_grad: Optional[torch.Tensor],  # [B, I, N] or None (zeros)
    *,
    chunk: int = SSM_BWD_CHUNK,
):
    """Gradient of :func:`ref_ssm_scan` by an explicit reverse scan, in
    the algebra the card's backward kernel uses.  A forward walk keeps
    the state at the start of every ``chunk`` steps; the chunks are then
    taken last to first, each chunk's states recomputed from its start
    and walked in reverse.  With ``e_t = exp(dt_t a)``, ``h_t`` the state
    after step t and ``g_t`` the gradient reaching it:
    ``g_t = c_t dy_t + e_{t+1} g_{t+1}`` (``g_{S-1}`` also takes
    ``h_final_grad``), ``dc_t = sum_i dy_t h_t``,
    ``db_t = sum_i g_t dt_t u_t``, ``du_t = dt_t sum_n g_t b_t``,
    ``ddt_t = sum_n g_t (a e_t h_{t-1} + b_t u_t)``,
    ``da = sum_{b,t} g_t dt_t e_t h_{t-1}`` and ``dh0 = e_0 g_0``, all in
    float32.  Returns ``(du, ddt, db, dc)`` in their inputs' dtypes and
    ``(da, dh0)`` float32."""
    bsz, s, inner = u.shape
    n = a.shape[1]
    u32, dt32, b32, c32, dy32 = (x.float() for x in (u, dt, b_t, c_t,
                                                    y_grad))
    a32 = a.float()[None]
    zeros = torch.zeros((bsz, inner, n), dtype=torch.float32,
                        device=u.device)
    h = zeros if h0 is None else h0.float()
    spans = [(t0, min(t0 + chunk, s)) for t0 in range(0, s, chunk)]
    starts = []
    for t0, t1 in spans:
        starts.append(h)
        for t in range(t0, t1):
            h = (torch.exp(dt32[:, t, :, None] * a32) * h
                 + dt32[:, t, :, None] * u32[:, t, :, None]
                 * b32[:, t, None, :])
    du, ddt = torch.empty_like(u32), torch.empty_like(dt32)
    db, dc = torch.empty_like(b32), torch.empty_like(c32)
    da = torch.zeros_like(a32[0])
    carry = zeros if h_final_grad is None else h_final_grad.float()
    for (t0, t1), start in zip(reversed(spans), reversed(starts)):
        hs, es, hh = [], [], start
        for t in range(t0, t1):
            e = torch.exp(dt32[:, t, :, None] * a32)
            hh = e * hh + (dt32[:, t, :, None] * u32[:, t, :, None]
                           * b32[:, t, None, :])
            hs.append(hh)
            es.append(e)
        for j in reversed(range(t1 - t0)):
            t = t0 + j
            d_t, u_t, b_n = dt32[:, t], u32[:, t], b32[:, t]
            h_prev = hs[j - 1] if j > 0 else start
            g = c32[:, t, None, :] * dy32[:, t, :, None] + carry
            dc[:, t] = torch.einsum("bi,bin->bn", dy32[:, t], hs[j])
            db[:, t] = torch.einsum("bin,bi->bn", g, d_t * u_t)
            du[:, t] = d_t * torch.einsum("bin,bn->bi", g, b_n)
            ddt[:, t] = torch.einsum(
                "bin,bin->bi", g, a32 * es[j] * h_prev
                + b_n[:, None, :] * u_t[:, :, None])
            da += torch.einsum("bin,bi->in", g * es[j] * h_prev, d_t)
            carry = es[j] * g
    return (du.to(u.dtype), ddt.to(dt.dtype), db.to(b_t.dtype),
            dc.to(c_t.dtype), da, carry)
