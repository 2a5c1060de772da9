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
    ``S <- diag(w_t) S + k_t v_t^T``, in float32 from a float32 state
    (zeros when ``state`` is None).  Returns ``(y [B, S, H, V]`` in
    ``r``'s dtype, ``final_state [B, H, K, V]`` float32)``."""
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    if state is None:
        state = torch.zeros((bsz, h, kd, vd), dtype=torch.float32,
                            device=r.device)
    big_s = state.float()
    u32 = u.float()[None, :, :, None]
    ys = []
    for t in range(s):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]              # [B,H,K,V]
        ys.append(torch.einsum("bhkv,bhk->bhv", big_s + u32 * kv, r_t))
        big_s = w_t[..., :, None] * big_s + kv
    return torch.stack(ys, dim=1).to(r.dtype), big_s


def _wkv6_sub(r, k, v, w, u, big_s):
    """One sub-chunk of L steps from state ``big_s`` [B, H, K, V], every
    operand float32: ``(y [B, L, H, V], the state after it)``.  Decays
    enter only as products of w over spans of steps, each at most 1:
    ``pre_t`` over the steps before t, ``suf_i`` over those after i, and
    ``pair[t, i]`` over those strictly between i and t (a row of w with
    the steps at or after t set to 1, its suffix products, shifted).  No
    logarithm and no division, so w = 0 gives an exact 0."""
    n = r.shape[1]
    ones = torch.ones_like(w[:, :1])
    pre = torch.cat([ones, torch.cumprod(w, 1)[:, :-1]], 1)
    total = torch.cumprod(w, 1)[:, -1]                          # [B, H, K]
    suf = torch.cat([torch.cumprod(w.flip(1), 1).flip(1)[:, 1:], ones], 1)
    idx = torch.arange(n, device=r.device)
    before = (idx[None, :] < idx[:, None])                      # [t, j]
    rows = torch.where(before[None, :, :, None, None], w[:, None],
                       torch.ones_like(w[:, None]))             # [B,t,j,H,K]
    between = torch.cumprod(rows.flip(2), 2).flip(2)
    pair = torch.cat([between[:, :, 1:], torch.ones_like(between[:, :, :1])],
                     2)                                         # [B,t,i,H,K]
    scores = torch.einsum("bthk,bihk,btihk->bhti", r, k, pair)
    scores = scores * before[None, None].float()
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
) -> torch.Tensor:
    """Attention of every position over the same sequence
    (``repro.kernels.ref.ref_attention``): ``masked_attention`` inside
    the causal band and the window.  Returns ``[B, S, H, D]`` in q's
    dtype."""
    s = q.shape[1]
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = qi >= ki if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=q.device)
    if window is not None:
        mask = mask & ((qi - ki) < window)
    return masked_attention(q, k, v, mask[None, None])


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
