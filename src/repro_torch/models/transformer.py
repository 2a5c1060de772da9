"""Decoder-only policy backbone (port of ``repro.models.transformer``)
for the dense qwen family, attention-free rwkv6 and hybrid hymba
(attention and SSM heads side by side in every layer).

Ported here: ``init_params``; the training/prefill ``forward`` with the
value head, the decode cache (``init_cache``: dense K/V rows, or for
rwkv6 the per-layer WKV state and token shifts) and its one-token
``decode_step``, which the learner and the static ``generate`` run (for
hymba the cache adds each layer's SSM state and conv window); and,
for the dense decoder, ``init_paged_cache`` with the three paged steps
the serve engine dispatches — ``decode_step_paged`` (one token per slot, through the
decode kernel), ``decode_step_paged_varlen`` (ragged rows per slot,
through the varlen kernel) and ``decode_step_paged_multi`` (the
fixed-``T`` verify shape, a thin wrapper over the varlen step).  The
prefill writers come with a later slice.  The layer loop is a Python
loop (JAX scans over the stacked layers).

Parameters keep the JAX layout and names: nested dicts, layer leaves
stacked ``[L, ...]``, dense weights ``[d_in, d_out]``, an ``lm_head``
where embeddings are untied.  The paged pool is
``{"k_pages", "v_pages"}`` of ``[L, KV, NB, BS, Dh]``.

**In place.**  JAX returns new pools and caches (donated buffers that XLA
updates in place); here every step writes the pool or cache tensors it
is given in place and returns the same dict.  Each layer's K/V rows are
written before that layer's attention reads them, so step *t* sees its
own rows and every later step sees them too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.utils.tree import tree_map, tree_to  # noqa: F401 (re-export)
from repro_torch.models.layers import (
    apply_rope,
    dense_apply,
    dense_init,
    embedding_apply,
    embedding_attend,
    embedding_init,
    mlp_apply,
    mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)


class ModelOutput(NamedTuple):
    logits: torch.Tensor             # [B, S, V] (or [B, V])
    value: Optional[torch.Tensor]    # [B, S] (or [B]) or None
    cache: Any
    aux_loss: torch.Tensor


def arch_unsupported(cfg: ModelConfig) -> Optional[str]:
    """Why the port cannot run this config at all (None = it can)."""
    if cfg.attn_free:
        return None
    if (cfg.encoder_layers > 0 or cfg.moe is not None
            or cfg.vision_prefix_len > 0 or cfg.activation != "swiglu"
            or cfg.logit_softcap is not None):
        return ("only attention-free rwkv6, hybrid attention+SSM hymba and "
                "the dense qwen family (SwiGLU, no MoE, no logit softcap) "
                "are ported yet")
    return None


def paged_arch_unsupported(cfg: ModelConfig) -> Optional[str]:
    """Why this config cannot run the port's paged path (None = it
    can): the reference's reasons, then what the port lacks."""
    if cfg.attn_free:
        return "attn-free (rwkv) archs keep recurrent state, not KV rows"
    if cfg.hybrid_attn_ssm:
        return "hybrid attn+ssm archs carry unpaged ssm/conv state"
    if cfg.encoder_layers > 0:
        return "encoder-decoder cross-attention cache is not paged"
    if cfg.vision_prefix_len > 0:
        return "vision prefix rows are not paged"
    return arch_unsupported(cfg)


def _check_arch(cfg: ModelConfig) -> None:
    reason = arch_unsupported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32, device=None) -> Dict:
    """Random init of a dense decoder from ``gen`` (the same
    distributions as the JAX init; not the same numbers).  Sampling runs
    on ``gen``'s device; the result moves to ``device`` when given, so
    one CPU generator gives identical weights on every device."""
    _check_arch(cfg)
    lead = (cfg.n_layers,)
    dev = gen.device
    embed = embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers: Dict[str, Any] = {
        "norm1": rmsnorm_init(cfg.d_model, dtype, lead, dev),
        "norm2": rmsnorm_init(cfg.d_model, dtype, lead, dev),
    }
    if cfg.attn_free:
        layers["rwkv"] = rwkv_mod.rwkv6_init(gen, cfg.d_model, cfg.d_ff,
                                             dtype, lead=lead)
    else:
        layers["attn"] = attn.attn_init(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype, lead=lead)
        if cfg.hybrid_attn_ssm:
            layers["ssm"] = ssm_mod.ssm_init(gen, cfg.d_model, cfg.ssm,
                                             dtype, lead=lead)
        layers["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                 lead=lead)
    p: Dict[str, Any] = {
        "embed": embed,
        "layers": layers,
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.value_head:
        p["value_head"] = dense_init(gen, cfg.d_model, 1, dtype, bias=True)
    return tree_to(p, device) if device is not None else p


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> Dict:
    """The pooled block KV cache ``[L, KV, NB, BS, Dh]``, zeroed."""
    reason = paged_arch_unsupported(cfg)
    if reason is not None:
        raise ValueError(f"{cfg.name}: paged decode unsupported: {reason}")
    shape = (cfg.n_layers, cfg.n_kv_heads, num_blocks, block_size,
             cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_layer_tail(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                      attn_out: torch.Tensor) -> torch.Tensor:
    """Post-attention half of a paged layer ([B, S, ...])."""
    b = x.shape[0]
    attn_out = attn_out.reshape(b, -1, cfg.n_heads * cfg.head_dim)
    x = x + dense_apply(lp["attn"]["wo"], attn_out)
    h = rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


def _paged_qkv(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections + rope for one paged layer ([B, S, ...]);
    ``positions`` is [B, S] absolute rope positions."""
    h = rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
    q = attn._split_heads(dense_apply(lp["attn"]["wq"], h), cfg.n_heads)
    k_new = attn._split_heads(dense_apply(lp["attn"]["wk"], h),
                              cfg.n_kv_heads)
    v_new = attn._split_heads(dense_apply(lp["attn"]["wv"], h),
                              cfg.n_kv_heads)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    return q, k_new, v_new


def _paged_head_full(params: Dict, cfg: ModelConfig, x: torch.Tensor
                     ) -> ModelOutput:
    """Final norm + readout (tied, or the ``lm_head``) over every query
    position ([B, S, V])."""
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = embedding_attend(params["embed"], x)
    else:
        logits = dense_apply(params["lm_head"], x)
    value = None
    if cfg.value_head:
        value = dense_apply(params["value_head"], x)[..., 0]
    return ModelOutput(logits=logits, value=value, cache=None,
                       aux_loss=torch.zeros((), device=x.device))


def _paged_head(params: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> ModelOutput:
    out = _paged_head_full(params, cfg, x)
    return out._replace(
        logits=out.logits[:, 0],
        value=None if out.value is None else out.value[:, 0])


def _embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    # Every path scales embeddings by sqrt(d_model), qwen included.
    return embedding_apply(params["embed"], tokens) * math.sqrt(cfg.d_model)


def _page_of(block_tables: torch.Tensor, positions: torch.Tensor,
             block_size: int) -> torch.Tensor:
    """Page id of each position through its slot's table ([B, S]).
    Positions past the table (padding rows only) clamp to its last
    entry; their writes are masked off by the caller."""
    idx = torch.clamp(positions // block_size, 0, block_tables.shape[1] - 1)
    return torch.gather(block_tables, 1, idx.long())


def decode_step_paged(
    params: Dict,
    cfg: ModelConfig,
    token: torch.Tensor,         # [B] current token ids (one per slot)
    pages: Dict,                 # {"k_pages","v_pages"} [L, KV, NB, BS, Dh]
    block_tables: torch.Tensor,  # [B, M] int32 page ids (pads in range)
    pos: torch.Tensor,           # [B] int32 tokens already cached per slot
    active: torch.Tensor,        # [B] bool; inactive slots write/read nothing
) -> Tuple[ModelOutput, Dict]:
    """One decode step for a batch of independent ragged requests: each
    slot writes its new K/V row at its own ``pos`` through its own table
    (in place), then attends over its ``pos + 1`` live positions
    through the decode kernel."""
    k_pages, v_pages = pages["k_pages"], pages["v_pages"]
    block_size = k_pages.shape[3]
    x = _embed(params, cfg, token[:, None])
    safe_pos = torch.clamp(pos, min=0)
    # The write's destinations and mask, once for every layer, in the
    # types the kernel reads (int32, and the bool mask as it is).
    page_idx = _page_of(block_tables, safe_pos[:, None], block_size)[:, 0]
    page_idx = page_idx.to(torch.int32).contiguous()
    offset = (safe_pos % block_size).to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    context_lens = torch.where(active, safe_pos + 1, 0).to(torch.int32)
    for layer in range(cfg.n_layers):
        lp = tree_map(lambda a: a[layer], params["layers"])
        q, k_new, v_new = _paged_qkv(cfg, lp, x, safe_pos[:, None])
        kops.paged_kv_write(k_pages, v_pages, k_new[:, 0], v_new[:, 0],
                            page_idx, offset, active, layer=layer)
        attn_out = kops.paged_attention(
            q[:, 0], k_pages[layer], v_pages[layer], block_tables,
            context_lens, window=cfg.window_for_layer(layer))
        x = _paged_layer_tail(cfg, lp, x, attn_out)
    return _paged_head(params, cfg, x), pages


def decode_step_paged_varlen(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] ragged token chunks, right-padded
    pages: Dict,                 # {"k_pages","v_pages"} [L, KV, NB, BS, Dh]
    block_tables: torch.Tensor,  # [B, M] int32 page ids (pads in range)
    row_start: torch.Tensor,     # [B] int32 rows already cached per slot
    row_len: torch.Tensor,       # [B] int32 live tokens per slot (0 = idle)
    write_cap: torch.Tensor,     # [B] int32 rows this slot owns pages for
) -> Tuple[ModelOutput, Dict]:
    """Score a ragged chunk of consecutive tokens per slot in one pass:
    token ``t < row_len[b]`` sits at ``row_start[b] + t``, writes its K/V
    row (dropped past ``write_cap``) and attends causally over its own
    prefix through the varlen kernel.  Padding rows write nothing and
    their logits are garbage.  All ``B * T`` rows of a layer are written
    by one kernel launch (the JAX step issues ``T``)."""
    k_pages, v_pages = pages["k_pages"], pages["v_pages"]
    b, t = tokens.shape
    block_size = k_pages.shape[3]
    x = _embed(params, cfg, tokens)
    safe_start = torch.clamp(row_start, min=0).to(torch.int32)
    row_len = row_len.to(torch.int32)
    steps = torch.arange(t, dtype=torch.int32, device=tokens.device)
    positions = safe_start[:, None] + steps[None, :]          # [B, T]
    # The write's destinations and mask, once for every layer, in the
    # types the kernel reads (int32, and the bool mask as it is).
    page_idx = _page_of(block_tables, positions, block_size).reshape(-1)
    page_idx = page_idx.to(torch.int32).contiguous()
    offset = (positions % block_size).reshape(-1).contiguous()
    live = steps[None, :] < row_len[:, None]
    write_ok = (live & (positions < write_cap[:, None])).reshape(-1)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    for layer in range(cfg.n_layers):
        lp = tree_map(lambda a: a[layer], params["layers"])
        q, k_new, v_new = _paged_qkv(cfg, lp, x, positions)
        kops.paged_kv_write(k_pages, v_pages, k_new.reshape(b * t, kv, dh),
                            v_new.reshape(b * t, kv, dh), page_idx, offset,
                            write_ok, layer=layer)
        attn_out = kops.paged_attention_varlen(
            q, k_pages[layer], v_pages[layer], block_tables, safe_start,
            row_len, window=cfg.window_for_layer(layer))
        x = _paged_layer_tail(cfg, lp, x, attn_out)
    return _paged_head_full(params, cfg, x), pages


def decode_step_paged_multi(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] consecutive tokens per slot
    pages: Dict,
    block_tables: torch.Tensor,  # [B, M] int32
    pos: torch.Tensor,           # [B] int32 tokens already cached per slot
    active: torch.Tensor,        # [B] bool
    write_cap: torch.Tensor,     # [B] int32
) -> Tuple[ModelOutput, Dict]:
    """Fixed-``T`` verify shape: every active slot scores ``T`` tokens
    at ``pos + t``; the varlen step with ``row_len = T`` (0 when
    inactive)."""
    t = tokens.shape[1]
    row_len = torch.where(active, t, 0).to(torch.int32)
    return decode_step_paged_varlen(params, cfg, tokens, pages,
                                    block_tables, pos, row_len, write_cap)


# ---------------------------------------------------------------------------
# Forward (train / prefill) and dense-cache decode
# ---------------------------------------------------------------------------


def _layers(params: Dict, n_layers: int):
    """Per-layer views of the stacked ``[L, ...]`` leaves.  ``unbind``
    makes the backward one stack per leaf, where indexing each layer
    would allocate a zero ``[L, ...]`` gradient per layer."""
    per_leaf = tree_map(lambda a: a.unbind(0), params["layers"])
    return [tree_map(lambda t: t[i], per_leaf) for i in range(n_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict:
    """The decode cache for ``batch`` streams of up to ``max_len``
    tokens, with ``pos``: dense ``k``/``v`` ``[L, B, max_len, KV, Dh]``,
    for hybrid configs also the float32 SSM state ``ssm`` ``[L, B, I,
    N]`` and the conv window ``conv`` ``[L, B, W-1, I]``; for
    attention-free configs (any length) the float32 WKV state ``wkv``
    ``[L, B, H, 64, 64]`` and the token shifts ``shift_tm`` /
    ``shift_cm`` ``[L, B, 1, D]``."""
    _check_arch(cfg)
    c = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
    L = cfg.n_layers
    if cfg.attn_free:
        hd = rwkv_mod.HEAD_DIM
        c["wkv"] = torch.zeros((L, batch, cfg.d_model // hd, hd, hd),
                               dtype=torch.float32, device=device)
        for k in ("shift_tm", "shift_cm"):
            c[k] = torch.zeros((L, batch, 1, cfg.d_model), dtype=dtype,
                               device=device)
        return c
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    c["k"] = torch.zeros(shape, dtype=dtype, device=device)
    c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.hybrid_attn_ssm:
        inner = cfg.ssm.expand * cfg.d_model
        c["ssm"] = torch.zeros((L, batch, inner, cfg.ssm.state_dim),
                               dtype=torch.float32, device=device)
        c["conv"] = torch.zeros((L, batch, cfg.ssm.conv_width - 1, inner),
                                dtype=dtype, device=device)
    return c


def _rwkv_layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, ...]] = None):
    """One attention-free layer over ``x`` [B, S, D]; ``state`` is
    ``(wkv, shift_tm, shift_cm)`` (None: zeros).  Returns ``(x, new
    state)``.  Left-padded prompts run through the recurrence as in the
    reference (no padding mask)."""
    h = rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
    out, (wkv, shift_tm) = rwkv_mod.rwkv6_time_mix(
        lp["rwkv"], h, None if state is None else state[:2])
    x = x + out
    h = rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
    out, shift_cm = rwkv_mod.rwkv6_channel_mix(
        lp["rwkv"], h, None if state is None else state[2])
    return x + out, (wkv, shift_tm, shift_cm)


_RWKV_STATE = ("wkv", "shift_tm", "shift_cm")


def forward(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                      # [B, S]
    *,
    return_cache: bool = False,
    cache_len: Optional[int] = None,           # cache capacity for prefill
) -> ModelOutput:
    """Logits ``[B, S, V]`` and values ``[B, S]`` of every position;
    with ``return_cache`` also the decode cache after the sequence: its
    K/V rows in a dense cache sized for ``cache_len`` tokens (hybrid
    configs: and each layer's final SSM state and conv window), or for
    attention-free configs each layer's final WKV state and shifts.
    Hybrid layers add the mean of the attention and SSM heads, both fed
    the same normed input."""
    _check_arch(cfg)
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    if cfg.attn_free:
        cache = None
        if return_cache:
            cache = init_cache(cfg, b, s, x.dtype, tokens.device)
            cache["pos"].fill_(s)
        for layer, lp in enumerate(_layers(params, cfg.n_layers)):
            x, state = _rwkv_layer(cfg, lp, x)
            if cache is not None:
                for k, t in zip(_RWKV_STATE, state):
                    cache[k][layer] = t.detach()
        return _paged_head_full(params, cfg, x)._replace(cache=cache)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    cache = None
    if return_cache:
        cache = init_cache(cfg, b, cache_len if cache_len is not None else s,
                           x.dtype, tokens.device)
        cache["pos"].fill_(s)
    for layer, lp in enumerate(_layers(params, cfg.n_layers)):
        h = rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
        attn_out, (k, v) = attn.attn_forward(
            lp["attn"], h, positions, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
            window=cfg.window_for_layer(layer))
        if cfg.hybrid_attn_ssm:
            ssm_out, (ssm_state, conv_state) = ssm_mod.ssm_forward(
                lp["ssm"], h, cfg.ssm)
            x = x + 0.5 * (attn_out + ssm_out)     # hymba: mean-fused heads
            if cache is not None:
                cache["ssm"][layer] = ssm_state.detach()
                cache["conv"][layer] = conv_state.detach()
        else:
            x = x + attn_out
        if cache is not None:
            cache["k"][layer, :, :s] = k.detach()
            cache["v"][layer, :, :s] = v.detach()
        h = rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    return _paged_head_full(params, cfg, x)._replace(cache=cache)


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict) -> Tuple[ModelOutput, Dict]:
    """One autoregressive step of ``token`` [B] against the cache
    (written in place); returns logits ``[B, V]`` and the cache with
    ``pos + 1``."""
    _check_arch(cfg)
    x = _embed(params, cfg, token[:, None])
    pos = cache["pos"]
    if cfg.attn_free:
        for layer, lp in enumerate(_layers(params, cfg.n_layers)):
            x, state = _rwkv_layer(
                cfg, lp, x, tuple(cache[k][layer] for k in _RWKV_STATE))
            for k, t in zip(_RWKV_STATE, state):
                cache[k][layer] = t
        return _paged_head(params, cfg, x), dict(cache, pos=pos + 1)
    for layer, lp in enumerate(_layers(params, cfg.n_layers)):
        h = rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
        attn_out = attn.attn_decode(
            lp["attn"], h, pos, cache["k"][layer], cache["v"][layer],
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            rope_theta=cfg.rope_theta, window=cfg.window_for_layer(layer))
        if cfg.hybrid_attn_ssm:
            ssm_out, (ssm_state, conv_state) = ssm_mod.ssm_forward(
                lp["ssm"], h, cfg.ssm,
                state=(cache["ssm"][layer], cache["conv"][layer]))
            cache["ssm"][layer] = ssm_state
            cache["conv"][layer] = conv_state
            x = x + 0.5 * (attn_out + ssm_out)
        else:
            x = x + attn_out
        h = rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    return _paged_head(params, cfg, x), dict(cache, pos=pos + 1)
