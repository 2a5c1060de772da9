"""Grouped-query attention with RoPE, sliding windows and dense KV-cache
decode (port of ``repro.models.attention``).

The full-sequence forward (``attn_forward``) picks its attention by
need: when q, k and v need no gradient (generation's prefill, no-grad
scoring) it goes through ``kernels.ops.attention``, the flash-attention
kernel on the card (the Pallas kernel's "serve/prefill path"); when a
gradient is needed (the learner) the einsum ``kernels.ref.ref_attention``
stays, as JAX trains through the XLA reference.  Both compute the same
function.  The one-token ``attn_decode`` stays einsum over the dense
cache (``kernels.ref.masked_attention``): JAX has no kernel there.  A
window is a static ``Optional[int]`` per layer (None = global), where
JAX traces a per-layer float (``jnp.inf`` = global).  The q-chunked
path the JAX package takes above ``CHUNKED_ATTN_THRESHOLD`` query rows
is not ported yet: longer sequences raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.layers import apply_rope, dense_apply, dense_init

CHUNKED_ATTN_THRESHOLD = 2048


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, qkv_bias: bool = False,
              dtype=torch.float32, lead: Sequence[int] = ()) -> Dict:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype,
                         bias=qkv_bias, lead=lead),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype,
                         bias=qkv_bias, lead=lead),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype,
                         bias=qkv_bias, lead=lead),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, lead=lead),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def make_attention_mask(
    q_positions: torch.Tensor,    # [B, Sq]
    kv_positions: torch.Tensor,   # [B, Sk]
    *,
    window: Optional[int],        # None = global
    kv_valid: Optional[torch.Tensor] = None,   # [B, Sk] bool
) -> torch.Tensor:
    """Causal boolean [B, 1, Sq, Sk] mask (True = attend).  The
    prefix-LM and non-causal forms of the reference serve archs the port
    refuses (vision prefixes, encoder-decoder)."""
    q = q_positions[:, :, None].to(torch.int32)
    k = kv_positions[:, None, :].to(torch.int32)
    mask = q >= k
    if window is not None:
        mask = mask & ((q - k).float() < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask[:, None, :, :]


def attn_forward(
    p: Dict,
    x: torch.Tensor,              # [B, S, D]
    positions: torch.Tensor,      # [B, S]
    *,
    n_heads: int,
    n_kv_heads: int,
    rope_theta: float,
    window: Optional[int],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention (train / prefill) over the
    positions ``0 .. S-1`` that ``positions`` holds in every row.
    Returns ``(out [B, S, D], (k, v) [B, S, KV, Dh])``, k after RoPE.
    Without a gradient the attention runs through ``kops.attention``
    (the kernel on the card), with one through the einsum
    ``ref.ref_attention``."""
    if x.shape[1] > CHUNKED_ATTN_THRESHOLD:
        raise NotImplementedError(
            f"sequences over {CHUNKED_ATTN_THRESHOLD} tokens take the "
            "q-chunked attention, which is not ported yet")
    q = _split_heads(dense_apply(p["wq"], x), n_heads)
    k = _split_heads(dense_apply(p["wk"], x), n_kv_heads)
    v = _split_heads(dense_apply(p["wv"], x), n_kv_heads)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    needs_grad = q.requires_grad or k.requires_grad or v.requires_grad
    attend = ref.ref_attention if needs_grad else kops.attention
    out = attend(q, k, v, window=window).flatten(2)
    return dense_apply(p["wo"], out), (k, v)


def attn_decode(
    p: Dict,
    x: torch.Tensor,              # [B, 1, D]
    position: torch.Tensor,       # [B] current absolute position
    cache_k: torch.Tensor,        # [B, Smax, KV, Dh]
    cache_v: torch.Tensor,        # [B, Smax, KV, Dh]
    *,
    n_heads: int,
    n_kv_heads: int,
    rope_theta: float,
    window: Optional[int],
) -> torch.Tensor:
    """Single-token decode against a dense KV cache.  The new K/V row is
    written at ``position`` in place (JAX blends it in with a one-hot and
    returns new caches; the values are the same), then the token attends
    over every row ``<= position``.  Returns the attention output."""
    b, smax = cache_k.shape[0], cache_k.shape[1]
    q = _split_heads(dense_apply(p["wq"], x), n_heads)
    k_new = _split_heads(dense_apply(p["wk"], x), n_kv_heads)
    v_new = _split_heads(dense_apply(p["wv"], x), n_kv_heads)
    q = apply_rope(q, position[:, None], rope_theta)
    k_new = apply_rope(k_new, position[:, None], rope_theta)
    rows = torch.arange(b, device=x.device)
    pos = position.long()
    cache_k[rows, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, pos] = v_new[:, 0].to(cache_v.dtype)
    kv_pos = torch.arange(smax, dtype=torch.int32,
                          device=x.device)[None, :].expand(b, smax)
    mask = make_attention_mask(position[:, None], kv_pos, window=window,
                               kv_valid=kv_pos <= position[:, None])
    out = ref.masked_attention(q, cache_k, cache_v, mask).flatten(2)
    return dense_apply(p["wo"], out)
