"""Shared building blocks (port of ``repro.models.layers``).

Conventions kept from the JAX package:

* params are nested dicts of tensors; ``*_init`` functions build them.
* dense weights are ``[d_in, d_out]`` and apply as ``x @ w``.
* compute dtype follows the input ``x``; norms and rope run in float32.
* matmul inits are truncated normal on [-2, 2] with 1/sqrt(fan_in)
  scaling, drawn from an explicit ``torch.Generator``.  ``lead`` prepends
  axes (the ``[L]`` layer stack) to every leaf.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def _trunc_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, bias: bool = False, scale: float = 1.0,
               lead: Sequence[int] = ()) -> Dict:
    std = scale / (d_in ** 0.5)
    p = {"w": (std * _trunc_normal(gen, (*lead, d_in, d_out))).to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    return p


def dense_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> Dict:
    emb = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                      device=gen.device)
    return {"table": (emb * (d ** -0.5)).to(dtype)}


def embedding_apply(p: Dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


def embedding_attend(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-softmax readout: ``x @ table.T``."""
    return x @ p["table"].to(x.dtype).T


def rmsnorm_init(d: int, dtype=torch.float32, lead: Sequence[int] = (),
                 device=None) -> Dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm_apply(p: Dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split / NeoX layout, float32)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """[head_dim // 2] inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """``x`` [..., S, H, Dh] rotated at ``positions`` [..., S]."""
    dh = x.shape[-1]
    inv_freq = rope_frequencies(dh, theta, device=x.device)
    angles = positions[..., None].float() * inv_freq        # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Feed-forward blocks
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
             lead: Sequence[int] = ()) -> Dict:
    """SwiGLU feed-forward (the only activation the port's configs use)."""
    return {
        "gate": dense_init(gen, d, d_ff, dtype, lead=lead),
        "up": dense_init(gen, d, d_ff, dtype, lead=lead),
        "down": dense_init(gen, d_ff, d, dtype, lead=lead),
    }


def mlp_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense_apply(p["gate"], x)) * dense_apply(p["up"], x)
    return dense_apply(p["down"], h)
