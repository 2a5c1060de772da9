"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas kernel
``repro.kernels.flash_attention_pallas.flash_attention``.  The plain
version is ``kernels.ref.ref_attention``.  Like the Pallas kernel it is
causal and forward-only (the prefill path), so the wrapper refuses
inputs that require grad; training keeps the einsum attention, which
autodiffs.

Two instantiations, chosen by the C launcher from dtype and head dim
alone (:func:`flash_impl` names the one a call takes): bfloat16 at D 64
(every model the port serves) takes ``wgmma``, tensor cores fed by TMA
(``flash_kernel_wgmma``); float32 at any head dim, and bfloat16 at D 8,
16 and 32, take ``fma``, float32 FMA from shared memory
(``flash_kernel``).
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)
_WGMMA_MAX_GROUP = 64   # query heads per kv head: one 64-row wgmma tile

# q, k, v, out | B S H KV D window dtype | scale | stream
KERNEL = Kernel("flash_attention",
                [c_void_p] * 4 + [c_int] * 7 + [c_float, c_void_p])


def flash_impl(dtype: torch.dtype, head_dim: int) -> str:
    """The instantiation the launcher takes for these inputs:
    ``"wgmma"`` for bfloat16 at head dim 64, ``"fma"`` otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim == 64 else "fma"


def flash_attention_cuda(
    q: torch.Tensor,               # [B, S, H, D]
    k: torch.Tensor,               # [B, S, KV, D]
    v: torch.Tensor,               # [B, S, KV, D]
    *,
    window: Optional[int] = None,  # None = global
) -> torch.Tensor:
    """Causal attention of every position over its prefix (and within
    ``window`` of it), ``[B, S, H, D]`` in q's dtype, from inputs of one
    dtype (float32 or bfloat16), contiguous, on one CUDA device; H a
    multiple of KV and D in {8, 16, 32, 64}.  The instantiation is
    ``flash_impl(q.dtype, D)``; ``wgmma`` also needs H / KV <= 64 and
    16-byte aligned inputs."""
    name = KERNEL.name
    tensors = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; pass inputs "
                         "that do not require grad")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got {q.shape}")
    b, s, h, d = q.shape
    kv = k.shape[2] if k.dim() == 4 else 0
    if (k.shape != (b, s, kv, d) or v.shape != k.shape or kv < 1
            or h % kv or min(b, s) < 1 or d not in _HEAD_DIMS):
        raise ValueError(f"{name}: bad shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got {window}")
    if flash_impl(q.dtype, d) == "wgmma":
        if h // kv > _WGMMA_MAX_GROUP:
            raise ValueError(f"{name}: bfloat16 at D 64 takes at most "
                             f"{_WGMMA_MAX_GROUP} query heads per kv head, "
                             f"got {h // kv}")
        if any(t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"{name}: the wgmma path's TMA needs q, k, v "
                             "16-byte aligned")
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, s, h, kv, d,
                  0 if window is None else int(window), _DTYPES[q.dtype],
                  d ** -0.5)
    return out
