"""Wrapper of the CUDA paged decode attention (``csrc/paged_attention.cu``).

Replaces the Pallas kernel ``repro.kernels.paged_attention_pallas.
paged_attention``.  The plain version is ``kernels.ref.ref_paged_attention``.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Optional, Sequence

import torch

from repro_torch.kernels.build import Kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256   # paged::kMaxHeadDim (gemma3)

# q, k, v, tables, context_lens, out | B H KV NB BS D M window | scale
# dtype stream
KERNEL = Kernel("paged_attention",
                [c_void_p] * 6 + [c_int] * 8 + [c_float, c_int, c_void_p])


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
    """Single-token decode attention over the paged pool ([B, H, D])."""
    if q.dim() != 3:
        raise ValueError(f"{KERNEL.name}: q must be [B, H, D]")
    check_inputs(KERNEL.name, q, k_pages, v_pages, block_tables,
                 (context_lens,))
    b, h, d = q.shape
    kv, nb, bs, _ = k_pages.shape
    out = torch.empty_like(q)
    KERNEL.launch(q.device, q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_tables.data_ptr(),
                  context_lens.data_ptr(),
                  out.data_ptr(), b, h, kv, nb, bs, d, block_tables.shape[1],
                  -1 if window is None else int(window), d ** -0.5,
                  DTYPES[q.dtype])
    return out
