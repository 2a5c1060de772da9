"""Wrapper of the CUDA ragged paged attention
(``csrc/paged_attention_varlen.cu``).

Replaces the Pallas kernel ``repro.kernels.paged_attention_pallas.
paged_attention_varlen``.  The plain version is
``kernels.ref.ref_paged_attention_varlen``.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Optional

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.paged_attention import DTYPES, check_inputs

# q, k, v, tables, row_start, row_len, out | B T H KV NB BS D M window |
# scale dtype stream
KERNEL = Kernel("paged_attention_varlen",
                [c_void_p] * 7 + [c_int] * 9 + [c_float, c_int, c_void_p])


def paged_attention_varlen_cuda(
    q: torch.Tensor,             # [B, T, H, D]
    k_pages: torch.Tensor,       # [KV, NB, BS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    row_start: torch.Tensor,     # [B] int32
    row_len: torch.Tensor,       # [B] int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ragged multi-row attention over the paged pool ([B, T, H, D])."""
    if q.dim() != 4:
        raise ValueError(f"{KERNEL.name}: q must be [B, T, H, D]")
    check_inputs(KERNEL.name, q, k_pages, v_pages, block_tables,
                 (row_start, row_len))
    b, t, h, d = q.shape
    kv, nb, bs, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               block_tables.data_ptr(), row_start.data_ptr(),
               row_len.data_ptr(), out.data_ptr(), b, t, h, kv, nb, bs, d,
               block_tables.shape[1],
               -1 if window is None else int(window), d ** -0.5,
               DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    return out
