"""Wrapper of the CUDA K/V row scatter (``csrc/paged_kv_write.cu``).

Replaces the Pallas kernel ``repro.kernels.paged_kv_write_pallas.
paged_kv_write``.  The plain version is ``kernels.ref.ref_paged_kv_write``.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# k, v, k_rows, v_rows, page_idx, offset, active | N L KV NB BS D layer
# dtype | stream
KERNEL = Kernel("paged_kv_write", [c_void_p] * 7 + [c_int] * 8 + [c_void_p])


def paged_kv_write_cuda(
    k_pages: torch.Tensor,   # [L, KV, NB, BS, D] written in place
    v_pages: torch.Tensor,
    k_rows: torch.Tensor,    # [N, KV, D] of the pool's dtype
    v_rows: torch.Tensor,
    page_idx: torch.Tensor,  # [N] int32
    offset: torch.Tensor,    # [N] int32
    active: torch.Tensor,    # [N] int32 (0 = drop the row)
    *,
    layer: int,
):
    """Scatter N K/V rows into layer ``layer`` of the pools, in place;
    returns the (same) pools."""
    name = KERNEL.name
    n, kv, d = k_rows.shape
    L, kv_p, nb, bs, d_p = k_pages.shape
    tensors = (k_pages, v_pages, k_rows, v_rows, page_idx, offset, active)
    if any(t.device.type != "cuda" or t.device != k_pages.device
           for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if k_pages.dtype not in _DTYPES or any(
            t.dtype != k_pages.dtype for t in (v_pages, k_rows, v_rows)):
        raise TypeError(f"{name}: pools and rows must share float32 or "
                        f"bfloat16, got {k_pages.dtype}/{k_rows.dtype}")
    if any(t.dtype != torch.int32 for t in (page_idx, offset, active)):
        raise TypeError(f"{name}: page_idx/offset/active must be int32")
    if v_pages.shape != k_pages.shape or v_rows.shape != k_rows.shape or \
            (kv, d) != (kv_p, d_p) or not 0 <= layer < L or \
            any(t.shape != (n,) for t in (page_idx, offset, active)):
        raise ValueError(f"{name}: bad shapes pages {tuple(k_pages.shape)} "
                         f"rows {tuple(k_rows.shape)} layer {layer}")
    if n == 0:
        return k_pages, v_pages
    with torch.cuda.device(k_pages.device):
        KERNEL(k_pages.data_ptr(), v_pages.data_ptr(), k_rows.data_ptr(),
               v_rows.data_ptr(), page_idx.data_ptr(), offset.data_ptr(),
               active.data_ptr(), n, L, kv, nb, bs, d, layer,
               _DTYPES[k_pages.dtype], torch.cuda.current_stream().cuda_stream)
    return k_pages, v_pages
