"""Wrapper of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

Replaces the Pallas kernel ``repro.kernels.ssm_scan_pallas.ssm_scan_pallas``.
The plain version is ``kernels.ref.ref_ssm_scan``.  The kernel has no
backward yet (serving needs none), so the wrapper refuses inputs that
require grad.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16

# u, dt, b_t, c_t, a, h0, y, h_final | B S I N dtype | stream
KERNEL = Kernel("ssm_scan", [c_void_p] * 8 + [c_int] * 5 + [c_void_p])


def ssm_scan_cuda(
    u: torch.Tensor,                    # [B, S, I]
    dt: torch.Tensor,                   # [B, S, I]
    b_t: torch.Tensor,                  # [B, S, N]
    c_t: torch.Tensor,                  # [B, S, N]
    a: torch.Tensor,                    # [I, N] float32
    h0: Optional[torch.Tensor] = None,  # [B, I, N] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, I]`` in u's dtype, ``h_final [B, I, N]`` float32)``
    from u, dt, b_t, c_t of one dtype (float32 or bfloat16) and a float32
    ``a`` (and ``h0``), contiguous, on one CUDA device; ``h0=None``
    starts from zeros.  N is at most 16."""
    name = KERNEL.name
    tensors = (u, dt, b_t, c_t, a) + (() if h0 is None else (h0,))
    if any(t.device.type != "cuda" or t.device != u.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; pass inputs "
                         "that do not require grad")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype
                                     for t in (dt, b_t, c_t)):
        raise TypeError(f"{name}: u, dt, b_t, c_t must share float32 or "
                        f"bfloat16, got {[t.dtype for t in tensors[:4]]}")
    if a.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError(f"{name}: a and h0 are float32")
    if u.dim() != 3:
        raise ValueError(f"{name}: u must be [B, S, I], got {u.shape}")
    bsz, s, inner = u.shape
    n = a.shape[-1]
    if (dt.shape != u.shape or b_t.shape != (bsz, s, n)
            or c_t.shape != b_t.shape or a.shape != (inner, n)
            or (h0 is not None and h0.shape != (bsz, inner, n))
            or min(bsz, s, inner) < 1 or not 1 <= n <= MAX_STATE):
        raise ValueError(f"{name}: bad shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    y = torch.empty_like(u)
    h_final = torch.empty((bsz, inner, n), dtype=torch.float32,
                          device=u.device)
    with torch.cuda.device(u.device):
        KERNEL(u.data_ptr(), dt.data_ptr(), b_t.data_ptr(), c_t.data_ptr(),
               a.data_ptr(), None if h0 is None else h0.data_ptr(),
               y.data_ptr(), h_final.data_ptr(), bsz, s, inner, n,
               _DTYPES[u.dtype], torch.cuda.current_stream().cuda_stream)
    return y, h_final
