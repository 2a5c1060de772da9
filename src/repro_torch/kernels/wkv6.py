"""Wrapper of the CUDA WKV6 kernels (``csrc/wkv6.cu``).

Replaces the Pallas kernel ``repro.kernels.wkv6_pallas.wkv6_pallas``.
The plain version is ``kernels.ref.ref_wkv6``; ``ref.ref_wkv6_chunked``
is the plain form of the chunked and split instantiations.  The kernels
have no backward yet (serving needs none), so the wrapper refuses inputs
that require grad.

Three instantiations (:func:`wkv6_impl` picks one and names it):
``serial``, a thread per value column walking every step, for a decode
step and very short prefills; ``chunked``, one block per (b, h) walking
16-step sub-chunks whose products run from shared memory, for prefills
and long sequences; ``split``, the chunked form over segments of the
sequence in parallel (segment end states, a carry across segments, the
output from each segment's true start), for long sequences of a small
batch (rwkv6's B 1 x S 2048 forward).
"""
from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KEY_DIMS = (8, 16, 32, 64)
IMPLS = ("serial", "chunked", "split")
SUB_STEPS = 16        # steps per sub-chunk of the chunked kernels
SM_COUNT = 132
# The serial kernel walks every step as a chain; the chunked kernel pays
# a sub-chunk's preparation and a block barrier before its products; the
# split one adds a pass over all but the last segment and a carry.  From
# chip_smoke.py phase 13's wkv6_crossover records (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md), at rwkv6's 32 heads of 64: the chunked kernel wins
# from S 8 (at B 8 by 2 %), and the split one from S 128 while B x H
# blocks fill at most half the SMs (B 1; B 2 ties at S 128 and wins from
# S 256; at B 4 the chunked grid already covers the card).
CHUNKED_MIN_STEPS = 8
SPLIT_MIN_STEPS = 128
# The split instantiation aims at SPLIT_BLOCKS_PER_SM blocks an SM.
SPLIT_BLOCKS_PER_SM = 2

# r, k, v, w, u, state_in, y, state_out, scratch | B S H K V dtype impl
# seg | stream
KERNEL = Kernel("wkv6", [c_void_p] * 9 + [c_int] * 8 + [c_void_p])


def wkv6_impl(batch: int, steps: int, heads: int) -> str:
    """The instantiation a call of these sizes takes."""
    if steps < CHUNKED_MIN_STEPS:
        return "serial"
    if steps >= SPLIT_MIN_STEPS and 2 * batch * heads <= SM_COUNT:
        return "split"
    return "chunked"


def split_steps(batch: int, steps: int, heads: int) -> int:
    """Steps per segment of the split instantiation at these sizes: a
    multiple of the sub-chunk, as many segments as keep the emitting
    kernel's grid within SPLIT_BLOCKS_PER_SM blocks an SM (one wave)."""
    n_seg = max(1, SPLIT_BLOCKS_PER_SM * SM_COUNT // (batch * heads))
    seg = -(-steps // n_seg)
    return -(-seg // SUB_STEPS) * SUB_STEPS


def wkv6_cuda(
    r: torch.Tensor,                       # [B, S, H, K]
    k: torch.Tensor,                       # [B, S, H, K]
    v: torch.Tensor,                       # [B, S, H, V]
    w: torch.Tensor,                       # [B, S, H, K] decay in [0, 1]
    u: torch.Tensor,                       # [H, K]
    state: Optional[torch.Tensor] = None,  # [B, H, K, V] float32
    *,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, H, V]`` in the inputs' dtype, ``final_state [B, H, K,
    V]`` float32)`` from inputs of one dtype (float32 or bfloat16),
    contiguous, on one CUDA device; ``state=None`` starts from zeros.
    ``K`` is 8, 16, 32 or 64 and ``V`` at most 64 (a multiple of 8 for
    the chunked and split instantiations).  ``impl`` forces an
    instantiation (one of :data:`IMPLS`); None takes
    :func:`wkv6_impl`'s (``serial`` where V is not a multiple of 8)."""
    name = KERNEL.name
    tensors = (r, k, v, w, u) + (() if state is None else (state,))
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; pass inputs "
                         "that do not require grad")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, w, u)):
        raise TypeError(f"{name}: r, k, v, w, u must share float32 or "
                        f"bfloat16, got {[t.dtype for t in tensors[:5]]}")
    if state is not None and state.dtype != torch.float32:
        raise TypeError(f"{name}: the state is float32, got {state.dtype}")
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be [B, S, H, K], got {r.shape}")
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape
            or v.shape != (b, s, h, vd) or u.shape != (h, kd)
            or (state is not None and state.shape != (b, h, kd, vd))
            or min(b, s, h) < 1 or kd not in _KEY_DIMS or not 1 <= vd <= 64):
        shapes = [tuple(t.shape) for t in tensors]
        raise ValueError(f"{name}: bad shapes {shapes}")
    if impl is None:
        impl = wkv6_impl(b, s, h) if vd % 8 == 0 else "serial"
    if impl not in IMPLS:
        raise ValueError(f"{name}: impl is one of {IMPLS}, got {impl}")
    if impl != "serial" and vd % 8:
        raise ValueError(f"{name}: the {impl} instantiation needs V a "
                         f"multiple of 8, got {vd}")
    seg = split_steps(b, s, h) if impl == "split" else 0
    carried = -(-s // seg) - 1 if seg else 0
    scratch = torch.empty(carried * b * h * (kd * vd + kd),
                          dtype=torch.float32, device=r.device) \
        if carried else None
    y = torch.empty((b, s, h, vd), dtype=r.dtype, device=r.device)
    final = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    KERNEL.launch(r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(),
                  None if state is None else state.data_ptr(),
                  y.data_ptr(), final.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), b, s, h,
                  kd, vd, _DTYPES[r.dtype], IMPLS.index(impl), seg)
    return y, final
