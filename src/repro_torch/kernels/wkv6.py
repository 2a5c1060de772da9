"""Wrappers of the CUDA WKV6 kernels (``csrc/wkv6.cu`` and
``csrc/wkv6_bwd.cu``) and their autograd function.

The forward replaces the Pallas kernel
``repro.kernels.wkv6_pallas.wkv6_pallas``; the backward replaces the
gradient that ``jax.grad`` takes through ``repro.models.rwkv6.wkv6_scan``
(the Pallas kernel is forward-only).  The plain versions are
``kernels.ref.ref_wkv6`` and ``ref_wkv6_backward``;
``ref.ref_wkv6_chunked`` is the plain form of the chunked and split
instantiations.  ``wkv6_cuda`` refuses inputs that require grad: those
go through ``WKV6Fn``, which runs the kernels on CUDA tensors and the
plain versions on CPU tensors, so the CPU tests drive the same
forward/backward wiring the card runs.  The backward recomputes the
states from the inputs, so a forward that will be differentiated saves
nothing more than its inputs and costs what a no-grad forward costs.

Three instantiations (:func:`wkv6_impl` picks one and names it):
``serial``, a thread per value column walking every step, for a decode
step and very short prefills; ``chunked``, one block per (b, h) walking
16-step sub-chunks whose products run from shared memory, for prefills
and long sequences; ``split``, the chunked form over segments of the
sequence in parallel (segment end states, a carry across segments, the
output from each segment's true start), for long sequences of a small
batch (rwkv6's B 1 x S 2048 forward).

The backward has two (:func:`wkv6_bwd_impl`): ``chunked``, a block per
(b, h) walking 16-step sub-chunks forward for their start states, then
back with the products on the tensor cores, for the learner's shape;
``split``, the same over segments of the sequence in parallel (each
segment's local end state and start-gradient, a carry pass both ways,
then each segment from its true start state and end-gradient), for long
sequences of a small batch.  ``ref.ref_wkv6_backward_chunked`` is their
plain form.
"""
from __future__ import annotations

import ctypes
from ctypes import c_int, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, check, load

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
# r, k, v, w, u, state_in, dy, dstate_final, dr, dk, dv, dw, du, dstate,
# scratch | B S H K V dtype seg | stream
BWD_KERNEL = Kernel("wkv6_bwd", [c_void_p] * 15 + [c_int] * 7 + [c_void_p])
BWD_IMPLS = ("chunked", "split")
# The backward's split instantiation pays a first pass over every segment
# and a carry, and wins where B x H blocks leave SMs idle.  From
# chip_smoke.py phase 33's wkv6_bwd_crossover records (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md row 7b) at rwkv6's 32 heads of 64, chunked /
# split ms: split wins from S 64 while B x H fills at most half the SMs
# (B 1 and 2: 0.040 / 0.024 and 0.041 / 0.030 at S 64), and from S 512
# while it fills at most all of them (B 4: 0.156 / 0.169 at S 256, 0.312
# / 0.308 at S 512, 1.176 / 1.134 at S 2048); at B 8 chunked wins
# everywhere.
BWD_SPLIT_MIN_STEPS = 64
BWD_SPLIT_MIN_STEPS_FULL = 512
# The backward's split instantiation aims at BWD_SPLIT_BLOCKS_PER_SM
# blocks an SM: at B 1 x S 2048 segments of 128 steps, 0.315 ms, where
# 64 / 256 steps take 0.332 / 0.300 and 32 / 512 0.387 / 0.392.
BWD_SPLIT_BLOCKS_PER_SM = 4


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


def wkv6_bwd_impl(batch: int, steps: int, heads: int) -> str:
    """The backward instantiation a call of these sizes takes."""
    blocks = batch * heads
    if ((steps >= BWD_SPLIT_MIN_STEPS and 2 * blocks <= SM_COUNT)
            or (steps >= BWD_SPLIT_MIN_STEPS_FULL and blocks <= SM_COUNT)):
        return "split"
    return "chunked"


def bwd_split_steps(batch: int, steps: int, heads: int) -> int:
    """Steps per segment of the backward's split instantiation: a
    multiple of the sub-chunk, as many segments as keep its grids within
    BWD_SPLIT_BLOCKS_PER_SM blocks an SM."""
    n_seg = max(1, BWD_SPLIT_BLOCKS_PER_SM * SM_COUNT // (batch * heads))
    seg = -(-steps // n_seg)
    return -(-seg // SUB_STEPS) * SUB_STEPS


def _check(name, r, k, v, w, u, state) -> Tuple[int, ...]:
    """Device, layout, dtype and shape checks shared by both kernels;
    returns ``(B, S, H, K, V)``."""
    tensors = (r, k, v, w, u) + (() if state is None else (state,))
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
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
    return b, s, h, kd, vd


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
    if any(t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        raise ValueError(f"{name}: the forward kernel has no backward of "
                         "its own; inputs that require grad go through "
                         "WKV6Fn (ops.wkv6), whose backward is wkv6_bwd")
    b, s, h, kd, vd = _check(name, r, k, v, w, u, state)
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


def bwd_scratch_floats(batch: int, steps: int, heads: int, kd: int,
                       vd: int, seg: int = 0) -> int:
    """float32 scratch of the backward at these sizes and segment length
    (0: chunked), as the C side sizes it (``csrc/wkv6_bwd.cu``:
    ``wkv6_bwd_scratch_floats``): du's per-(b, segment) partials, the
    sub-chunk start states a block keeps off chip, and for the split
    instantiation the carried states, end-gradients and decays."""
    fn = load(BWD_KERNEL.name).wkv6_bwd_scratch_floats
    fn.argtypes = [c_int] * 6
    fn.restype = ctypes.c_longlong
    floats = fn(batch, steps, heads, kd, vd, seg)
    if floats < 0:
        raise ValueError(f"{BWD_KERNEL.name}: bad sizes B {batch} S {steps} "
                         f"H {heads} K {kd} V {vd} seg {seg}")
    return floats


def wkv6_bwd_info(dtype: torch.dtype) -> dict:
    """What the backward's kernels take on the current card, by name
    (``main``: the per-segment kernel both instantiations run; ``local``:
    the split's first pass): registers and spilled (local) bytes a
    thread, blocks resident on an SM, dynamic shared bytes a block, and
    the steps of a sub-chunk (``csrc/wkv6_bwd.cu``: ``wkv6_bwd_info``)."""
    fn = load(BWD_KERNEL.name).wkv6_bwd_info
    fn.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    fn.restype = c_int
    out = {}
    for which, name in enumerate(("main", "local")):
        vals = (c_int * 5)()
        check(fn(_DTYPES[dtype], which, vals), "wkv6_bwd_info")
        out[name] = dict(registers=vals[0], local_bytes=vals[1],
                         blocks_per_sm=vals[2], smem_bytes=vals[3],
                         sub=vals[4])
    return out


def wkv6_bwd_cuda(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, state: Optional[torch.Tensor], y_grad: torch.Tensor,
    state_grad: Optional[torch.Tensor], *, impl: Optional[str] = None,
    seg: Optional[int] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dr, dk, dv, dw, du, dstate)`` of :func:`wkv6_cuda` at the
    gradients ``y_grad`` [B, S, H, V] (r's dtype, contiguous) and
    ``state_grad`` [B, H, K, V] float32 (None: zeros) of its outputs.
    The inputs as the forward takes them, V a multiple of 8; dr, dk, dv,
    dw and du in their dtype, dstate [B, H, K, V] float32 (None when
    ``state`` is None).  ``impl`` forces an instantiation (one of
    :data:`BWD_IMPLS`), ``seg`` the split one's segment length (a
    multiple of 16); None takes :func:`wkv6_bwd_impl`'s and
    :func:`bwd_split_steps`'."""
    name = BWD_KERNEL.name
    b, s, h, kd, vd = _check(name, r, k, v, w, u, state)
    if (y_grad.device != r.device or y_grad.dtype != r.dtype
            or y_grad.shape != v.shape or not y_grad.is_contiguous()):
        raise ValueError(f"{name}: y_grad must match v, got {y_grad.dtype} "
                         f"{tuple(y_grad.shape)}")
    if state_grad is not None and (
            state_grad.device != r.device
            or state_grad.dtype != torch.float32
            or state_grad.shape != (b, h, kd, vd)
            or not state_grad.is_contiguous()):
        raise ValueError(f"{name}: state_grad must be float32 [B, H, K, V]")
    if vd % 8:
        raise ValueError(f"{name}: V must be a multiple of 8, got {vd}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, y_grad)):
        raise ValueError(f"{name}: r, k, v, w and y_grad must start on a "
                         "16-byte boundary")
    impl = wkv6_bwd_impl(b, s, h) if impl is None else impl
    if impl not in BWD_IMPLS:
        raise ValueError(f"{name}: impl is one of {BWD_IMPLS}, got {impl}")
    if impl == "chunked":
        seg = 0
    elif seg is None:
        seg = bwd_split_steps(b, s, h)
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv, du = torch.empty_like(v), torch.empty_like(u)
    dstate = None if state is None else torch.empty_like(state)
    scratch = torch.empty(bwd_scratch_floats(b, s, h, kd, vd, seg),
                          dtype=torch.float32, device=r.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    BWD_KERNEL.launch(r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                      w.data_ptr(), u.data_ptr(), ptr(state),
                      y_grad.data_ptr(), ptr(state_grad), dr.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                      du.data_ptr(), ptr(dstate), scratch.data_ptr(), b, s, h,
                      kd, vd, _DTYPES[r.dtype], seg)
    return dr, dk, dv, dw, du, dstate


class WKV6Fn(torch.autograd.Function):
    """The WKV6 recurrence ``(y, final_state)`` with its gradient w.r.t.
    r, k, v, w, u and the initial state: on CUDA tensors the forward
    kernel (the instantiation :func:`wkv6_impl` picks) and the backward
    kernel (:func:`wkv6_bwd_impl`'s), on CPU tensors ``ref_wkv6`` and
    ``ref_wkv6_backward``.  An output the loss does not use reaches
    ``backward`` as None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        if r.device.type == "cuda":     # the saved inputs keep their grad
            y, final = wkv6_cuda(*(None if t is None else t.detach()
                                   for t in (r, k, v, w, u, state)))
        else:
            y, final = ref.ref_wkv6(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return y, final

    @staticmethod
    def backward(ctx, gy, gstate):
        if gy is None and gstate is None:
            return (None,) * 6
        r, k, v, w, u, state = ctx.saved_tensors
        gy = (torch.zeros_like(v) if gy is None
              else gy.to(r.dtype).contiguous())
        gstate = (None if gstate is None else gstate.to(
            torch.promote_types(r.dtype, torch.float32)).contiguous())
        if r.device.type == "cuda":
            return wkv6_bwd_cuda(r, k, v, w, u, state, gy, gstate)
        return ref.ref_wkv6_backward(r, k, v, w, u, state, gy, gstate)
