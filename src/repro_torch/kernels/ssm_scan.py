"""Wrappers of the CUDA selective-scan kernels (``csrc/ssm_scan.cu`` and
``csrc/ssm_scan_bwd.cu``) and their autograd function.

The forward replaces the Pallas kernel
``repro.kernels.ssm_scan_pallas.ssm_scan_pallas``; the backward replaces
the gradient that ``jax.grad`` takes through ``repro.models.ssm._ssm_scan``
(the Pallas kernel is forward-only).  The plain versions are
``kernels.ref.ref_ssm_scan`` and ``ref_ssm_scan_backward``.
``SSMScanFn`` runs the kernels on CUDA tensors and the plain versions on
CPU tensors, so the CPU tests drive the same forward/backward wiring the
card runs.  The backward recomputes the states from the inputs, so a
forward that will be differentiated saves nothing more than its inputs
and costs what a no-grad forward costs.

Two instantiations (:func:`ssm_impl` picks one and names it): ``serial``,
a thread per channel walking every step, for short sequences (a decode
step, hymba's S 32 prefill, any batch that already fills the card);
``chunked``, the time-parallel scan of 32- or 64-step chunks (three
kernels: chunk end states, the carry across chunks, the output from
each chunk's true start), for long sequences of a small batch (hymba's
B 1 x S 2048 forward).
``b_t`` and ``c_t`` may be column slices of one wider tensor (the
model's ``x_proj`` output), read in place.
"""
from __future__ import annotations

import ctypes
from ctypes import c_int, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, check, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16
# The serial kernel runs a block per 128 channels of a batch row, each
# walking all S steps; the chunked scan splits S but runs every
# exponential twice and three kernels.  The chunked scan is taken from
# 128 steps on while the serial grid fills at most a quarter of the SMs,
# and from 512 while it is under 1.5 times their number; the serial
# kernel otherwise.  Measured with chip_smoke.py phase 16's ssm_crossover
# records (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): at hymba's I 3200
# that is B 1 from S 128, B 2 to 7 from S 512.
SM_COUNT = 132
CHUNKED_MIN_STEPS = (128, 512)
# Steps per chunk: 64, or 32 where 64 would leave fewer than about three
# blocks per SM (at most 64: the kernel stages 64 rows of b_t and c_t).
CHUNK_STEPS = (32, 64)

# u, dt, b_t, c_t, a, h0, y, h_final, scratch | B S I N ld_b ld_c chunk
# dtype | stream
KERNEL = Kernel("ssm_scan", [c_void_p] * 9 + [c_int] * 8 + [c_void_p])
# u, dt, b_t, c_t, a, h0, dy, dhf, du, ddt, db, dc, da, dh0, scratch | B S
# I N ld_b ld_c dtype | stream
BWD_KERNEL = Kernel("ssm_scan_bwd", [c_void_p] * 15 + [c_int] * 7
                    + [c_void_p])
# Steps a chunk of the backward walks (csrc/ssm_scan_bwd.cu: kChunk); the
# CPU's plain backward walks chunks of the same length.
BWD_CHUNK = ref.SSM_BWD_CHUNK


def ssm_impl(batch: int, steps: int, inner: int) -> str:
    """The instantiation a call of these sizes takes: ``"chunked"`` for
    long sequences whose serial grid would leave SMs empty, ``"serial"``
    otherwise."""
    serial_blocks = -(-inner // 128) * batch
    short, wide = CHUNKED_MIN_STEPS
    if (steps >= short and 4 * serial_blocks <= SM_COUNT) or (
            steps >= wide and 2 * serial_blocks < 3 * SM_COUNT):
        return "chunked"
    return "serial"


def chunk_steps(batch: int, steps: int, inner: int) -> int:
    """Steps per chunk of the chunked instantiation at these sizes."""
    short, long = CHUNK_STEPS
    blocks = -(-inner // 128) * batch * -(-steps // long)
    return long if blocks >= 3 * SM_COUNT else short


def bc_row_stride(t: torch.Tensor) -> Optional[int]:
    """Row stride ``ld`` of a ``[B, S, N]`` operand the kernel can read
    in place, element ``(b, s, n)`` at ``(b * S + s) * ld + n`` with
    ``ld >= N`` (a contiguous tensor, or a column slice of a contiguous
    ``[B, S, R]`` one); None for any other layout."""
    if t.dim() != 3:
        return None
    bsz, s, n = t.shape
    ld = t.stride(1) if s > 1 else t.stride(0) if bsz > 1 else n
    if ld < n or (n > 1 and t.stride(2) != 1) or (
            bsz > 1 and t.stride(0) != s * ld):
        return None
    return ld


def ssm_scan_cuda(
    u: torch.Tensor,                    # [B, S, I]
    dt: torch.Tensor,                   # [B, S, I]
    b_t: torch.Tensor,                  # [B, S, N], rows evenly spaced
    c_t: torch.Tensor,                  # [B, S, N], rows evenly spaced
    a: torch.Tensor,                    # [I, N] float32
    h0: Optional[torch.Tensor] = None,  # [B, I, N] float32
    *,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, I]`` in u's dtype, ``h_final [B, I, N]`` float32)``
    from u, dt, b_t, c_t of one dtype (float32 or bfloat16) and a float32
    ``a`` (and ``h0``) on one CUDA device; ``h0=None`` starts from zeros.
    u, dt, a and h0 are contiguous; b_t and c_t contiguous or column
    slices of a contiguous ``[B, S, R]`` tensor.  N is at most 16.
    ``impl`` forces an instantiation (``"serial"`` or ``"chunked"``);
    None takes :func:`ssm_impl`'s."""
    name = KERNEL.name
    ld_b, ld_c = _check(name, u, dt, b_t, c_t, a, h0)
    bsz, s, inner = u.shape
    n = a.shape[-1]
    impl = ssm_impl(bsz, s, inner) if impl is None else impl
    if impl not in ("serial", "chunked"):
        raise ValueError(f"{name}: impl is 'serial' or 'chunked', got {impl}")
    chunk = chunk_steps(bsz, s, inner) if impl == "chunked" else 0
    carried = -(-s // chunk) - 1 if chunk else 0
    scratch = torch.empty(bsz * carried * inner * (n + 1),
                          dtype=torch.float32, device=u.device) \
        if carried else None
    y = torch.empty_like(u)
    h_final = torch.empty((bsz, inner, n), dtype=torch.float32,
                          device=u.device)
    KERNEL.launch(u.device, u.data_ptr(), dt.data_ptr(), b_t.data_ptr(),
                  c_t.data_ptr(), a.data_ptr(),
                  None if h0 is None else h0.data_ptr(), y.data_ptr(),
                  h_final.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), bsz, s,
                  inner, n, ld_b, ld_c, chunk, _DTYPES[u.dtype])
    return y, h_final


def _check(name, u, dt, b_t, c_t, a, h0) -> Tuple[int, int]:
    """Device, layout, dtype and shape checks shared by both kernels;
    returns b_t's and c_t's row strides."""
    tensors = (u, dt, b_t, c_t, a) + (() if h0 is None else (h0,))
    if any(t.device.type != "cuda" or t.device != u.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    ld_b, ld_c = bc_row_stride(b_t), bc_row_stride(c_t)
    if any(not t.is_contiguous() for t in (u, dt, a)) or (
            h0 is not None and not h0.is_contiguous()) or None in (ld_b,
                                                                 ld_c):
        raise ValueError(f"{name}: tensors must be contiguous (b_t and c_t "
                         "may be column slices with evenly spaced rows)")
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
    return ld_b, ld_c


def bwd_scratch_floats(batch: int, steps: int, inner: int, n: int) -> int:
    """float32 scratch of the backward kernel, as the C side sizes it
    (``csrc/ssm_scan_bwd.cu``: ``ssm_scan_bwd_scratch_floats``): the
    per-tile partials of db and dc, the per-row partial of da, and the
    chunk-start states when the sequence has more chunks than shared
    memory keeps."""
    fn = load(BWD_KERNEL.name).ssm_scan_bwd_scratch_floats
    fn.argtypes = [c_int] * 4
    fn.restype = ctypes.c_longlong
    floats = fn(batch, steps, inner, n)
    if floats < 0:
        raise ValueError(f"{BWD_KERNEL.name}: bad sizes B {batch} S {steps} "
                         f"I {inner} N {n}")
    return floats


def ssm_bwd_info(dtype: torch.dtype, steps: int) -> dict:
    """What the backward's main kernel takes at ``steps`` steps on the
    current card: registers and spilled (local) bytes a thread, blocks
    resident on an SM, dynamic shared bytes a block, and whether the
    chunk starts stay on chip (``csrc/ssm_scan_bwd.cu``:
    ``ssm_scan_bwd_info``)."""
    fn = load(BWD_KERNEL.name).ssm_scan_bwd_info
    fn.argtypes = [c_int, c_int, ctypes.POINTER(c_int)]
    fn.restype = c_int
    out = (c_int * 5)()
    check(fn(_DTYPES[dtype], steps, out), "ssm_scan_bwd_info")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                smem_bytes=out[3], starts_on_chip=bool(out[4]))


def ssm_scan_bwd_cuda(
    u: torch.Tensor, dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor,
    a: torch.Tensor, h0: Optional[torch.Tensor], y_grad: torch.Tensor,
    h_final_grad: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """``(du, ddt, db, dc, da, dh0)`` of :func:`ssm_scan_cuda` at the
    gradients ``y_grad`` [B, S, I] (u's dtype, contiguous) and
    ``h_final_grad`` [B, I, N] float32 (None: zeros).  The inputs as the
    forward takes them (b_t and c_t may be column slices); du, ddt, db,
    dc contiguous in u's dtype, da [I, N] float32, and dh0 [B, I, N]
    float32 (None when ``h0`` is None)."""
    name = BWD_KERNEL.name
    ld_b, ld_c = _check(name, u, dt, b_t, c_t, a, h0)
    bsz, s, inner = u.shape
    n = a.shape[-1]
    if (y_grad.device != u.device or y_grad.dtype != u.dtype
            or y_grad.shape != u.shape or not y_grad.is_contiguous()):
        raise ValueError(f"{name}: y_grad must match u, got {y_grad.dtype} "
                         f"{tuple(y_grad.shape)}")
    if h_final_grad is not None and (
            h_final_grad.device != u.device
            or h_final_grad.dtype != torch.float32
            or h_final_grad.shape != (bsz, inner, n)
            or not h_final_grad.is_contiguous()):
        raise ValueError(f"{name}: h_final_grad must be float32 [B, I, N]")
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    db, dc = (torch.empty((bsz, s, n), dtype=u.dtype, device=u.device)
              for _ in range(2))
    da = torch.empty((inner, n), dtype=torch.float32, device=u.device)
    dh0 = None if h0 is None else torch.empty_like(h0)
    scratch = torch.empty(bwd_scratch_floats(bsz, s, inner, n),
                          dtype=torch.float32, device=u.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    BWD_KERNEL.launch(u.device, u.data_ptr(), dt.data_ptr(), b_t.data_ptr(),
                      c_t.data_ptr(), a.data_ptr(), ptr(h0),
                      y_grad.data_ptr(), ptr(h_final_grad), du.data_ptr(),
                      ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
                      da.data_ptr(), ptr(dh0), scratch.data_ptr(), bsz, s,
                      inner, n, ld_b, ld_c, _DTYPES[u.dtype])
    return du, ddt, db, dc, da, dh0


class SSMScanFn(torch.autograd.Function):
    """The selective scan ``(y, h_final)`` with its gradient w.r.t. u,
    dt, b_t, c_t, a and h0: on CUDA tensors the forward kernel (the
    instantiation :func:`ssm_impl` picks) and the backward kernel, on CPU
    tensors ``ref_ssm_scan`` and ``ref_ssm_scan_backward``.  An output
    the loss does not use reaches ``backward`` as None."""

    @staticmethod
    def forward(ctx, u, dt, b_t, c_t, a, h0):
        ctx.set_materialize_grads(False)
        if u.device.type == "cuda":
            y, h_final = ssm_scan_cuda(u, dt, b_t, c_t, a, h0)
        else:
            y, h_final = ref.ref_ssm_scan(u, dt, b_t, c_t, a, h0)
        ctx.save_for_backward(u, dt, b_t, c_t, a, h0)
        return y, h_final

    @staticmethod
    def backward(ctx, gy, ghf):
        if gy is None and ghf is None:
            return (None,) * 6
        u, dt, b_t, c_t, a, h0 = ctx.saved_tensors
        gy = (torch.zeros_like(u) if gy is None
              else gy.to(u.dtype).contiguous())
        ghf = None if ghf is None else ghf.float().contiguous()
        if u.device.type == "cuda":
            return ssm_scan_bwd_cuda(u, dt, b_t, c_t, a, h0, gy, ghf)
        grads = ref.ref_ssm_scan_backward(u, dt, b_t, c_t, a, h0, gy, ghf,
                                          chunk=BWD_CHUNK)
        return grads[:5] + ((None if h0 is None else grads[5]),)
