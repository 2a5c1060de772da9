"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``
and ``csrc/flash_attention_bwd.cu``) and their autograd function.

The forward replaces the Pallas kernel
``repro.kernels.flash_attention_pallas.flash_attention``; the backward
replaces the gradient that ``jax.grad`` takes through the einsum
attention ``repro.models.attention._sdpa`` (the Pallas kernel is
forward-only).  The plain versions are ``kernels.ref.ref_attention``,
``ref_attention_lse`` and ``ref_attention_backward``.

``FlashAttentionFn`` runs the forward with its per-row logsumexp and the
backward kernel on CUDA tensors, and the plain versions on CPU tensors,
so the CPU tests drive the same forward/backward wiring the card runs.

Five instantiations of the forward, chosen by the C launcher from
dtype and head dim alone, with or without the logsumexp
(:func:`flash_impl` names the one a call takes; :data:`FLASH_SYMBOLS`
the kernel each shows in a profile): float32 at D 64 and 128 takes
``tf32``, both products on the tensor cores in 3xTF32 (float32 accuracy;
``flash_kernel_tf32``); bfloat16 at D 64 and 128 takes ``wgmma``, tensor
cores fed by TMA (``flash_kernel_wgmma``); at D 256 (gemma3) float32
takes ``d256``, the ``tf32`` products with each 16-row tile split over
two warps by output dims (``flash_kernel_d256``), and bfloat16
``wgmma256``, the ``wgmma`` design with Q read from shared memory
(``flash_kernel_wgmma256``); D 8, 16 and 32 take ``fma``, float32 FMA
from shared memory (``flash_kernel``).
Every one writes the logsumexp when asked.  A failure to build or launch
raises: nothing routes a CUDA tensor to another instantiation or to the
plain version.  The backward has no D-128 or D-256 path: a gradient at
those head dims raises ``ValueError`` on the card before anything
launches.

The backward runs its products on the tensor cores (3xTF32 for float32,
bfloat16 ``mma`` for bfloat16) on one of two paths, picked by the
shared memory a block holding all of a kv head's rows needs, which the
C side decides and reports as the scratch it takes
(:func:`flash_bwd_scratch_floats`): ``short``, no scratch, one launch
with a block per (kv head, b) (every learner shape), or ``long``, a
block per 32-key tile with dQ summed by atomics (long sequences).
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the forward
_BWD_HEAD_DIMS = (8, 16, 32, 64)      # the backward: no D-128 / 256 path yet
_TC_HEAD_DIMS = (64, 128)             # the tf32 / wgmma instantiations
_WGMMA_MAX_GROUP = 64   # query heads per kv head: one 64-row wgmma tile
# The kernel each instantiation shows in a profile (a substring of its
# demangled name).
FLASH_SYMBOLS = {"tf32": "flash_kernel_tf32<", "wgmma": "flash_kernel_wgmma<",
                 "d256": "flash_kernel_d256<",
                 "wgmma256": "flash_kernel_wgmma256<", "fma": "flash_kernel<"}

# q, k, v, out, lse | B S H KV D window dtype | scale | stream
KERNEL = Kernel("flash_attention",
                [c_void_p] * 5 + [c_int] * 7 + [c_float, c_void_p])
# q, k, v, out, dout, lse, scratch, dq, dk, dv | B S H KV D window dtype |
# scale | stream
BWD_KERNEL = Kernel("flash_attention_bwd",
                    [c_void_p] * 10 + [c_int] * 7 + [c_float, c_void_p])


def flash_impl(dtype: torch.dtype, head_dim: int, lse: bool = False) -> str:
    """The instantiation the launcher takes for these inputs, by dtype
    and head dim alone (``lse``, whether the logsumexp is asked for, does
    not change it): ``"tf32"`` for float32 at head dim 64 or 128,
    ``"wgmma"`` for bfloat16 there, ``"d256"`` for float32 and
    ``"wgmma256"`` for bfloat16 at 256, ``"fma"`` at 8, 16 and 32."""
    if head_dim == 256:
        return "d256" if dtype == torch.float32 else "wgmma256"
    if head_dim in _TC_HEAD_DIMS:
        return "tf32" if dtype == torch.float32 else "wgmma"
    return "fma"


def flash_bwd_scratch_floats(dtype: torch.dtype, batch: int, seq: int,
                             n_heads: int, n_kv: int, head_dim: int) -> int:
    """The float32 scratch the backward takes at these sizes, as the C
    side decides it (``csrc/flash_attention_bwd.cu``:
    ``flash_attention_bwd_scratch_floats``): 0 for the short path, while
    one block holds the kv head's G S rows in shared memory, else the
    long path's dQ sums and each row's Dr."""
    fn = load(BWD_KERNEL.name).flash_attention_bwd_scratch_floats
    fn.argtypes = [c_int] * 6
    fn.restype = c_longlong
    floats = fn(batch, seq, n_heads, n_kv, head_dim, _DTYPES[dtype])
    if floats < 0:
        raise ValueError(f"{BWD_KERNEL.name}: no path for B {batch} S {seq} "
                         f"H {n_heads} KV {n_kv} D {head_dim}")
    return floats


def flash_bwd_path(dtype: torch.dtype, seq: int, n_heads: int, n_kv: int,
                   head_dim: int) -> str:
    """The backward's path at these sizes: ``"short"`` when it takes no
    scratch, else ``"long"``."""
    return "long" if flash_bwd_scratch_floats(dtype, 1, seq, n_heads, n_kv,
                                              head_dim) else "short"


def flash_bwd_impl(dtype: torch.dtype, seq: int, n_heads: int, n_kv: int,
                   head_dim: int) -> str:
    """The backward's path and its products, e.g. ``"short/3xtf32"``
    (float32) or ``"long/bf16_mma"`` (bfloat16)."""
    mma = "3xtf32" if dtype == torch.float32 else "bf16_mma"
    return f"{flash_bwd_path(dtype, seq, n_heads, n_kv, head_dim)}/{mma}"


def _check_bwd_head_dim(head_dim: int) -> None:
    """Refuse a head dim the backward kernel has no path for (128 and 256
    have a forward only), before anything launches."""
    if head_dim not in _BWD_HEAD_DIMS:
        raise ValueError(f"{BWD_KERNEL.name}: head dim {head_dim} has no "
                         f"backward kernel (it takes {_BWD_HEAD_DIMS}); "
                         "the forward alone runs at head dims 128 and 256")


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], more: Tuple[torch.Tensor, ...] = ()
           ) -> None:
    """Device, layout, dtype and shape checks shared by both kernels;
    ``more`` are tensors of q's shape and dtype (out, d_out)."""
    tensors = (q, k, v) + more
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got {q.shape}")
    b, s, h, d = q.shape
    kv = k.shape[2] if k.dim() == 4 else 0
    if (k.shape != (b, s, kv, d) or v.shape != k.shape or kv < 1
            or h % kv or min(b, s) < 1 or d not in _HEAD_DIMS
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: bad shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got {window}")


def flash_attention_cuda(
    q: torch.Tensor,               # [B, S, H, D]
    k: torch.Tensor,               # [B, S, KV, D]
    v: torch.Tensor,               # [B, S, KV, D]
    *,
    window: Optional[int] = None,  # None = global
    return_lse: bool = False,
):
    """Causal attention of every position over its prefix (and within
    ``window`` of it), ``[B, S, H, D]`` in q's dtype, from inputs of one
    dtype (float32 or bfloat16), contiguous, on one CUDA device; H a
    multiple of KV and D in {8, 16, 32, 64, 128, 256}.  ``return_lse`` also
    returns each row's float32 logsumexp ``[B, S, H]`` (what the
    backward needs): ``(out, lse)``.  The instantiation is
    ``flash_impl(q.dtype, D)``; at D 64 and above q, k, v must be 16-byte
    aligned (``cp.async`` / TMA), and ``wgmma`` / ``wgmma256`` take
    H / KV <= 64."""
    name = KERNEL.name
    _check(name, q, k, v, window)
    b, s, h, d = q.shape
    kv = k.shape[2]
    impl = flash_impl(q.dtype, d)
    if impl in ("wgmma", "wgmma256") and h // kv > _WGMMA_MAX_GROUP:
        raise ValueError(f"{name}: bfloat16 at D {d} takes at most "
                         f"{_WGMMA_MAX_GROUP} query heads per kv head, "
                         f"got {h // kv}")
    if impl != "fma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the {impl} path's copies need q, k, v "
                         "16-byte aligned")
    out = torch.empty_like(q)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(),
                  b, s, h, kv, d, 0 if window is None else int(window),
                  _DTYPES[q.dtype], d ** -0.5)
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, d_out: torch.Tensor, *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_cuda` at ``d_out``, from
    the forward's inputs, output and logsumexp ``lse`` [B, S, H] float32;
    each in the inputs' dtype and shape.  The inputs as the forward takes
    them; out and d_out of q's shape and dtype, contiguous.  The path is
    :func:`flash_bwd_path`'s; the scratch, the long path's only, is what
    :func:`flash_bwd_scratch_floats` reports."""
    name = BWD_KERNEL.name
    _check_bwd_head_dim(q.shape[-1])
    _check(name, q, k, v, window, (out, d_out))
    b, s, h, d = q.shape
    kv = k.shape[2]
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, s, h) or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be float32 [B, S, H] on q's "
                         f"device, got {lse.dtype} {tuple(lse.shape)}")
    floats = flash_bwd_scratch_floats(q.dtype, b, s, h, kv, d)
    scratch = (torch.empty(floats, dtype=torch.float32, device=q.device)
               if floats else None)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    BWD_KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), b, s, h, kv, d,
                      0 if window is None else int(window),
                      _DTYPES[q.dtype], d ** -0.5)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal (windowed) GQA attention of ``q`` [B, S, H, D] over ``k``,
    ``v`` [B, S, KV, D] with its gradient: on CUDA tensors the forward
    kernel (keeping each row's logsumexp) and the backward kernel, on
    CPU tensors ``ref_attention_lse`` and ``ref_attention_backward``.
    On the card a head dim the backward has no path for (128, 256)
    raises ``ValueError`` here, before the forward launches."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.set_materialize_grads(False)
        if q.device.type == "cuda":
            _check_bwd_head_dim(q.shape[-1])
            out, lse = flash_attention_cuda(q, k, v, window=window,
                                            return_lse=True)
        else:
            out, lse = ref.ref_attention_lse(q, k, v, window=window)
        ctx.window = window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        if d_out is None:
            return None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = flash_attention_bwd_cuda(
                q, k, v, out, lse, d_out.to(q.dtype).contiguous(),
                window=ctx.window)
        else:
            grads = ref.ref_attention_backward(q, k, v, out, lse, d_out,
                                               window=ctx.window)
        return (*grads, None)
