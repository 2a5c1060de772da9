"""Wrappers of the CUDA fused log-prob kernels (``csrc/fused_logprob.cu``
and ``csrc/fused_logprob_bwd.cu``) and their autograd function.

The forward replaces the Pallas kernel ``repro.kernels.
fused_logprob_pallas.logprobs_pallas``; the backward replaces the
gradient that ``jax.grad`` takes through the plain versions.  The plain
versions are ``kernels.ref.ref_logprobs_from_logits``,
``ref_entropy_from_logits`` and ``ref_logprobs_backward``.

``LogprobsFn`` runs the kernels on a CUDA tensor and the plain versions
on a CPU tensor, so the CPU tests drive the same forward/backward wiring
the card runs.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# logits, targets, logp, ent, lse | N V dtype | stream
FWD_KERNEL = Kernel("fused_logprob", [c_void_p] * 5 + [c_int] * 3 + [c_void_p])
# logits, targets, lse, ent, g_lp, g_ent, dlogits | N V has_lp has_ent
# dtype | stream
BWD_KERNEL = Kernel("fused_logprob_bwd",
                    [c_void_p] * 7 + [c_int] * 5 + [c_void_p])


def _check(name: str, logits: torch.Tensor, targets: torch.Tensor,
           rows: Tuple[torch.Tensor, ...] = ()) -> None:
    tensors = (logits, targets) + rows
    if any(t.device.type != "cuda" or t.device != logits.device
           for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{name}: logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if targets.dtype != torch.int32:
        raise TypeError(f"{name}: targets must be int32, got {targets.dtype}")
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{name}: per-row tensors must be float32")
    n = logits.shape[0] if logits.dim() == 2 else -1
    if logits.dim() != 2 or n == 0 or logits.shape[1] == 0 or \
            any(t.shape != (n,) for t in (targets,) + rows):
        raise ValueError(f"{name}: bad shapes logits {tuple(logits.shape)} "
                         f"targets {tuple(targets.shape)}")


def fused_logprob_cuda(logits: torch.Tensor, targets: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(logp, ent, lse)``, each ``[N]`` float32, of ``logits`` [N, V]
    at ``targets`` [N] int32."""
    _check(FWD_KERNEL.name, logits, targets)
    n, v = logits.shape
    logp, ent, lse = (torch.empty(n, dtype=torch.float32,
                                  device=logits.device) for _ in range(3))
    FWD_KERNEL.launch(logits.device, logits.data_ptr(), targets.data_ptr(),
                      logp.data_ptr(), ent.data_ptr(), lse.data_ptr(), n, v,
                      _DTYPES[logits.dtype])
    return logp, ent, lse


def fused_logprob_bwd_cuda(logits: torch.Tensor, targets: torch.Tensor,
                           lse: torch.Tensor, ent: torch.Tensor,
                           g_lp: Optional[torch.Tensor],
                           g_ent: Optional[torch.Tensor]) -> torch.Tensor:
    """``d(sum g_lp * logp + g_ent * ent) / d logits`` ([N, V], the
    logits' dtype); an absent gradient is skipped, not read as zeros."""
    rows = tuple(t for t in (lse, ent, g_lp, g_ent) if t is not None)
    _check(BWD_KERNEL.name, logits, targets, rows)
    n, v = logits.shape
    out = torch.empty_like(logits)
    BWD_KERNEL.launch(logits.device, logits.data_ptr(), targets.data_ptr(),
                      lse.data_ptr(), ent.data_ptr(),
                      None if g_lp is None else g_lp.data_ptr(),
                      None if g_ent is None else g_ent.data_ptr(),
                      out.data_ptr(), n, v, int(g_lp is not None),
                      int(g_ent is not None), _DTYPES[logits.dtype])
    return out


class LogprobsFn(torch.autograd.Function):
    """``(logp, ent)`` of ``logits`` [N, V] at ``targets`` [N], with the
    gradient w.r.t. the logits.  An output the loss does not use reaches
    ``backward`` as None (grads are not materialised), and its term is
    skipped."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.set_materialize_grads(False)
        if logits.device.type == "cuda":
            logp, ent, lse = fused_logprob_cuda(logits, targets)
        else:
            logp = ref.ref_logprobs_from_logits(logits, targets)
            ent = ref.ref_entropy_from_logits(logits)
            lse = torch.logsumexp(logits.to(torch.promote_types(
                logits.dtype, torch.float32)), dim=-1)
        ctx.save_for_backward(logits, targets, lse, ent)
        return logp, ent

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        if g_lp is None and g_ent is None:
            return None, None
        logits, targets, lse, ent = ctx.saved_tensors
        acc = torch.promote_types(logits.dtype, torch.float32)
        g_lp = None if g_lp is None else g_lp.to(acc).contiguous()
        g_ent = None if g_ent is None else g_ent.to(acc).contiguous()
        if logits.device.type == "cuda":
            return fused_logprob_bwd_cuda(logits, targets, lse, ent, g_lp,
                                          g_ent), None
        return ref.ref_logprobs_backward(logits, targets, lse, ent, g_lp,
                                         g_ent), None
