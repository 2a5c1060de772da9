"""Device dispatch over the kernels (port of ``repro.kernels.ops``).

The JAX signatures are kept, minus ``mode`` and ``mesh``: the kernel is
chosen by the tensor's device.  A CPU tensor takes the plain PyTorch
version (``kernels.ref``); a CUDA tensor takes the hand-written CUDA
kernel, or the call raises.  Nothing routes a CUDA tensor to the plain
path.

``paged_kv_write`` updates the pools in place (JAX returns new, donated
pools) and returns the same tensors, so callers may keep either form.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.logprobs import LogprobsFn
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.paged_attention_varlen import \
    paged_attention_varlen_cuda
from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda
from repro_torch.kernels.ssm_scan import bc_row_stride, ssm_scan_cuda
from repro_torch.kernels.vtrace import vtrace_cuda
from repro_torch.kernels.wkv6 import wkv6_cuda


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"kernels run on cpu or cuda, not {t.device}")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` itself when it is contiguous and of ``dtype``, else a
    contiguous copy in ``dtype``."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def paged_attention(
    q, k_pages, v_pages, block_tables, context_lens,
    *, window: Optional[int] = None,
):
    """Decode attention over a block-table paged KV pool ([B, H, D])."""
    if _route(q) == "cpu":
        return ref.ref_paged_attention(
            q, k_pages, v_pages, block_tables, context_lens, window=window)
    return paged_attention_cuda(
        q.contiguous(), k_pages, v_pages, _i32(block_tables),
        _i32(context_lens), window=window)


def paged_attention_varlen(
    q, k_pages, v_pages, block_tables, row_start, row_len,
    *, window: Optional[int] = None,
):
    """Ragged multi-token attention over the paged pool ([B, T, H, D]):
    query ``t < row_len[b]`` sits at ``row_start[b] + t`` and attends
    causally; padding rows and ``row_len == 0`` slots are exact zeros."""
    if _route(q) == "cpu":
        return ref.ref_paged_attention_varlen(
            q, k_pages, v_pages, block_tables, row_start, row_len,
            window=window)
    return paged_attention_varlen_cuda(
        q.contiguous(), k_pages, v_pages, _i32(block_tables),
        _i32(row_start), _i32(row_len), window=window)


def paged_attention_multi(
    q, k_pages, v_pages, block_tables, context_lens,
    *, window: Optional[int] = None,
):
    """Fixed-``T`` verify shape ([B, T, H, D]): query ``t`` sits at
    ``context_lens - T + t``; a wrapper over the varlen kernel, as in
    the JAX package."""
    row_start, row_len = ref.multi_rows(context_lens, q.shape[1])
    return paged_attention_varlen(
        q, k_pages, v_pages, block_tables, row_start, row_len,
        window=window)


def paged_kv_write(
    k_pages, v_pages, k_rows, v_rows, page_idx, offset, active,
    *, layer: int,
):
    """Scatter K/V rows ``[N, KV, D]`` (one decode step's ``[B, KV, D]``,
    or a varlen round's ``B * T`` rows) into layer ``layer`` of the
    pools, in place; inactive rows write nothing.  Returns the pools."""
    if not k_pages.is_cuda:
        _route(k_pages)
        return ref.ref_paged_kv_write(
            k_pages, v_pages, k_rows, v_rows, page_idx, offset, active,
            layer=layer)
    # Called once per layer: tensors already in the kernel's types (the
    # model's are) go through as they are, with no conversion launch.
    dtype = k_pages.dtype
    return paged_kv_write_cuda(
        k_pages, v_pages, _as(k_rows, dtype), _as(v_rows, dtype),
        _as(page_idx, torch.int32), _as(offset, torch.int32),
        _as(active, torch.bool if active.dtype == torch.bool
            else torch.int32), layer=layer)


def logprobs_from_logits(logits, targets):
    """``(logp, entropy)``, each of ``targets``' shape, float32, from
    ``logits`` ``[..., V]``; differentiable w.r.t. the logits.  A CUDA
    tensor goes through the fused kernel and its backward kernel (the
    logits are made contiguous first: a strided slice is copied); a CPU
    tensor through the plain versions."""
    _route(logits)
    lead = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1])
    tgt = targets.reshape(-1)
    if logits.device.type == "cuda":
        flat, tgt = flat.contiguous(), _i32(tgt)
    logp, ent = LogprobsFn.apply(flat, tgt)
    return logp.reshape(lead), ent.reshape(lead)


def vtrace(
    log_ratios, values, bootstrap_value, rewards, discounts,
    *, rho_bar: float = 1.0, c_bar: float = 1.0, lam: float = 1.0,
):
    """``(vs, advantages)`` ``[B, T]`` float32 (paper Eqs. 14-15).  No
    gradient: callers pass constants (the kernel raises on inputs that
    require grad).  On the card, inputs of mixed dtypes are cast to
    float32 and every input is made contiguous."""
    args = (log_ratios, values, bootstrap_value, rewards, discounts)
    if _route(values) == "cpu":
        return ref.ref_vtrace(*args, rho_bar=rho_bar, c_bar=c_bar, lam=lam)
    if len({t.dtype for t in args}) > 1:
        args = tuple(t.float() for t in args)
    return vtrace_cuda(*(t.contiguous() for t in args), rho_bar=rho_bar,
                       c_bar=c_bar, lam=lam)


def wkv6(r, k, v, w, u, state=None):
    """The RWKV-6 recurrence over ``[B, S, H, K]`` heads: ``(y [B, S, H,
    V]`` in ``r``'s dtype, ``final_state [B, H, K, V]`` float32)``;
    ``state=None`` starts from zeros.  No gradient on the card (the
    kernel raises on inputs that require grad).  On the card every input
    is made contiguous."""
    if _route(r) == "cpu":
        return ref.ref_wkv6(r, k, v, w, u, state)
    return wkv6_cuda(*(t.contiguous() for t in (r, k, v, w, u)),
                     None if state is None else state.contiguous())


def attention(q, k, v, *, window: Optional[int] = None,
              causal: bool = True):
    """Attention of every position of ``q`` [B, S, H, D] over the same
    sequence of ``k``, ``v`` [B, S, KV, D] (causal, within ``window``
    when given): ``[B, S, H, D]`` in q's dtype.  On the card the kernel
    is causal only (``causal=False`` raises: no path of the port asks
    for it) and has no gradient (inputs that require grad raise); every
    input is made contiguous."""
    if _route(q) == "cpu":
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    if not causal:
        raise ValueError("flash_attention: the kernel is causal only")
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), window=window)


def ssm_scan(u, dt, b_t, c_t, a, h0=None):
    """The selective scan over ``[B, S, I]`` channels with an ``[I, N]``
    diagonal ``a``: ``(y [B, S, I]`` in u's dtype, ``h_final [B, I, N]``
    float32)``; ``h0=None`` starts from zeros.  No gradient on the card
    (the kernel raises on inputs that require grad).  On the card ``u``,
    ``dt``, ``a`` and ``h0`` are made contiguous, ``a`` and ``h0``
    float32; ``b_t`` and ``c_t`` are read in place when they are column
    slices of one contiguous tensor (the model's), else made contiguous."""
    if _route(u) == "cpu":
        return ref.ref_ssm_scan(u, dt, b_t, c_t, a, h0)
    b_t, c_t = (t if bc_row_stride(t) is not None else t.contiguous()
                for t in (b_t, c_t))
    return ssm_scan_cuda(
        u.contiguous(), dt.contiguous(), b_t, c_t, a.float().contiguous(),
        None if h0 is None else h0.float().contiguous())
