"""Device dispatch over the kernels (port of ``repro.kernels.ops``).

The JAX signatures are kept, minus ``mode`` and ``mesh``: the kernel is
chosen by the tensor's device.  A CPU tensor takes the plain PyTorch
version (``kernels.ref``), which autograd differentiates (``wkv6`` and
``logprobs_from_logits`` through their autograd functions' plain
backwards); a CUDA tensor takes the hand-written CUDA kernel, or the
call raises, and where a gradient is needed (``attention``,
``ssm_scan``, ``wkv6``, ``logprobs_from_logits``) its autograd function,
whose backward is a hand-written kernel too.  Nothing routes a CUDA
tensor to the plain path.

``paged_kv_write`` updates the pools in place (JAX returns new, donated
pools) and returns the same tensors, so callers may keep either form.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_cuda)
from repro_torch.kernels.logprobs import LogprobsFn
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.paged_attention_varlen import (
    MULTI, paged_attention_varlen_cuda)
from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda
from repro_torch.kernels.ssm_scan import (SSMScanFn, bc_row_stride,
                                          ssm_scan_cuda)
from repro_torch.kernels.vtrace import vtrace_cuda
from repro_torch.kernels.wkv6 import WKV6Fn, wkv6_cuda


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"kernels run on cpu or cuda, not {t.device}")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
    *, window: Optional[int] = None, count=None,
):
    """Ragged multi-token attention over the paged pool ([B, T, H, D]):
    query ``t < row_len[b]`` sits at ``row_start[b] + t`` and attends
    causally; padding rows and ``row_len == 0`` slots are exact zeros.
    On the card ``count`` (a ``LaunchCount``, e.g. ``MULTI``), when
    given, also counts the launch."""
    if _route(q) == "cpu":
        return ref.ref_paged_attention_varlen(
            q, k_pages, v_pages, block_tables, row_start, row_len,
            window=window)
    return paged_attention_varlen_cuda(
        q.contiguous(), k_pages, v_pages, _i32(block_tables),
        _i32(row_start), _i32(row_len), window=window, count=count)


def paged_attention_multi(
    q, k_pages, v_pages, block_tables, context_lens,
    *, window: Optional[int] = None,
):
    """Fixed-``T`` verify shape ([B, T, H, D]): query ``t`` sits at
    ``context_lens - T + t``; a wrapper over the varlen kernel, as in
    the JAX package.  On the card each launch also counts in
    ``launch_counts()["paged_attention_multi"]``."""
    row_start, row_len = ref.multi_rows(context_lens, q.shape[1])
    return paged_attention_varlen(
        q, k_pages, v_pages, block_tables, row_start, row_len,
        window=window, count=MULTI)


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
    ``state=None`` starts from zeros.  Inputs that need a gradient go
    through ``WKV6Fn`` on either device (the backward is ``wkv6_bwd`` on
    the card, ``ref_wkv6_backward`` on the CPU); others take the kernel
    on the card and ``ref_wkv6`` on the CPU.  On the card every input is
    made contiguous."""
    cpu = _route(r) == "cpu"
    if not cpu:
        r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
        state = None if state is None else state.contiguous()
    if _needs_grad(r, k, v, w, u, state):
        return WKV6Fn.apply(r, k, v, w, u, state)
    if cpu:
        return ref.ref_wkv6(r, k, v, w, u, state)
    return wkv6_cuda(r, k, v, w, u, state)


def attention(q, k, v, *, window: Optional[int] = None,
              causal: bool = True, kv_valid=None):
    """Attention of every position of ``q`` [B, S, H, D] over the same
    sequence of ``k``, ``v`` [B, S, KV, D] (causal, within ``window``
    when given, over the keys the ``kv_valid`` [B, S] bool mask keeps
    when given): ``[B, S, H, D]`` in q's dtype, at any S.  On the CPU,
    causal attention above ``ref.CHUNKED_ATTN_THRESHOLD`` rows is the
    q-chunked ``ref.ref_attention_chunked`` (JAX's ``_sdpa_chunked``),
    else the einsum.  On the card the kernel streams keys, so it takes
    any S; it is causal only and masks no keys (``causal=False`` or a
    ``kv_valid`` raise: ``transformer.forward`` checks that a padding
    mask is a prefix of each row and passes none, since causal rows
    below the prefix's end see no key past it); every input is made
    contiguous, and inputs that need a gradient go through
    ``FlashAttentionFn`` (the forward keeps each row's logsumexp, the
    backward is ``flash_attention_bwd``)."""
    if _route(q) == "cpu":
        if causal and q.shape[1] > ref.CHUNKED_ATTN_THRESHOLD:
            return ref.ref_attention_chunked(q, k, v, window=window,
                                             kv_valid=kv_valid)
        return ref.ref_attention(q, k, v, causal=causal, window=window,
                                 kv_valid=kv_valid)
    if not causal:
        raise ValueError("flash_attention: the kernel is causal only")
    if kv_valid is not None:
        raise ValueError("flash_attention: the kernel masks no keys; "
                         "pass a right-padding mask through "
                         "transformer.forward")
    q, k, v = (t.contiguous() for t in (q, k, v))
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, window)
    return flash_attention_cuda(q, k, v, window=window)


def ssm_scan(u, dt, b_t, c_t, a, h0=None):
    """The selective scan over ``[B, S, I]`` channels with an ``[I, N]``
    diagonal ``a``: ``(y [B, S, I]`` in u's dtype, ``h_final [B, I, N]``
    float32)``; ``h0=None`` starts from zeros.  On the card ``u``,
    ``dt``, ``a`` and ``h0`` are made contiguous, ``a`` and ``h0``
    float32; ``b_t`` and ``c_t`` are read in place when they are column
    slices of one contiguous tensor (the model's), else made contiguous.
    Inputs that need a gradient go through ``SSMScanFn`` (the backward
    is ``ssm_scan_bwd``)."""
    if _route(u) == "cpu":
        return ref.ref_ssm_scan(u, dt, b_t, c_t, a, h0)
    b_t, c_t = (t if bc_row_stride(t) is not None else t.contiguous()
                for t in (b_t, c_t))
    args = (u.contiguous(), dt.contiguous(), b_t, c_t,
            a.float().contiguous(),
            None if h0 is None else h0.float().contiguous())
    if _needs_grad(*args):
        return SSMScanFn.apply(*args)
    return ssm_scan_cuda(*args)
