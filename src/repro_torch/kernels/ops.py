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
from repro_torch.kernels.logprobs import LogprobsFn
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.paged_attention_varlen import \
    paged_attention_varlen_cuda
from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"kernels run on cpu or cuda, not {t.device}")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


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
    if _route(k_pages) == "cpu":
        return ref.ref_paged_kv_write(
            k_pages, v_pages, k_rows, v_rows, page_idx, offset, active,
            layer=layer)
    return paged_kv_write_cuda(
        k_pages, v_pages, k_rows.to(k_pages.dtype).contiguous(),
        v_rows.to(v_pages.dtype).contiguous(), _i32(page_idx), _i32(offset),
        _i32(active), layer=layer)


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
