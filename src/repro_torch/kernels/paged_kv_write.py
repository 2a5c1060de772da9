"""Wrapper of the CUDA K/V row scatter (``csrc/paged_kv_write.cu``).

Replaces the Pallas kernel ``repro.kernels.paged_kv_write_pallas.
paged_kv_write``.  The plain version is ``kernels.ref.ref_paged_kv_write``.

The device work of a decode step's rows is ~1.4 us; the call's cost is
its host side, paid on every layer of every model pass.  So what a
step's layers share (the pools, ``page_idx``, ``offset`` and ``active``)
is checked once and kept, with the pointers and geometry the launcher
reads, in a plan: the last one is reused while those five tensors are
the same objects at the same versions (``Tensor._version`` counts every
in-place change, a reshape or resize included).  A call checks in full
what can differ from layer to layer: the rows' shape, dtype, device and
layout, and ``layer``.
"""
from __future__ import annotations

import ctypes
import weakref
from ctypes import c_int, c_void_p

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_DTYPES = {torch.int32: 0, torch.bool: 1}


class _Plan(ctypes.Structure):
    """``KvWritePlan`` of ``csrc/paged_kv_write.cu``, field for field."""

    _fields_ = ([(f, c_void_p) for f in
                 ("k_pages", "v_pages", "page_idx", "offset", "active")]
                + [(f, c_int) for f in
                   ("n_rows", "num_layers", "kv_heads", "num_blocks",
                    "block_size", "head_dim", "dtype", "mask_dtype")])


# plan | k_rows, v_rows | layer | stream
KERNEL = Kernel("paged_kv_write", [c_void_p] * 3 + [c_int, c_void_p])


class _Step:
    """One checked set of pools, destinations and mask, and its plan."""

    __slots__ = ("refs", "versions", "plan", "addr", "rows_shape", "dtype",
                 "device", "num_layers")

    def __init__(self, tensors) -> None:
        k_pages, v_pages, page_idx, offset, active = tensors
        name = KERNEL.name
        if any(t.device.type != "cuda" or t.device != k_pages.device
               for t in tensors):
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             "device")
        if any(not t.is_contiguous() for t in tensors):
            raise ValueError(f"{name}: tensors must be contiguous")
        if k_pages.dtype not in _DTYPES or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"{name}: pools must share float32 or bfloat16, "
                            f"got {k_pages.dtype}/{v_pages.dtype}")
        if page_idx.dtype != torch.int32 or offset.dtype != torch.int32 \
                or active.dtype not in _MASK_DTYPES:
            raise TypeError(f"{name}: page_idx/offset must be int32 and "
                            "active bool or int32")
        n = page_idx.shape[0] if page_idx.dim() == 1 else -1
        if k_pages.dim() != 5 or v_pages.shape != k_pages.shape or \
                any(t.shape != (n,) for t in (page_idx, offset, active)):
            raise ValueError(f"{name}: bad shapes pages "
                             f"{tuple(k_pages.shape)}, page_idx/offset/"
                             f"active {[tuple(t.shape) for t in tensors[2:]]}")
        L, kv, nb, bs, d = k_pages.shape
        self.refs = tuple(weakref.ref(t) for t in tensors)
        self.versions = tuple(t._version for t in tensors)
        self.plan = _Plan(*(t.data_ptr() for t in tensors), n, L, kv, nb,
                          bs, d, _DTYPES[k_pages.dtype],
                          _MASK_DTYPES[active.dtype])
        self.addr = ctypes.addressof(self.plan)
        self.rows_shape = (n, kv, d)
        self.dtype = k_pages.dtype
        self.device = k_pages.device
        self.num_layers = L


_last_step = None


def _step(k_pages, v_pages, page_idx, offset, active) -> _Step:
    """The checked plan of these five tensors: the last one while they
    are the same objects, unchanged, else a new one."""
    global _last_step
    st = _last_step
    if st is not None:
        r = st.refs
        if (r[0]() is k_pages and r[1]() is v_pages and r[2]() is page_idx
                and r[3]() is offset and r[4]() is active
                and (k_pages._version, v_pages._version, page_idx._version,
                     offset._version, active._version) == st.versions):
            return st
    st = _last_step = _Step((k_pages, v_pages, page_idx, offset, active))
    return st


def paged_kv_write_cuda(
    k_pages: torch.Tensor,   # [L, KV, NB, BS, D] written in place
    v_pages: torch.Tensor,
    k_rows: torch.Tensor,    # [N, KV, D] of the pool's dtype
    v_rows: torch.Tensor,
    page_idx: torch.Tensor,  # [N] int32
    offset: torch.Tensor,    # [N] int32
    active: torch.Tensor,    # [N] bool or int32 (0 = drop the row)
    *,
    layer: int,
):
    """Scatter N K/V rows into layer ``layer`` of the pools, in place;
    returns the (same) pools."""
    st = _step(k_pages, v_pages, page_idx, offset, active)
    name = KERNEL.name
    if k_rows.shape != st.rows_shape or v_rows.shape != st.rows_shape \
            or not 0 <= layer < st.num_layers:
        raise ValueError(f"{name}: bad shapes pages {tuple(k_pages.shape)} "
                         f"rows {tuple(k_rows.shape)}/{tuple(v_rows.shape)} "
                         f"layer {layer}")
    if k_rows.dtype != st.dtype or v_rows.dtype != st.dtype:
        raise TypeError(f"{name}: rows must have the pools' dtype "
                        f"{st.dtype}, got {k_rows.dtype}/{v_rows.dtype}")
    if k_rows.device != st.device or v_rows.device != st.device:
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if not (k_rows.is_contiguous() and v_rows.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    if st.rows_shape[0] == 0:
        return k_pages, v_pages
    KERNEL.launch(st.device, st.addr, k_rows.data_ptr(), v_rows.data_ptr(),
                  layer)
    return k_pages, v_pages
