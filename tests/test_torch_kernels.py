"""Port vs JAX: the plain paged-kernel versions of ``repro_torch.kernels``
against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels in
interpret mode, on the ragged sweeps of ``tests/test_kernels.py``.

Attention within 2e-5 (the JAX kernel tests' tolerance), with padding
rows and idle slots exactly zero; the K/V row write bit-exact.  Also the
device dispatch: CPU tensors take the plain path, and the CUDA wrappers
refuse CPU tensors instead of falling back."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention_pallas import (
    paged_attention as pallas_paged_attention,
    paged_attention_multi as pallas_paged_attention_multi,
    paged_attention_varlen as pallas_paged_attention_varlen,
)
from repro.kernels.paged_kv_write_pallas import \
    paged_kv_write as pallas_paged_kv_write
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.paged_attention_varlen import \
    paged_attention_varlen_cuda
from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda

torch.set_num_threads(1)

NUM_BLOCKS, MAX_BLOCKS = 24, 4


def _ragged_tables(rng, b, bs):
    """Shuffled distinct pages + ragged context lengths (pads = page 0)."""
    perm = rng.permutation(NUM_BLOCKS)
    tables = np.zeros((b, MAX_BLOCKS), np.int32)
    lens = np.zeros((b,), np.int32)
    nxt = 0
    for i in range(b):
        n_pages = min(int(rng.integers(1, MAX_BLOCKS + 1)), NUM_BLOCKS - nxt)
        tables[i, :n_pages] = perm[nxt:nxt + n_pages]
        nxt += n_pages
        lens[i] = int(rng.integers(1, n_pages * bs + 1))
    return tables, lens


def _varlen_rows(rng, lens, t):
    """Decode rows, dead slots and ragged tiles at ragged offsets."""
    b = len(lens)
    row_start = np.zeros((b,), np.int32)
    row_len = np.zeros((b,), np.int32)
    for i in range(b):
        kind = i % 3
        if kind == 0:
            row_len[i] = 1
        elif kind == 2:
            row_len[i] = int(rng.integers(1, min(t, lens[i]) + 1))
        row_start[i] = int(rng.integers(0, lens[i] - row_len[i] + 1))
    return row_start, row_len


def _pools(rng, kv, bs, d):
    shape = (kv, NUM_BLOCKS, bs, d)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize(
    "b,h,kv,d,bs,window",
    [(4, 4, 2, 16, 8, None), (3, 4, 4, 32, 4, None), (2, 8, 2, 16, 8, 5),
     (5, 2, 1, 8, 16, None), (4, 4, 2, 16, 8, 12), (4, 14, 2, 64, 8, None)],
)
def test_paged_attention_plain_matches_jax(b, h, kv, d, bs, window):
    rng = np.random.default_rng(b * 31 + h)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, vp = _pools(rng, kv, bs, d)
    tables, lens = _ragged_tables(rng, b, bs)
    lens[-1] = 0                                     # an idle slot
    got = ops.paged_attention(*_t(q, kp, vp, tables, lens),
                              window=window).numpy()
    want = jref.ref_paged_attention(*_j(q, kp, vp, tables, lens),
                                    window=window)
    pallas = pallas_paged_attention(*_j(q, kp, vp, tables, lens),
                                    window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[-1], 0.0)


@pytest.mark.parametrize(
    "b,t,h,kv,d,bs,window",
    [(4, 4, 4, 2, 16, 8, None), (3, 8, 4, 4, 32, 4, None),
     (5, 3, 2, 1, 8, 16, None), (2, 6, 8, 2, 16, 8, 5),
     (4, 5, 4, 2, 16, 8, 12), (6, 2, 2, 2, 8, 4, None),
     (4, 16, 14, 2, 64, 8, None)],
)
def test_paged_attention_varlen_plain_matches_jax(b, t, h, kv, d, bs, window):
    rng = np.random.default_rng(b * 131 + t * 7 + h)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kp, vp = _pools(rng, kv, bs, d)
    tables, lens = _ragged_tables(rng, b, bs)
    row_start, row_len = _varlen_rows(rng, lens, t)
    args = (q, kp, vp, tables, row_start, row_len)
    got = ops.paged_attention_varlen(*_t(*args), window=window).numpy()
    want = jref.ref_paged_attention_varlen(*_j(*args), window=window)
    pallas = pallas_paged_attention_varlen(*_j(*args), window=window,
                                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    for i in range(b):                    # padding rows and dead slots
        np.testing.assert_array_equal(got[i, row_len[i]:], 0.0)


def test_paged_attention_multi_plain_matches_jax():
    rng = np.random.default_rng(7)
    b, t, h, kv, d, bs = 4, 4, 4, 2, 16, 8
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kp, vp = _pools(rng, kv, bs, d)
    tables, lens = _ragged_tables(rng, b, bs)
    lens = np.maximum(lens, t)
    lens[1] = 0
    args = (q, kp, vp, tables, lens)
    got = ops.paged_attention_multi(*_t(*args)).numpy()
    want = jref.ref_paged_attention_multi(*_j(*args))
    pallas = pallas_paged_attention_multi(*_j(*args), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[1], 0.0)


def test_paged_attention_bf16_plain_matches_jax():
    rng = np.random.default_rng(11)
    b, t, h, kv, d, bs = 3, 4, 4, 2, 16, 8
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kp, vp = _pools(rng, kv, bs, d)
    tables, lens = _ragged_tables(rng, b, bs)
    row_start, row_len = _varlen_rows(rng, lens, t)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, kp, vp))
    got = ops.paged_attention_varlen(tq, tk, tv, *_t(tables, row_start,
                                                     row_len))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (x.astype(jnp.bfloat16) for x in _j(q, kp, vp))
    want = jref.ref_paged_attention_varlen(jq, jk, jv,
                                           *_j(tables, row_start, row_len))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_write_plain_bit_exact(dtype):
    """Rows land exactly; inactive rows and every other row untouched."""
    rng = np.random.default_rng(5)
    L, kv, nb, bs, d, b = 3, 2, 10, 4, 16, 5
    shape = (L, kv, nb, bs, d)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    kr = rng.standard_normal((b, kv, d)).astype(np.float32)
    vr = rng.standard_normal((b, kv, d)).astype(np.float32)
    page = rng.permutation(nb)[:b].astype(np.int32)
    off = rng.integers(0, bs, b).astype(np.int32)
    active = np.asarray([True, False, True, True, False])
    tdt = getattr(torch, dtype)
    tk, tv, tkr, tvr = (x.to(tdt) for x in _t(k0, v0, kr, vr))
    out_k, out_v = ops.paged_kv_write(tk, tv, tkr, tvr,
                                      *_t(page, off, active), layer=1)
    assert out_k is tk and out_v is tv                  # in place
    jdt = getattr(jnp, dtype)
    jk, jv, jkr, jvr = (x.astype(jdt) for x in _j(k0, v0, kr, vr))
    want = jref.ref_paged_kv_write(jk, jv, jkr, jvr, *_j(page, off, active),
                                   layer=1)
    pallas = pallas_paged_kv_write(jk, jv, jkr, jvr, *_j(page, off, active),
                                   layer=1, interpret=True)
    for got, w, p in ((tk, want[0], pallas[0]), (tv, want[1], pallas[1])):
        got = got.float().numpy()
        np.testing.assert_array_equal(got, np.asarray(w, np.float32))
        np.testing.assert_array_equal(got, np.asarray(p, np.float32))
    # Untouched: every row but the active slots' destinations.
    touched = np.zeros(shape, bool)
    for i in np.nonzero(active)[0]:
        touched[1, :, page[i], off[i]] = True
    k0_cast = torch.from_numpy(k0).to(tdt).float().numpy()
    np.testing.assert_array_equal(tk.float().numpy()[~touched],
                                  k0_cast[~touched])


def test_masked_inplace_update_matches_jax():
    rng = np.random.default_rng(2)
    arr = rng.standard_normal((3, 6, 4)).astype(np.float32)
    new = rng.standard_normal((1, 2, 4)).astype(np.float32)
    valid = rng.random((1, 2, 4)) > 0.5
    want = jref.masked_inplace_update(jnp.asarray(arr), jnp.asarray(new),
                                      (1, 3, 0), jnp.asarray(valid))
    got = ref.masked_inplace_update(torch.from_numpy(arr.copy()),
                                    torch.from_numpy(new), (1, 3, 0),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: never the plain path."""
    q = torch.zeros(2, 4, 16)
    pages = torch.zeros(2, 8, 4, 16)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, pages, pages, tables, lens)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_varlen_cuda(q[:, None], pages, pages, tables, lens,
                                    lens)
    pool = torch.zeros(1, 2, 8, 4, 16)
    rows = torch.zeros(2, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kv_write_cuda(pool, pool, rows, rows, lens, lens, lens,
                            layer=0)


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype,d,impl", [
    (torch.bfloat16, 64, "wgmma"), (torch.float32, 64, "tf32"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 8, "fma"),
    (torch.float32, 16, "fma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 128, "tf32"), (torch.float32, 32, "fma"),
    (torch.float32, 256, "d256"), (torch.bfloat16, 256, "wgmma256")])
def test_flash_instantiation_depends_on_dtype_and_head_dim_alone(dtype, d,
                                                                 impl, lse):
    """Both dtypes at D 64, 128 and 256 take a tensor-core path (float32
    ``tf32`` / ``d256``, bfloat16 ``wgmma`` / ``wgmma256``), D 8, 16 and
    32 the FMA kernel, with or without the logsumexp, whatever the other
    shapes."""
    from repro_torch.kernels.flash_attention import FLASH_SYMBOLS, flash_impl

    assert flash_impl(dtype, d, lse) == impl
    assert impl in FLASH_SYMBOLS


@pytest.mark.parametrize("mask_dtype", ["bool", "int32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_paged_kv_write_takes_a_bool_or_int32_mask_bit_exact(
        dtype, mask_dtype):
    """``ops.paged_kv_write`` with the model's bool mask and with an int32
    one writes the rows the JAX oracle and the Pallas kernel (interpret
    mode) write, exactly, over three layers of one step's destinations."""
    rng = np.random.default_rng(9)
    L, kv, nb, bs, d, b = 3, 2, 12, 4, 16, 6
    shape = (L, kv, nb, bs, d)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    rows = rng.standard_normal((L, 2, b, kv, d)).astype(np.float32)
    dest = rng.permutation(nb * bs)[:b]
    page, off = (dest // bs).astype(np.int32), (dest % bs).astype(np.int32)
    active = np.asarray([1, 0, 1, 1, 0, 1]).astype(mask_dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tk, tv = (x.to(tdt) for x in _t(k0, v0))
    tpage, toff, tact = _t(page, off, active)
    jk, jv = (x.astype(jdt) for x in _j(k0, v0))
    pk, pv = jk, jv
    for layer in range(L):
        kr, vr = rows[layer]
        ops.paged_kv_write(tk, tv, *(x.to(tdt) for x in _t(kr, vr)), tpage,
                           toff, tact, layer=layer)
        jkr, jvr = (x.astype(jdt) for x in _j(kr, vr))
        jk, jv = jref.ref_paged_kv_write(jk, jv, jkr, jvr,
                                         *_j(page, off, active), layer=layer)
        pk, pv = pallas_paged_kv_write(pk, pv, jkr, jvr,
                                       *_j(page, off, active), layer=layer,
                                       interpret=True)
    for got, w, p in ((tk, jk, pk), (tv, jv, pv)):
        got = got.float().numpy()
        np.testing.assert_array_equal(got, np.asarray(w, np.float32))
        np.testing.assert_array_equal(got, np.asarray(p, np.float32))

