"""The head-dim-256 kernels of the port (gemma3-12b's width) against
their plain PyTorch versions, on the card: flash's forward in both dtypes
with its logsumexp (float32 ``flash_kernel_d256``, bfloat16
``flash_kernel_wgmma256``), the paged decode split over the context
(B 1 and B 4, global and past a window of 1024, contexts of one split and
of many, ``ctx`` 0, the same bits on a second call) and the varlen
kernel at 16 / 8 heads of 256.  Marked ``cuda``;
each test skips on a host without one (no JAX import, so the card's
machine collects it).  Run on a GPU machine with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_d256.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(rng, b, h, kv, bs, lens):
    """Pools of distinct shuffled pages for contexts ``lens``, a query
    ``[B, H, 256]`` and the block tables."""
    d = 256
    m = max(-(-n // bs) for n in lens)
    nb = b * m + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, m), np.int32)
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        tables[i, :pages] = perm[i * m:i * m + pages]
    kp, vp = (rng.standard_normal((kv, nb, bs, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,window", [
    (8, 32, 16, 8, None), (8, 32, 16, 8, 16), (2, 37, 16, 8, None),
    (2, 1, 16, 8, None), (1, 2048, 16, 8, 1024), (2, 65, 4, 1, 16),
    (2, 300, 16, 8, 100), (2, 300, 4, 1, 64), (2, 300, 4, 1, None)])
def test_flash_attention_kernel_at_head_dim_256_matches_plain(
        dev, dtype, tol, b, s, h, kv, window):
    """Flash's forward at head dim 256 (float32 ``flash_kernel_d256``,
    bfloat16 ``flash_kernel_wgmma256``), with its logsumexp, at G 2 and
    G 4: the output within ``tol`` (bfloat16 of max(1, |plain|)), the
    logsumexp within 1e-5; one launch."""
    gen = torch.Generator(device="cuda").manual_seed(s + h)
    q, k, v = (torch.randn(b, s, n, 256, generator=gen, device=dev).to(dtype)
               for n in (h, kv, kv))
    kernels.reset_launch_counts()
    out, lse = flash_mod.flash_attention_cuda(q, k, v, window=window,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    want, want_lse = ref.ref_attention_lse(q, k, v, window=window)
    diff = (out.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    assert diff.max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 1024])
def test_paged_kernels_at_head_dim_256_match_plain(dev, dtype, tol, window):
    """The decode and varlen kernels at gemma3's 16 / 8 heads of 256,
    contexts past the window, against their plain versions; one launch
    each."""
    rng = np.random.default_rng(11)
    lens = [45, 1100, 2050, 0]
    q, kp, vp, tables = _paged_inputs(rng, 4, 16, 8, 8,
                                      [max(n, 1) for n in lens])
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    q, kp, vp = (on(a).to(dtype) for a in (q, kp, vp))
    tables, ctx = on(tables), on(np.asarray(lens, np.int32))
    kernels.reset_launch_counts()
    got = ops.paged_attention(q, kp, vp, tables, ctx, window=window)
    want = ref.ref_paged_attention(q, kp, vp, tables, ctx, window=window)
    start = torch.clamp(ctx - 16, min=0).to(torch.int32)
    rows = torch.minimum(ctx, torch.full_like(ctx, 16))
    q16 = on(rng.standard_normal((4, 16, 16, 256)).astype(np.float32)).to(
        dtype)
    got_v = ops.paged_attention_varlen(q16, kp, vp, tables, start, rows,
                                       window=window)
    want_v = ref.ref_paged_attention_varlen(q16, kp, vp, tables, start,
                                            rows, window=window)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["paged_attention"] == counts["paged_attention_varlen"] == 1
    for g, w in ((got, want), (got_v, want_v)):
        diff = (g.float() - w.float()).abs()
        if dtype == torch.bfloat16:
            diff = diff / w.float().abs().clamp(min=1.0)
        assert diff.max().item() <= tol


def _paged_split_case(dev, dtype, lens, window, h=16, kv=8, m=None, seed=0):
    """The decode kernel and its plain version on pools sized for
    ``lens`` (tables ``m`` pages wide, 8 rows a page); returns (kernel
    output, plain output, the split count the wrapper planned)."""
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     split_geometry)

    rng = np.random.default_rng(seed)
    q, kp, vp, tables = _paged_inputs(rng, len(lens), h, kv, 8,
                                      [max(n, 1) for n in lens])
    if m is not None:
        tables = np.pad(tables, ((0, 0), (0, m - tables.shape[1])))
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    q, kp, vp = (on(a).to(dtype) for a in (q, kp, vp))
    tables, ctx = on(tables), on(np.asarray(lens, np.int32))
    splits = split_geometry(
        len(lens), h, kv, tables.shape[1], 8, window,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    got = paged_attention_cuda(q, kp, vp, tables, ctx, window=window)
    want = ref.ref_paged_attention(q, kp, vp, tables, ctx, window=window)
    return got, want, splits, lambda: paged_attention_cuda(
        q, kp, vp, tables, ctx, window=window)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("lens,window,m,many", [
    ([2064], None, None, True), ([2064], 1024, None, True),
    ([1100, 1500, 2050, 1025], 1024, None, True),
    ([1100, 1500, 2050, 0], None, None, True),
    ([45, 17, 64, 33], None, 260, True),     # wide tables: most splits empty
    ([45, 17, 40, 0], None, None, False),    # one split: no partials
    ([0], 1024, 300, True), ([1, 2080, 49], 1024, 260, True)])
def test_split_paged_decode_at_head_dim_256_matches_plain(
        dev, dtype, tol, lens, window, m, many):
    """The split decode at gemma3's 16 / 8 heads of 256 against the plain
    version within ``tol`` (bfloat16 of max(1, |plain|)); one launch; an
    idle slot exactly zero; a second call gives the same bits (the splits
    merge in a fixed order and the tickets are left at zero)."""
    kernels.reset_launch_counts()
    got, want, splits, again = _paged_split_case(dev, dtype, lens, window,
                                                 m=m)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention"] == 1
    assert (splits > 1) == many
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        diff = diff / want.float().abs().clamp(min=1.0)
    assert diff.max().item() <= tol
    for i, n in enumerate(lens):
        if n == 0:
            assert bool((got[i] == 0).all())
    for _ in range(3):
        assert torch.equal(again(), got)


@pytest.mark.parametrize("h,kv", [(4, 4), (14, 2), (32, 2)])
def test_split_paged_decode_takes_any_group(dev, h, kv):
    """Groups of 1, 7 and 16 (two row tiles of 8) at head dim 256, past a
    window, float32 within 2e-5."""
    got, want, splits, _ = _paged_split_case(
        dev, torch.float32, [1500, 700, 0], 1024, h=h, kv=kv, seed=h)
    torch.cuda.synchronize()
    assert splits > 1
    assert (got - want).abs().max().item() <= 2e-5
