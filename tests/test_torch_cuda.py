"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips on a host without one.  Run on
a GPU machine with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import build
from repro_torch.configs import reduced_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, b=4, t=5, h=14, kv=2, d=64, bs=8, nb=40, m=6,
          row_start=(20, 8, 0, 30), row_len=(1, 5, 0, 3), pad=None):
    """Pools, tables and ragged rows.  ``pad=None``: the last table column
    is page 0 (a real page past every context); otherwise every entry
    past a slot's context is ``pad``."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, t, h, d, generator=g).to(dtype).to(dev)
    kp = torch.randn(kv, nb, bs, d, generator=g).to(dtype).to(dev)
    vp = torch.randn(kv, nb, bs, d, generator=g).to(dtype).to(dev)
    tables = (torch.randperm(nb - 1, generator=g)[:b * m] + 1).reshape(b, m)
    if pad is None:
        tables[:, m - 1] = 0                          # pad entries
    else:
        for i, (s0, n) in enumerate(zip(row_start, row_len)):
            tables[i, -(-(s0 + n) // bs):] = pad
    row_len = torch.tensor(row_len)
    row_start = torch.tensor(row_start)
    return (q, kp, vp, tables.to(torch.int32).to(dev),
            row_start.to(torch.int32).to(dev), row_len.to(torch.int32).to(dev))


# Ragged rounds at G = 7: row tiles of 16 split a slot's T x 7 rows.
# "t16" is the serve path's chunked round (slots of 1, 16, 7 and 0 rows);
# "t32_long" has contexts of up to 232 keys (four 64-key tiles), an idle
# slot and -1 table entries past every context.  Other geometries: D 128
# with G 1 and 16-row pages; D 32 with G 20 (a token's rows span two row
# tiles) and 4-row pages.
_VARLEN = {
    "t5": dict(),
    "t16": dict(t=16, nb=129, m=32, row_start=(40, 16, 0, 9),
                row_len=(1, 16, 7, 0), pad=-1),
    "t32_long": dict(t=32, nb=129, m=32, row_start=(200, 0, 130, 150),
                     row_len=(32, 32, 0, 19), pad=-1),
    "d128_g1": dict(t=4, h=8, kv=8, d=128, bs=16, nb=33, m=8,
                    row_start=(20, 3, 0, 100), row_len=(4, 1, 0, 2), pad=-1),
    "d32_g20": dict(t=3, h=40, kv=2, d=32, bs=4, nb=65, m=16,
                    row_start=(10, 0, 40, 7), row_len=(3, 2, 1, 0), pad=-1),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 7, 100])
@pytest.mark.parametrize("shape", sorted(_VARLEN))
def test_varlen_kernel_matches_plain(dev, dtype, tol, window, shape):
    args = _case(dev, dtype, **_VARLEN[shape])
    got = ops.paged_attention_varlen(*args, window=window)
    want = ref.ref_paged_attention_varlen(*args, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    for b, n in enumerate(args[5].tolist()):
        assert (got[b, n:] == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 7])
def test_decode_kernel_matches_plain(dev, dtype, tol, window):
    q, kp, vp, tables, _, _ = _case(dev, dtype)
    lens = torch.tensor([21, 1, 0, 40], dtype=torch.int32, device=dev)
    got = ops.paged_attention(q[:, 0], kp, vp, tables, lens, window=window)
    want = ref.ref_paged_attention(q[:, 0], kp, vp, tables, lens,
                                   window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[2] == 0).all()


@pytest.mark.parametrize("varlen", [False, True])
def test_paged_wrappers_refuse_misaligned_pools_and_head_dims(dev, varlen):
    """K/V rows are staged by 16-byte cp.async: a pool off a 16-byte
    boundary and a head dim that is not a multiple of 8 raise before any
    launch."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.paged_attention_varlen import (
        paged_attention_varlen_cuda)

    def call(q, kp, vp, tables, row_start, row_len):
        if varlen:
            return paged_attention_varlen_cuda(q, kp, vp, tables, row_start,
                                               row_len)
        return paged_attention_cuda(q[:, 0].contiguous(), kp, vp, tables,
                                    row_start + row_len)

    q, kp, vp, tables, row_start, row_len = _case(dev, torch.float32)
    odd = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=dev)[1:]
    odd = odd.view(kp.shape).copy_(kp)             # contiguous, 4 bytes off
    assert odd.is_contiguous() and odd.data_ptr() % 16
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        call(q, odd, vp, tables, row_start, row_len)
    with pytest.raises(ValueError, match="16-byte"):
        call(q, kp, odd, tables, row_start, row_len)
    with pytest.raises(ValueError, match="head dim"):
        call(*_case(dev, torch.float32, d=12))
    assert sum(kernels.launch_counts().values()) == 0
    call(q, kp, vp, tables, row_start, row_len)    # the aligned pools run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_kernel_bit_exact(dev, dtype):
    g = torch.Generator().manual_seed(1)
    pools = [torch.randn(3, 2, 16, 8, 64, generator=g).to(dtype).to(dev)
             for _ in range(2)]
    rows = [torch.randn(6, 2, 64, generator=g).to(dtype).to(dev)
            for _ in range(2)]
    dest = torch.randperm(16 * 8, generator=g)[:6]
    page, off = (dest // 8).to(dev), (dest % 8).to(dev)
    active = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool, device=dev)
    want = [p.clone() for p in pools]
    ref.ref_paged_kv_write(*want, *rows, page, off, active, layer=2)
    ops.paged_kv_write(*pools, *rows, page, off, active, layer=2)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pools, want))


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_plan_serves_a_step_and_checks_each_call(dev, dtype,
                                                          mask_dtype):
    """One step's destinations and mask (bool or int32) through every
    layer: bit-exact against the plain write, untouched rows untouched,
    one launch a layer.  A call whose rows do not fit the step's plan
    raises, and so does a pool reshaped in place after the plan was
    made."""
    from repro_torch.kernels.paged_kv_write import paged_kv_write_cuda

    g = torch.Generator().manual_seed(2)
    pools = [torch.randn(4, 2, 16, 8, 64, generator=g).to(dtype).to(dev)
             for _ in range(2)]
    dest = torch.randperm(16 * 8, generator=g)[:6]
    page = (dest // 8).to(torch.int32).to(dev)
    off = (dest % 8).to(torch.int32).to(dev)
    active = torch.tensor([1, 0, 1, 1, 0, 1], device=dev).to(mask_dtype)
    want = [p.clone() for p in pools]
    kernels.reset_launch_counts()
    for layer in range(4):
        rows = [torch.randn(6, 2, 64, generator=g).to(dtype).to(dev)
                for _ in range(2)]
        ref.ref_paged_kv_write(*want, *rows, page, off, active, layer=layer)
        paged_kv_write_cuda(*pools, *rows, page, off, active, layer=layer)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_kv_write"] == 4
    assert all(torch.equal(a, b) for a, b in zip(pools, want))
    with pytest.raises(ValueError, match="bad shapes"):
        paged_kv_write_cuda(*pools, rows[0][:5], rows[1][:5], page, off,
                            active, layer=0)
    with pytest.raises(ValueError, match="bad shapes"):
        paged_kv_write_cuda(*pools, *rows, page, off, active, layer=4)
    with pytest.raises(TypeError, match="dtype"):
        paged_kv_write_cuda(*pools, rows[0].double(), rows[1], page, off,
                            active, layer=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_kv_write_cuda(*pools, rows[0].cpu(), rows[1], page, off,
                            active, layer=0)
    with pytest.raises(ValueError, match="contiguous"):
        paged_kv_write_cuda(*pools, rows[0].transpose(1, 2).contiguous()
                            .transpose(1, 2), rows[1], page, off, active,
                            layer=0)
    with pytest.raises(TypeError, match="bool or int32"):
        paged_kv_write_cuda(*pools, *rows, page, off, active.long(),
                            layer=0)
    pools[0].unsqueeze_(0)
    with pytest.raises(ValueError, match="bad shapes"):
        paged_kv_write_cuda(*pools, *rows, page, off, active, layer=0)
    assert kernels.launch_counts()["paged_kv_write"] == 4


def test_model_step_on_card_launches_kernels_and_matches_cpu(dev):
    from repro_torch.models import transformer as tf

    cfg = reduced_config("qwen2.5-0.5b")
    params = build(cfg).init(torch.Generator().manual_seed(0))
    pages = tf.init_paged_cache(cfg, 16, 4)
    tables = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    tokens = torch.randint(0, cfg.vocab_size, (4, 8),
                           generator=torch.Generator().manual_seed(2))
    args = (tables, torch.tensor([0, 3, 0, 5], dtype=torch.int32),
            torch.tensor([8, 5, 0, 2], dtype=torch.int32),
            torch.full((4,), 16, dtype=torch.int32))
    want, want_pages = tf.decode_step_paged_varlen(
        params, cfg, tokens, {k: v.clone() for k, v in pages.items()}, *args)
    kernels.reset_launch_counts()
    got, got_pages = tf.decode_step_paged_varlen(
        tf.tree_to(params, dev), cfg, tokens.to(dev),
        tf.tree_to(pages, dev), *(a.to(dev) for a in args))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["paged_kv_write"] == counts["paged_attention_varlen"] == \
        cfg.n_layers
    live = torch.arange(8)[None, :] < args[2][:, None]
    assert torch.allclose(got.logits.cpu()[live], want.logits[live],
                          rtol=1e-4, atol=1e-4)
    for k in want_pages:
        assert torch.allclose(got_pages[k].cpu(), want_pages[k], atol=1e-5)


def _logprob_case(dev, dtype, n, v, seed=0):
    g = torch.Generator().manual_seed(seed)
    logits = (4.0 * torch.randn(n, v, generator=g)).to(dtype)
    targets = torch.randint(0, v, (n,), generator=g)
    targets[0], targets[-1] = 0, v - 1               # both ends of the row
    logits[1, v // 2:] = ref.NEG_INF                 # a row padded with -1e30
    targets[1] = v // 4
    return logits.to(dev), targets.to(torch.int32).to(dev)


@pytest.mark.parametrize("dtype,tol_lp,tol_ent", [
    (torch.float32, 1e-5, 1e-4), (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("n,v", [(37, 1000), (5, 131), (64, 151936)])
def test_fused_logprob_kernel_matches_plain(dev, dtype, tol_lp, tol_ent, n,
                                            v):
    from repro_torch.kernels.logprobs import fused_logprob_cuda

    logits, targets = _logprob_case(dev, dtype, n, v)
    logp, ent, lse = fused_logprob_cuda(logits, targets)
    torch.cuda.synchronize()
    want_lp = ref.ref_logprobs_from_logits(logits, targets)
    want_ent = ref.ref_entropy_from_logits(logits)
    want_lse = torch.logsumexp(logits.float(), dim=-1)
    assert (logp - want_lp).abs().max().item() <= tol_lp
    assert (ent - want_ent).abs().max().item() <= tol_ent
    assert (lse - want_lse).abs().max().item() <= tol_lp


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("with_ent", [False, True])
@pytest.mark.parametrize("n,v", [(37, 1000), (5, 131), (64, 151936)])
def test_fused_logprob_backward_matches_autograd(dev, dtype, tol, with_ent,
                                                 n, v):
    """The backward kernel against autograd of the plain forward; the
    tolerance scales with the gradient's largest magnitude."""
    logits, targets = _logprob_case(dev, dtype, n, v, seed=1)
    g = torch.Generator().manual_seed(2)
    g_lp = torch.randn(n, generator=g).to(dev)
    g_ent = torch.randn(n, generator=g).to(dev) if with_ent else None
    x = logits.float().requires_grad_(True)
    loss = (g_lp * ref.ref_logprobs_from_logits(x, targets)).sum()
    if with_ent:
        loss = loss + (g_ent * ref.ref_entropy_from_logits(x)).sum()
    (want,) = torch.autograd.grad(loss, x)
    kernels.reset_launch_counts()
    y = logits.clone().requires_grad_(True)
    logp, ent = ops.logprobs_from_logits(y, targets)
    out = (g_lp * logp).sum() + ((g_ent * ent).sum() if with_ent else 0)
    (got,) = torch.autograd.grad(out, y)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_logprob"] == 1
    assert kernels.launch_counts()["fused_logprob_bwd"] == 1
    assert got.dtype == dtype
    scale = max(1.0, want.abs().max().item())
    assert (got.float() - want).abs().max().item() <= tol * scale


def test_logprob_wrappers_refuse_bad_inputs(dev):
    from repro_torch.kernels.logprobs import fused_logprob_cuda

    logits, targets = _logprob_case(dev, torch.float32, 4, 64)
    with pytest.raises(TypeError):
        fused_logprob_cuda(logits.half(), targets)
    with pytest.raises(TypeError):
        fused_logprob_cuda(logits, targets.long())
    with pytest.raises(ValueError):
        fused_logprob_cuda(logits[:, ::2], targets)
    with pytest.raises(ValueError):
        fused_logprob_cuda(logits, targets[:3])


def _vtrace_case(dev, dtype, b, t, seed=0):
    """V-trace inputs with both clips biting (log-ratios of +-3) and
    episode ends (zero discounts)."""
    g = torch.Generator().manual_seed(seed)
    lr = 0.5 * torch.randn(b, t, generator=g)
    lr[torch.rand(b, t, generator=g) < 0.1] = 3.0
    lr[torch.rand(b, t, generator=g) < 0.1] = -3.0
    d = 0.99 * (torch.rand(b, t, generator=g) > 0.1).float()
    args = (lr, torch.randn(b, t, generator=g), torch.randn(b, generator=g),
            torch.randn(b, t, generator=g), d)
    return tuple(a.to(dtype).to(dev) for a in args)


@pytest.mark.parametrize("clips", [(1.0, 1.0, 1.0), (2.0, 0.5, 0.95)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,t", [(1, 5), (4, 13), (8, 64), (13, 100),
                                 (33, 1), (500, 1000), (1, 1), (3, 31),
                                 (3, 33), (2, 4096)])
def test_vtrace_kernel_matches_plain(dev, dtype, tol, b, t, clips):
    from repro_torch.kernels.vtrace import vtrace_cuda

    args = _vtrace_case(dev, dtype, b, t, seed=b + t)
    kw = dict(zip(("rho_bar", "c_bar", "lam"), clips))
    kernels.reset_launch_counts()
    vs, adv = vtrace_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["vtrace"] == 1
    want_vs, want_adv = ref.ref_vtrace(*args, **kw)
    for got, want in ((vs, want_vs), (adv, want_adv)):
        assert got.dtype == torch.float32 and got.shape == (b, t)
        assert (got - want).abs().max().item() <= tol * max(
            1.0, want.abs().max().item())


@pytest.mark.parametrize("disc", [0.0, 1.0])
def test_vtrace_kernel_at_all_dones_and_no_dones(dev, disc):
    """Every step an episode end (each map constant) or none (the maps
    chain across every lane and tile edge of T 4100)."""
    from repro_torch.kernels.vtrace import vtrace_cuda

    args = _vtrace_case(dev, torch.float32, 5, 4100, seed=3)
    args = args[:4] + (torch.full_like(args[4], disc),)
    vs, adv = vtrace_cuda(*args, lam=0.95)
    want_vs, want_adv = ref.ref_vtrace(*args, lam=0.95)
    for got, want in ((vs, want_vs), (adv, want_adv)):
        assert (got - want).abs().max().item() <= 1e-5 * max(
            1.0, want.abs().max().item())


def test_vtrace_dispatch_and_refusals(dev):
    from repro_torch.kernels.vtrace import vtrace_cuda

    args = _vtrace_case(dev, torch.float32, 4, 13)
    mixed = (args[0].bfloat16(),) + args[1:]
    kernels.reset_launch_counts()
    vs, _ = ops.vtrace(*mixed)                   # cast to float32, then run
    assert kernels.launch_counts()["vtrace"] == 1
    want, _ = ref.ref_vtrace(*(a.float() for a in mixed))
    assert (vs - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    with pytest.raises(ValueError, match="no backward"):
        vtrace_cuda(args[0].clone().requires_grad_(True), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        vtrace_cuda(*(a.t() if a.dim() == 2 else a for a in args))
    with pytest.raises(TypeError):
        vtrace_cuda(*(a.half() for a in args))


def _wkv6_case(dev, dtype, b, s, h, kd, state=True, decay=None, seed=0):
    """The JAX kernel sweep's draws: r, k, v ~ N(0, 1), decays in
    (0.1, 0.9) (or all ``decay``), u ~ 0.3 N(0, 1), state ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, generator=g)
    w = torch.sigmoid(n(b, s, h, kd)) * 0.8 + 0.1
    if decay is not None:
        w = torch.full_like(w, decay)
    args = [n(b, s, h, kd), n(b, s, h, kd), n(b, s, h, kd), w, 0.3 * n(h, kd)]
    s0 = n(b, h, kd, kd).to(dev) if state else None
    return [a.to(dtype).to(dev) for a in args] + [s0]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kd,state", [
    (8, 32, 32, 64, False), (8, 1, 32, 64, True), (2, 50, 3, 64, True),
    (2, 32, 2, 16, True), (2, 50, 3, 32, True), (2, 64, 2, 64, True),
    (2, 17, 1, 8, True)])
def test_wkv6_kernel_matches_plain(dev, dtype, tol, b, s, h, kd, state):
    from repro_torch.kernels.wkv6 import wkv6_cuda

    args = _wkv6_case(dev, dtype, b, s, h, kd, state, seed=s * h + kd)
    kernels.reset_launch_counts()
    y, sf = wkv6_cuda(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wkv6"] == 1
    want_y, want_sf = ref.ref_wkv6(*args)
    assert y.dtype == dtype and sf.dtype == torch.float32
    for got, want in ((y, want_y), (sf, want_sf)):
        assert got.shape == want.shape
        assert (got.float() - want.float()).abs().max().item() <= tol * max(
            1.0, want.float().abs().max().item())


@pytest.mark.parametrize("impl", ["serial", "chunked", "split"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kd,state,decay", [
    (8, 32, 32, 64, False, None),     # the serve prefill
    (1, 2048, 32, 64, False, None),   # the long forward's layer
    (2, 63, 3, 64, True, None),       # 16-step sub-chunk edges
    (2, 64, 3, 64, True, None),
    (2, 65, 3, 64, True, None),
    (1, 129, 2, 64, True, None),
    (1, 1000, 3, 64, True, None),     # a ragged last segment
    (2, 130, 2, 64, True, "mix"),     # exact 0s, exact 1s, 1e-6
    (2, 17, 1, 8, True, None),        # K 8 padded on chip
    (2, 50, 3, 32, True, None)])
def test_wkv6_instantiations_match_plain(dev, dtype, tol, b, s, h, kd,
                                         state, decay, impl):
    """Each instantiation, forced, against ``ref_wkv6``: one launch a
    call, finite outputs."""
    from repro_torch.kernels.wkv6 import wkv6_cuda

    args = _wkv6_case(dev, torch.float32, b, s, h, kd, state, seed=s + h)
    if decay == "mix":
        g = torch.Generator().manual_seed(s)
        m = torch.rand(args[3].shape, generator=g).to(dev)
        w = args[3]
        w[m < 0.2] = 0.0
        w[(m >= 0.2) & (m < 0.4)] = 1.0
        w[(m >= 0.4) & (m < 0.5)] = 1e-6
    args = [a.to(dtype) for a in args[:5]] + args[5:]
    want_y, want_sf = ref.ref_wkv6(*args)
    kernels.reset_launch_counts()
    y, sf = wkv6_cuda(*args, impl=impl)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wkv6"] == 1
    assert y.dtype == dtype and sf.dtype == torch.float32
    for got, want in ((y, want_y), (sf, want_sf)):
        assert bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * max(1.0, want.float().abs().max().item()), err


def test_wkv6_kernel_extreme_decay_stays_finite(dev):
    from repro_torch.kernels.wkv6 import wkv6_cuda

    args = _wkv6_case(dev, torch.float32, 1, 32, 1, 64, state=False,
                      decay=1e-6)
    y, sf = wkv6_cuda(*args)
    want_y, want_sf = ref.ref_wkv6(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all() and torch.isfinite(sf).all())
    assert (y - want_y).abs().max().item() <= 1e-4
    assert (sf - want_sf).abs().max().item() <= 1e-4


def test_wkv6_dispatch_and_refusals(dev):
    from repro_torch.kernels.wkv6 import wkv6_cuda

    r, k, v, w, u, s0 = _wkv6_case(dev, torch.float32, 2, 9, 3, 64)
    kernels.reset_launch_counts()
    y, sf = ops.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     w, u, s0)                   # made contiguous, then run
    assert kernels.launch_counts()["wkv6"] == 1
    want_y, want_sf = ref.ref_wkv6(r, k, v, w, u, s0)
    assert (y - want_y).abs().max().item() <= 3e-4 * max(
        1.0, want_y.abs().max().item())
    with pytest.raises(ValueError, match="no backward"):
        wkv6_cuda(r.clone().requires_grad_(True), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_cuda(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  w.transpose(1, 2), u, None)
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv6_cuda(r, k, v, w, u, s0.cpu())
    with pytest.raises(TypeError):
        wkv6_cuda(r.half(), k.half(), v.half(), w.half(), u.half(), s0)
    with pytest.raises(ValueError, match="bad shapes"):
        wkv6_cuda(r, k, v, w, u[:2], s0)
    with pytest.raises(ValueError, match="impl"):
        wkv6_cuda(r, k, v, w, u, s0, impl="fast")
    with pytest.raises(ValueError, match="multiple of 8"):
        wkv6_cuda(r, k, v[..., :60].contiguous(), w, u, s0[..., :60]
                  .contiguous(), impl="chunked")
    kernels.reset_launch_counts()
    wkv6_cuda(r, k, v[..., :60].contiguous(), w, u,
              s0[..., :60].contiguous())          # V 60 takes the serial one
    assert kernels.launch_counts()["wkv6"] == 1


def test_rwkv_decode_step_on_card_launches_wkv6_and_matches_cpu(dev):
    from repro_torch.models import transformer as tf

    cfg = reduced_config("rwkv6-1.6b", vocab=64)
    bundle = build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (3, 7),
                           generator=torch.Generator().manual_seed(1))
    want = bundle.forward(params, tokens, return_cache=True)
    want_step, _ = bundle.decode_step(params, tokens[:, 0], want.cache)
    kernels.reset_launch_counts()
    card = tf.tree_to(params, dev)
    got = bundle.forward(card, tokens.to(dev), return_cache=True)
    got_step, _ = bundle.decode_step(card, tokens[:, 0].to(dev), got.cache)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wkv6"] == 2 * cfg.n_layers
    for g, w in ((got.logits, want.logits), (got_step.logits,
                                             want_step.logits)):
        assert torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-4)


def _flash_case(dev, dtype, b, s, h, kv, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, n, d, generator=g).to(dtype).to(dev)
            for n in (h, kv, kv)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,s,h,kv,d,window", [
    (8, 32, 25, 5, 64, 16), (8, 32, 25, 5, 64, None), (2, 100, 14, 2, 64, 7),
    (2, 64, 4, 2, 32, None), (2, 100, 4, 1, 16, None),
    (2, 128, 8, 8, 64, 32), (2, 96, 4, 2, 32, 16), (2, 65, 2, 2, 8, 7),
    (1, 300, 25, 5, 64, 100),
    # D 64 at G 1, 5 and 7 (bfloat16 takes the wgmma path): S 1, 31, 64,
    # 65 and 2048, global and windowed.
    (2, 1, 14, 2, 64, None), (2, 31, 25, 5, 64, None), (2, 31, 14, 2, 64, 8),
    (2, 64, 4, 4, 64, None), (2, 64, 25, 5, 64, 16), (2, 65, 14, 2, 64, None),
    (2, 65, 8, 8, 64, 20), (1, 2048, 25, 5, 64, None),
    (1, 2048, 14, 2, 64, 1024), (1, 2048, 4, 4, 64, 300),
    (1, 2048, 14, 2, 64, None)])
def test_flash_attention_kernel_matches_plain(dev, dtype, tol, b, s, h, kv,
                                              d, window):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _flash_case(dev, dtype, b, s, h, kv, d, seed=s + h + d)
    kernels.reset_launch_counts()
    got = flash_attention_cuda(q, k, v, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    want = ref.ref_attention(q, k, v, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,d,symbol", [
    (torch.bfloat16, 64, "flash_kernel_wgmma<"),
    (torch.float32, 64, "flash_kernel<float, 64"),
    (torch.bfloat16, 32, "flash_kernel<__nv_bfloat16, 32")])
def test_flash_attention_instantiation_follows_dtype_and_head_dim(dev, dtype,
                                                                 d, symbol):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_impl)

    q, k, v = _flash_case(dev, dtype, 2, 40, 14, 2, d)
    flash_attention_cuda(q, k, v)                    # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_cuda(q, k, v, window=9)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "flash_kernel" in e.key]
    assert len(names) == 1 and symbol in names[0], names
    assert flash_impl(dtype, d) == ("wgmma" if "wgmma" in symbol else "fma")


def test_flash_attention_dispatch_and_refusals(dev):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = _flash_case(dev, torch.float32, 2, 40, 6, 2, 64)
    kernels.reset_launch_counts()
    got = ops.attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        window=9)                # made contiguous, then run
    assert kernels.launch_counts()["flash_attention"] == 1
    want = ref.ref_attention(q, k, v, window=9)
    assert (got - want).abs().max().item() <= 2e-5
    with pytest.raises(ValueError, match="causal only"):
        ops.attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="no backward"):
        ops.attention(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                             v[..., :48].contiguous())
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_cuda(q[:, :, :5].contiguous(), k, v)
    with pytest.raises(ValueError, match="query heads per kv head"):
        flash_attention_cuda(*_flash_case(dev, torch.bfloat16, 1, 4, 65, 1,
                                          64))
    assert kernels.launch_counts()["flash_attention"] == 1


def _ssm_case(dev, dtype, b, s, i, n, state=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    args = [r(b, s, i), torch.nn.functional.softplus(r(b, s, i)), r(b, s, n),
            r(b, s, n)]
    a = -torch.exp(r(i, n)).to(dev)
    h0 = r(b, i, n).to(dev) if state else None
    return [x.to(dtype).to(dev) for x in args] + [a, h0]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,i,n,state", [
    (8, 32, 3200, 16, False), (8, 1, 3200, 16, True), (2, 16, 32, 8, True),
    (2, 33, 100, 16, True), (2, 64, 128, 16, True), (2, 7, 8, 4, True),
    (3, 50, 300, 16, False)])
def test_ssm_scan_kernel_matches_plain(dev, dtype, tol, b, s, i, n, state):
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    args = _ssm_case(dev, dtype, b, s, i, n, state, seed=s * i)
    kernels.reset_launch_counts()
    y, h = ssm_scan_cuda(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssm_scan"] == 1
    want_y, want_h = ref.ref_ssm_scan(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    for got, want in ((y, want_y), (h, want_h)):
        assert got.shape == want.shape
        assert (got.float() - want.float()).abs().max().item() <= tol * max(
            1.0, want.float().abs().max().item())


def test_ssm_scan_dispatch_and_refusals(dev):
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    u, dt, b_t, c_t, a, h0 = _ssm_case(dev, torch.float32, 2, 9, 64, 16)
    kernels.reset_launch_counts()
    y, h = ops.ssm_scan(u, dt, b_t.transpose(0, 1).contiguous().transpose(
        0, 1), c_t, a.double(), h0)          # made contiguous and float32
    assert kernels.launch_counts()["ssm_scan"] == 1
    want_y, want_h = ref.ref_ssm_scan(u, dt, b_t, c_t, a, h0)
    assert (y - want_y).abs().max().item() <= 2e-4 * max(
        1.0, want_y.abs().max().item())
    with pytest.raises(ValueError, match="no backward"):
        ops.ssm_scan(u.clone().requires_grad_(True), dt, b_t, c_t, a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_cuda(u.transpose(0, 1), dt.transpose(0, 1),
                      b_t.transpose(0, 1), c_t.transpose(0, 1), a, None)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssm_scan_cuda(u, dt, b_t, c_t, a, h0.cpu())
    with pytest.raises(TypeError):
        ssm_scan_cuda(u.half(), dt.half(), b_t.half(), c_t.half(), a, h0)
    with pytest.raises(ValueError, match="bad shapes"):
        ssm_scan_cuda(u, dt, b_t, c_t, a[:5], h0)
    big = _ssm_case(dev, torch.float32, 1, 2, 8, 17)
    with pytest.raises(ValueError, match="bad shapes"):
        ssm_scan_cuda(*big)


def _strided(t, lead=5):
    """``t`` [B, S, N] as a column slice of a wider ``[B, S, lead + N + 3]``
    tensor (rows evenly spaced, the model's ``x_proj`` layout)."""
    wide = torch.zeros(*t.shape[:2], lead + t.shape[2] + 3, dtype=t.dtype,
                       device=t.device)
    wide[..., lead:lead + t.shape[2]] = t
    return wide[..., lead:lead + t.shape[2]]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,i,n,state,dt_scale", [
    (1, 2048, 3200, 16, False, 1.0),     # the long forward's layer
    (2, 127, 300, 16, True, 1.0),        # either side of the crossover
    (2, 128, 300, 16, True, 1.0),
    (2, 130, 300, 16, True, 1.0),        # a ragged last chunk
    (2, 1000, 300, 16, True, 1.0),       # a carried state at long S
    (3, 300, 200, 8, True, 200.0),       # decays that underflow to 0
    (1, 65, 64, 4, False, 1.0),
    (1, 2085, 3200, 16, True, 1.0)])     # a ragged last 64-step chunk
@pytest.mark.parametrize("strided", [False, True])
def test_ssm_scan_both_instantiations_match_plain(dev, dtype, tol, b, s, i,
                                                  n, state, dt_scale,
                                                  strided):
    """Each instantiation, forced, and the one ``ssm_impl`` picks, against
    ``ref_ssm_scan``, with ``b_t`` / ``c_t`` contiguous or read in place as
    slices of a wider tensor: one launch a call."""
    from repro_torch.kernels.ssm_scan import ssm_impl, ssm_scan_cuda

    u, dt, b_t, c_t, a, h0 = _ssm_case(dev, dtype, b, s, i, n, state,
                                       seed=s + i)
    dt = (dt.float() * dt_scale).to(dtype)
    if strided:
        b_t, c_t = _strided(b_t), _strided(c_t)
    want_y, want_h = ref.ref_ssm_scan(u, dt, b_t, c_t, a, h0)
    for impl in ("serial", "chunked", None):
        kernels.reset_launch_counts()
        y, h = ssm_scan_cuda(u, dt, b_t, c_t, a, h0, impl=impl)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["ssm_scan"] == 1
        assert y.dtype == dtype and h.dtype == torch.float32
        for got, want in ((y, want_y), (h, want_h)):
            assert bool(torch.isfinite(got).all())
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * max(1.0, want.float().abs().max().item()), \
                (impl, ssm_impl(b, s, i), err)


def test_ssm_scan_refuses_strides_it_cannot_read(dev):
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda

    u, dt, b_t, c_t, a, h0 = _ssm_case(dev, torch.float32, 2, 9, 64, 16)
    wide = torch.zeros(2, 9, 40, device=dev)
    bad = {"columns": wide[..., ::2][..., :16],
           "uneven rows": torch.zeros(2, 10, 40, device=dev)[:, :9, :16],
           "batch-major": b_t.transpose(0, 1).contiguous().transpose(0, 1)}
    kernels.reset_launch_counts()
    for what, t in bad.items():
        with pytest.raises(ValueError, match="contiguous"):
            ssm_scan_cuda(u, dt, t, c_t, a, h0)
        with pytest.raises(ValueError, match="contiguous"):
            ssm_scan_cuda(u, dt, b_t, t, a, h0)
    with pytest.raises(ValueError, match="impl"):
        ssm_scan_cuda(u, dt, b_t, c_t, a, h0, impl="fast")
    assert kernels.launch_counts()["ssm_scan"] == 0
    ssm_scan_cuda(u, dt, _strided(b_t), _strided(c_t), a, h0)
    assert kernels.launch_counts()["ssm_scan"] == 1


def test_attn_forward_launches_flash_only_without_grad(dev):
    from repro_torch.models import attention as attn

    cfg = reduced_config("hymba-1.5b", vocab=64)
    params = build(cfg).init(torch.Generator().manual_seed(0))
    lp = {k: {kk: vv[0].to(dev) for kk, vv in v.items()}
          for k, v in params["layers"]["attn"].items()}
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(dev)
    pos = torch.arange(24, device=dev)[None].expand(2, 24)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              rope_theta=cfg.rope_theta, window=cfg.window_for_layer(0))
    kernels.reset_launch_counts()
    with torch.no_grad():
        fast, _ = attn.attn_forward(lp, x, pos, **kw)
    assert kernels.launch_counts()["flash_attention"] == 1
    grad_lp = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
               for k, v in lp.items()}
    slow, _ = attn.attn_forward(grad_lp, x, pos, **kw)
    slow.sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert grad_lp["wq"]["w"].grad is not None
    assert torch.allclose(fast, slow.detach(), rtol=1e-4, atol=1e-5)


def test_hymba_decode_step_on_card_launches_kernels_and_matches_cpu(dev):
    from repro_torch.models import transformer as tf

    cfg = reduced_config("hymba-1.5b", vocab=64)
    bundle = build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (3, 20),
                           generator=torch.Generator().manual_seed(1))
    want = bundle.forward(params, tokens, return_cache=True, cache_len=22)
    want_step, want_cache = bundle.decode_step(params, tokens[:, 0],
                                               want.cache)
    kernels.reset_launch_counts()
    card = tf.tree_to(params, dev)
    got = bundle.forward(card, tokens.to(dev), return_cache=True,
                         cache_len=22)
    got_step, got_cache = bundle.decode_step(card, tokens[:, 0].to(dev),
                                             got.cache)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["ssm_scan"] == 2 * cfg.n_layers
    for g, w in ((got.logits, want.logits), (got_step.logits,
                                             want_step.logits)):
        assert torch.allclose(g.cpu(), w, rtol=1e-4, atol=1e-4)
    for k in ("ssm", "conv", "k", "v"):
        assert torch.allclose(got_cache[k].cpu(), want_cache[k], rtol=1e-4,
                              atol=1e-4)


def test_hymba_full_width_logits_gap_is_the_models_not_flash(dev,
                                                             monkeypatch):
    """2 full-width hymba layers (both windowed, 1024), dense weights x3,
    one forward of B 1 x S 1100: the card's logits with the kernel and
    with the plain attention in its place sit equally far from the CPU,
    within chip_smoke phase 18's limit (2e-4 + 1e-4 |cpu|); the two card
    runs agree within 1e-4; and the card with the window dropped (the
    control) does not meet that limit.  Prints the readings."""
    import json

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config("hymba-1.5b").replace(n_layers=2)
    assert cfg.window_for_layer(0) == cfg.window_for_layer(1) == 1024
    bundle = build(cfg)
    params = _scale_dense(bundle.init(torch.Generator().manual_seed(0)))
    tokens = torch.randint(3, cfg.vocab_size, (1, 1100),
                           generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        cpu = bundle.forward(params, tokens).logits
        card = tf.tree_to(params, dev)
        run = lambda: bundle.forward(card, tokens.to(dev)).logits.cpu()
        kernel = run()
        monkeypatch.setattr(ops, "attention", lambda q, k, v, *, window=None:
                            ref.ref_attention(q, k, v, window=window))
        plain = run()
        monkeypatch.setattr(ops, "attention", lambda q, k, v, *, window=None:
                            ref.ref_attention(q, k, v))
        no_window = run()
    gap = lambda a, b: (a - b).abs().max().item()
    print(json.dumps({"hymba_logits_gap": {
        "kernel_vs_cpu": gap(kernel, cpu), "plain_vs_cpu": gap(plain, cpu),
        "kernel_vs_plain": gap(kernel, plain),
        "no_window_vs_cpu": gap(no_window, cpu),
        "cpu_max_abs": cpu.abs().max().item()}}))
    close = lambda a, b, atol: torch.allclose(a, b, rtol=1e-4, atol=atol)
    assert close(kernel, cpu, 2e-4) and close(plain, cpu, 2e-4)
    assert close(kernel, plain, 1e-4)
    assert not close(no_window, cpu, 2e-4)


def _scale_dense(tree, by: float = 3.0):
    """The dense weights (``"w"`` leaves) scaled by ``by``."""
    return {k: _scale_dense(v, by) if isinstance(v, dict)
            else v * by if k == "w" else v for k, v in tree.items()}
