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


def _case(dev, dtype, b=4, t=5, h=14, kv=2, d=64, bs=8, nb=40, m=6):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, t, h, d, generator=g).to(dtype).to(dev)
    kp = torch.randn(kv, nb, bs, d, generator=g).to(dtype).to(dev)
    vp = torch.randn(kv, nb, bs, d, generator=g).to(dtype).to(dev)
    tables = (torch.randperm(nb - 1, generator=g)[:b * m] + 1).reshape(b, m)
    tables[:, m - 1] = 0                              # pad entries
    row_len = torch.tensor([1, t, 0, 3])
    row_start = torch.tensor([20, 8, 0, 30])
    return (q, kp, vp, tables.to(torch.int32).to(dev),
            row_start.to(torch.int32).to(dev), row_len.to(torch.int32).to(dev))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 7])
def test_varlen_kernel_matches_plain(dev, dtype, tol, window):
    args = _case(dev, dtype)
    got = ops.paged_attention_varlen(*args, window=window)
    want = ref.ref_paged_attention_varlen(*args, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got[2] == 0).all() and (got[0, 1:] == 0).all()


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
