"""Port vs JAX: the fused log-prob kernel's plain versions and the
autograd function the learner differentiates through.

On the CPU ``ops.logprobs_from_logits`` runs ``LogprobsFn`` with the
plain forward and ``ref_logprobs_backward``, the same wiring the card
runs with the two CUDA kernels (whose own tests are card-only, in
``test_torch_cuda.py``).  Inputs come from numpy with a seed.

Tolerances: log-probs 1e-5 and entropies 1e-4, the JAX kernel tests'
own (float32 sums over up to 2048 logits of magnitude ~10 in another
order); bfloat16 logits 2e-2, as there; gradients 1e-5 of their largest
magnitude (the backward formula against ``jax.grad``'s chain of
log-softmax and gather in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_logprob_pallas import logprobs_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.logprobs import (fused_logprob_bwd_cuda,
                                          fused_logprob_cuda)

SWEEP = [(16, 54, 8, 32), (7, 1000, 8, 256), (64, 2048, 8, 512),
         (3, 131, 4, 64)]


def _inputs(n, vocab, seed=0):
    rng = np.random.default_rng(seed + n * vocab)
    logits = (4.0 * rng.standard_normal((n, vocab))).astype(np.float32)
    targets = rng.integers(0, vocab, n).astype(np.int32)
    targets[0], targets[-1] = 0, vocab - 1
    return logits, targets


@pytest.mark.parametrize("n,vocab,bn,bv", SWEEP)
def test_plain_forward_matches_jax_ref_and_pallas(n, vocab, bn, bv):
    logits, targets = _inputs(n, vocab)
    want_lp = np.asarray(jref.ref_logprobs_from_logits(logits, targets))
    want_ent = np.asarray(jref.ref_entropy_from_logits(logits))
    k_lp, k_ent = logprobs_pallas(jnp.asarray(logits), jnp.asarray(targets),
                                  block_n=bn, block_v=bv, interpret=True)
    lp = ref.ref_logprobs_from_logits(torch.from_numpy(logits),
                                      torch.from_numpy(targets)).numpy()
    ent = ref.ref_entropy_from_logits(torch.from_numpy(logits)).numpy()
    for want, got, tol in ((want_lp, lp, 1e-5), (np.asarray(k_lp), lp, 1e-5),
                           (want_ent, ent, 1e-4),
                           (np.asarray(k_ent), ent, 1e-4)):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_plain_forward_bf16_logits_match_jax():
    logits, targets = _inputs(32, 512)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    want, _ = logprobs_pallas(jl, jnp.asarray(targets), interpret=True)
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    got, ent = ops.logprobs_from_logits(tl, torch.from_numpy(targets))
    assert got.dtype == ent.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(
        ent.numpy(), np.asarray(jref.ref_entropy_from_logits(jl)),
        rtol=2e-2, atol=2e-2)


def _jax_grad(logits, targets, g_lp, g_ent):
    def f(x):
        out = jnp.sum(g_lp * jref.ref_logprobs_from_logits(x, targets))
        if g_ent is not None:
            out = out + jnp.sum(g_ent * jref.ref_entropy_from_logits(x))
        return out

    return np.asarray(jax.grad(f)(jnp.asarray(logits)))


@pytest.mark.parametrize("with_ent", [False, True])
@pytest.mark.parametrize("n,vocab", [(16, 54), (7, 1000), (3, 131)])
def test_plain_backward_matches_jax_grad(n, vocab, with_ent):
    logits, targets = _inputs(n, vocab, seed=1)
    rng = np.random.default_rng(2)
    g_lp = rng.standard_normal(n).astype(np.float32)
    g_ent = rng.standard_normal(n).astype(np.float32) if with_ent else None
    want = _jax_grad(logits, targets, g_lp, g_ent)
    x = torch.from_numpy(logits)
    lse = torch.logsumexp(x, dim=-1)
    ent = ref.ref_entropy_from_logits(x)
    got = ref.ref_logprobs_backward(
        x, torch.from_numpy(targets), lse, ent, torch.from_numpy(g_lp),
        None if g_ent is None else torch.from_numpy(g_ent)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("use", ["logp", "entropy", "both"])
def test_ops_autograd_matches_jax_grad(use):
    """The autograd function's backward, with each output left unused in
    turn (its gradient then arrives as None and its term is skipped)."""
    n, vocab = 12, 300
    logits, targets = _inputs(n, vocab, seed=3)
    rng = np.random.default_rng(4)
    g_lp = rng.standard_normal(n).astype(np.float32)
    g_ent = rng.standard_normal(n).astype(np.float32)
    want = _jax_grad(logits, targets,
                     g_lp if use != "entropy" else np.zeros_like(g_lp),
                     g_ent if use != "logp" else None)
    x = torch.from_numpy(logits).reshape(3, 4, vocab).requires_grad_(True)
    lp, ent = ops.logprobs_from_logits(
        x, torch.from_numpy(targets).reshape(3, 4))
    assert lp.shape == ent.shape == (3, 4)
    terms = {"logp": (torch.from_numpy(g_lp).reshape(3, 4) * lp).sum(),
             "entropy": (torch.from_numpy(g_ent).reshape(3, 4) * ent).sum()}
    out = sum(terms.values()) if use == "both" else terms[use]
    (got,) = torch.autograd.grad(out, x)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got.reshape(n, vocab).numpy() - want).max() <= 1e-5 * scale


def test_cuda_wrappers_refuse_cpu_tensors():
    logits, targets = _inputs(4, 64)
    x = torch.from_numpy(logits)
    t = torch.from_numpy(targets)
    row = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_logprob_cuda(x, t)
    with pytest.raises(ValueError, match="CUDA"):
        fused_logprob_bwd_cuda(x, t, row, row, row, None)
