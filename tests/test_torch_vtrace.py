"""Port vs JAX: V-trace, GAE and advantage normalisation on the CPU.

The port's plain versions (``core.vtrace``, ``kernels.ref.ref_vtrace``
and ``kernels.ops.vtrace``'s CPU route) are held to
``repro.core.vtrace.vtrace`` and the O(T^2) oracle ``naive_vtrace`` on
the same numpy inputs.  The Pallas body (``vtrace_pallas``) is not used:
it calls ``pl.store``, which the installed JAX lacks.  The CUDA kernel
is held to the same plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: float32 within 1e-5 of max(1, |ref|) (the JAX kernel sweep's
tolerance; both sides run the same float32 recurrence in another
operation order, ``ref_vtrace_segmented`` reassociated as a scan).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gae import gae as jax_gae
from repro.core.gae import normalize_advantages as jax_normalize
from repro.core.vtrace import naive_vtrace as jax_naive_vtrace
from repro.core.vtrace import vtrace as jax_vtrace
from repro.core.vtrace import vtrace_impala_pg_advantage as jax_impala_pg
from repro_torch.core.gae import gae, normalize_advantages
from repro_torch.core.vtrace import (naive_vtrace, vtrace,
                                     vtrace_impala_pg_advantage)
from repro_torch.kernels import ops, ref

SHAPES = [(1, 5), (4, 13), (8, 64), (13, 100)]
CLIPS = [(1.0, 1.0, 1.0), (2.0, 0.5, 0.95)]
NAMES = ("log_ratios", "values", "bootstrap_value", "rewards", "discounts")


def _inputs(b, t, seed):
    """V-trace inputs with both clips biting (log-ratios of +-3 mixed in)
    and episode ends (zero discounts)."""
    rng = np.random.default_rng(seed)
    lr = 0.5 * rng.standard_normal((b, t))
    lr[rng.random((b, t)) < 0.1] = 3.0
    lr[rng.random((b, t)) < 0.1] = -3.0
    d = 0.99 * (rng.random((b, t)) > 0.1)
    arrs = (lr, rng.standard_normal((b, t)), rng.standard_normal(b),
            rng.standard_normal((b, t)), d)
    return {k: a.astype(np.float32) for k, a in zip(NAMES, arrs)}


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


@pytest.mark.parametrize("clips", CLIPS, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("b,t", SHAPES)
def test_vtrace_matches_jax(b, t, clips):
    rho_bar, c_bar, lam = clips
    x = _inputs(b, t, seed=b * t)
    kw = dict(rho_bar=rho_bar, c_bar=c_bar, lam=lam)
    want = jax_vtrace(**{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    got = vtrace(**_torch(x), **kw)
    _close(got.vs, want.vs)
    _close(got.advantages, want.advantages)
    _close(got.clipped_rhos, want.clipped_rhos)
    # The kernels' plain version and the CPU route of the dispatch.
    args = [torch.from_numpy(x[k]) for k in NAMES]
    for vs, adv in (ref.ref_vtrace(*args, **kw), ops.vtrace(*args, **kw)):
        _close(vs, want.vs)
        _close(adv, want.advantages)
    assert (np.asarray(want.clipped_rhos) < np.exp(x["log_ratios"])).any()


@pytest.mark.parametrize("clips", CLIPS, ids=lambda c: "-".join(map(str, c)))
def test_vtrace_matches_the_quadratic_oracle(clips):
    rho_bar, c_bar, lam = clips
    x = _inputs(4, 13, seed=1)
    kw = dict(rho_bar=rho_bar, c_bar=c_bar, lam=lam)
    want = jax_naive_vtrace(**{k: jnp.asarray(v) for k, v in x.items()},
                            **kw)
    for got in (naive_vtrace(**_torch(x), **kw), vtrace(**_torch(x), **kw)):
        _close(got.vs, want.vs)
        _close(got.advantages, want.advantages)


@pytest.mark.parametrize("clips", CLIPS, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("seg", [1, 7, 32])
@pytest.mark.parametrize("b,t", [(3, 1), (4, 13), (2, 225), (2, 1100)])
def test_ref_vtrace_segmented_matches_jax(b, t, seg, clips):
    """The card's time-parallel algebra (tiles of 32 x seg steps, a
    lane's segment composed as an affine map, a scan over the lanes, the
    segments re-run) against the JAX recurrence, ragged tiles included."""
    rho_bar, c_bar, lam = clips
    x = _inputs(b, t, seed=b + t + seg)
    kw = dict(rho_bar=rho_bar, c_bar=c_bar, lam=lam)
    want = jax_vtrace(**{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    vs, adv = ref.ref_vtrace_segmented(
        *[torch.from_numpy(x[k]) for k in NAMES], **kw, seg=seg)
    _close(vs, want.vs)
    _close(adv, want.advantages)


def test_ref_vtrace_segmented_at_all_dones_and_no_dones():
    """Zero discounts everywhere (every map constant) and none (the maps
    chain through every tile edge)."""
    for disc in (0.0, 0.99):
        x = _inputs(3, 300, seed=8)
        x["discounts"] = np.full_like(x["discounts"], disc)
        want = jax_vtrace(**{k: jnp.asarray(v) for k, v in x.items()})
        vs, adv = ref.ref_vtrace_segmented(
            *[torch.from_numpy(x[k]) for k in NAMES], seg=3)
        _close(vs, want.vs)
        _close(adv, want.advantages)


def test_impala_pg_advantage_matches_jax():
    x = _inputs(4, 13, seed=2)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    want = jax_impala_pg(jax_vtrace(**jx), rewards=jx["rewards"],
                         discounts=jx["discounts"], values=jx["values"],
                         bootstrap_value=jx["bootstrap_value"],
                         log_ratios=jx["log_ratios"], rho_bar_pg=1.5)
    tx = _torch(x)
    got = vtrace_impala_pg_advantage(
        vtrace(**tx), rewards=tx["rewards"], discounts=tx["discounts"],
        values=tx["values"], bootstrap_value=tx["bootstrap_value"],
        log_ratios=tx["log_ratios"], rho_bar_pg=1.5)
    _close(got, want)


@pytest.mark.parametrize("lam", [0.95, 1.0])
def test_gae_and_normalize_match_jax(lam):
    x = _inputs(8, 64, seed=3)
    keys = ("values", "bootstrap_value", "rewards", "discounts")
    want = jax_gae(**{k: jnp.asarray(x[k]) for k in keys}, lam=lam)
    got = gae(**{k: torch.from_numpy(x[k]) for k in keys}, lam=lam)
    _close(got.advantages, want.advantages)
    _close(got.returns, want.returns)
    _close(normalize_advantages(got.advantages),
           jax_normalize(want.advantages))


def test_on_policy_vtrace_reduces_to_gae():
    """With on-policy data and unclipped traces, V-trace's advantages are
    GAE's at lambda = lam (the identity the JAX tests check)."""
    x = _torch(_inputs(4, 13, seed=4))
    out = vtrace(log_ratios=torch.zeros_like(x["values"]),
                 values=x["values"], bootstrap_value=x["bootstrap_value"],
                 rewards=x["rewards"], discounts=x["discounts"],
                 rho_bar=float("inf"), c_bar=float("inf"), lam=0.9)
    want = gae(values=x["values"], bootstrap_value=x["bootstrap_value"],
               rewards=x["rewards"], discounts=x["discounts"], lam=0.9)
    torch.testing.assert_close(out.vs, want.returns, rtol=1e-5, atol=1e-5)


def test_ops_vtrace_takes_bfloat16_in_float32():
    """bfloat16 inputs give float32 outputs, computed in float32 from the
    rounded inputs (as the kernel computes them)."""
    args = [torch.from_numpy(v).bfloat16()
            for v in _inputs(4, 13, seed=5).values()]
    vs, adv = ops.vtrace(*args, rho_bar=2.0, c_bar=0.5, lam=0.95)
    want = vtrace(**dict(zip(NAMES, (a.float() for a in args))),
                  rho_bar=2.0, c_bar=0.5, lam=0.95)
    assert vs.dtype == adv.dtype == torch.float32
    torch.testing.assert_close(vs, want.vs, rtol=0, atol=0)
    torch.testing.assert_close(adv, want.advantages, rtol=0, atol=0)


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    """The CUDA wrapper checks its inputs before it loads anything, so
    these refusals hold on a host without a card."""
    from repro_torch.kernels.vtrace import vtrace_cuda

    args = [torch.from_numpy(v) for v in _inputs(2, 3, seed=6).values()]
    with pytest.raises(ValueError, match="CUDA device"):
        vtrace_cuda(*args)
