"""Port vs JAX: training hymba, at ``reduced_config("hymba-1.5b")`` (2
layers, d 256, 5 query heads over 1 kv head of 64, window 16 with every
second layer global, an SSM of state 16 over 512 channels, the math
tokenizer's vocab), and the plain backwards that the card's two backward
kernels (``ssm_scan_bwd``, ``flash_attention_bwd``) are held to.

Inputs are made with numpy and handed to both packages; the trainer test
replays the JAX key chain, so sampling is token-exact.  The kernels
themselves run only on the card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 30).

Tolerances and why:
* the SSM backward 2e-4 of the largest gradient, the JAX scan test's
  (float32 recurrences summed in another order);
* the attention backward 1e-5 (float32 einsums in another order);
* ``attn_forward`` above 2048 tokens, output and grads, 1e-5 of the
  largest (JAX's chunked attention against the port's, both
  checkpointed per chunk);
* the model's param grads 1e-5 of the largest (two layers of float32
  matmuls through the backward);
* the trainer after 2 warmup steps and 2 learner steps: losses and TV
  1e-4, params 1e-4, as ``test_torch_train.py``'s trainer test.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.losses import GRPOConfig as JGRPOConfig
from repro.core.losses import grpo_token_loss as jax_grpo_token_loss
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.models import attention as jax_attn
from repro.models import ssm as jax_ssm
from repro.models.registry import build as jax_build
from repro.rollout.sampler import score_tokens as jax_score_tokens
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.configs import reduced_config
from repro_torch.core.losses import GRPOConfig, grpo_token_loss
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.ssm_scan import SSMScanFn
from repro_torch.models import attention as attn
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import score_tokens
from repro_torch.train import RLVRHyperparams, RLVRTrainer
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_train import _ReplayKeyChain

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("hymba-1.5b", vocab=TOK.vocab_size)
CFG = reduced_config("hymba-1.5b", vocab=TOK.vocab_size)
PROMPT_LEN = 32


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _ssm_inputs(b, s, i, n, state, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    u, b_t, c_t = f(b, s, i), f(b, s, n), f(b, s, n)
    dt = np.log1p(np.exp(f(b, s, i))).astype(np.float32)      # softplus
    a = -np.exp(f(i, n))
    h0 = f(b, i, n) if state else None
    return u, dt, b_t, c_t, a, h0, f(b, s, i), f(b, i, n)


@pytest.mark.parametrize("state", [False, True])
def test_ssm_backward_matches_jax_grad(state):
    """``ref_ssm_scan_backward`` at chunks of 1, 4 and S, autograd of
    ``ref_ssm_scan`` and ``SSMScanFn`` on the CPU, against ``jax.grad``
    of ``repro.models.ssm._ssm_scan`` with cotangents on y and on the
    final state."""
    u, dt, b_t, c_t, a, h0, gy, ghf = _ssm_inputs(2, 13, 6, 4, state,
                                                  seed=7 + state)

    def jloss(u, dt, b_t, c_t, a, h0):
        y, final = jax_ssm._ssm_scan(u, dt, b_t, c_t, a, h0)
        return jnp.sum(y * gy) + jnp.sum(final * ghf)

    argnums = (0, 1, 2, 3, 4, 5) if state else (0, 1, 2, 3, 4)
    want = jax.jit(jax.grad(jloss, argnums=argnums))(u, dt, b_t, c_t, a,
                                                     h0)
    t = lambda x: None if x is None else torch.from_numpy(x)
    names = ("du", "ddt", "db", "dc", "da", "dh0")
    for chunk in (1, 4, 13):
        got = ref.ref_ssm_scan_backward(
            *map(t, (u, dt, b_t, c_t, a, h0, gy, ghf)), chunk=chunk)
        for g, w, name in zip(got, want, names):
            _close(g, w, 2e-4, f"chunk {chunk} {name}")
    for via_fn in (False, True):
        leaves = [None if x is None else t(x).requires_grad_(True)
                  for x in (u, dt, b_t, c_t, a, h0)]
        fn = SSMScanFn.apply if via_fn else ref.ref_ssm_scan
        y, final = fn(*leaves)
        ((y * t(gy)).sum() + (final * t(ghf)).sum()).backward()
        for x, w, name in zip(leaves, want, names):
            _close(x.grad, w, 2e-4, f"autograd {via_fn} {name}")


def _attn_inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(b, s, h, d), f(b, s, kv, d), f(b, s, kv, d), f(b, s, h, d)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("h,kv", [(5, 1), (4, 2)])
@pytest.mark.parametrize("s", [1, 17])
def test_attention_backward_matches_jax_grad(s, h, kv, window):
    """``ref_attention_backward`` (from ``ref_attention_lse``'s output and
    logsumexp) and ``FlashAttentionFn`` on the CPU, against ``jax.grad``
    of JAX's masked attention."""
    q, k, v, d_out = _attn_inputs(2, s, h, kv, 8, seed=s * h + kv)
    pos = jnp.broadcast_to(jnp.arange(s), (2, s))
    mask = jax_attn.make_attention_mask(
        pos, pos, window=jnp.inf if window is None else window)

    def jloss(q, k, v):
        out = jax_attn._sdpa(q, k, v, mask).reshape(d_out.shape)
        return jnp.sum(out * d_out)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, d_out))
    out, lse = ref.ref_attention_lse(tq, tk, tv, window=window)
    got = ref.ref_attention_backward(tq, tk, tv, out, lse, tdo,
                                     window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out_fn = FlashAttentionFn.apply(*leaves, window)
    assert torch.equal(out_fn.detach(), out)
    (out_fn * tdo).sum().backward()
    for x, w in zip(leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-5)


def test_attn_forward_above_2048_tokens_matches_jax_chunked():
    """At S 2100 JAX's ``attn_forward`` takes ``_sdpa_chunked``; the
    port's takes ``ref_attention_chunked`` on the CPU (the card takes
    the kernel at any length): output and grads w.r.t. the weights and
    the input, hymba's window."""
    s, d_model, heads, kv, hd, window = 2100, 32, 4, 2, 8, 1024
    jp = jax_attn.attn_init(jax.random.PRNGKey(3), d_model, heads, kv, hd)
    x = np.random.default_rng(5).standard_normal(
        (1, s, d_model)).astype(np.float32)
    cot = np.random.default_rng(6).standard_normal(
        (1, s, d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]

    def jloss(p, x):
        out, _ = jax_attn.attn_forward(
            p, x, pos, n_heads=heads, n_kv_heads=kv, head_dim=hd,
            rope_theta=1e4, window=window)
        return jnp.sum(out * cot), out

    (_, w_out), (w_gp, w_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, x)
    p = tree_map(lambda t: t.requires_grad_(True),
                 from_jax_params(jax.tree.map(np.asarray, jp)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = attn.attn_forward(p, tx, torch.from_numpy(pos), n_heads=heads,
                               n_kv_heads=kv, rope_theta=1e4, window=window)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), w_out, 1e-5, "out")
    _close(tx.grad, w_gx, 1e-5, "dx")
    for g, w in zip(tree_leaves(tree_map(lambda t: t.grad, p)),
                    jax.tree.leaves(w_gp)):
        _close(g, w, 1e-5, "dparams")


@pytest.fixture(scope="module")
def weights():
    params = jax_build(JCFG).init(jax.random.PRNGKey(0))
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


def test_hymba_param_grads_match_jax(weights):
    """The GRPO+VACO loss on scored hymba sequences (filter active) and
    d loss / d params, attention and SSM branches both."""
    jparams, params = weights
    ds = MathTaskDataset(prompt_len=PROMPT_LEN, level=0, seed=2)
    prompts, _, _ = ds.sample_batch(4)
    rng = np.random.default_rng(3)
    tokens = np.concatenate([prompts, rng.integers(
        3, TOK.vocab_size, (4, 8)).astype(np.int32)], axis=1)
    lp0, _, _ = jax_score_tokens(jax_build(JCFG), jparams,
                                 jnp.asarray(tokens), PROMPT_LEN)
    log_beta = (np.asarray(lp0) + 0.3 * rng.standard_normal(lp0.shape)
                ).astype(np.float32)
    mask = (rng.random(lp0.shape) > 0.2).astype(np.float32)
    adv = rng.standard_normal(4).astype(np.float32)

    def jloss(p):
        log_pi, _, _ = jax_score_tokens(jax_build(JCFG), p,
                                        jnp.asarray(tokens), PROMPT_LEN)
        return jax_grpo_token_loss(
            log_pi=log_pi, log_beta=jnp.asarray(log_beta),
            advantages=jnp.asarray(adv), token_mask=jnp.asarray(mask),
            cfg=JGRPOConfig(use_vaco=True))

    (w_loss, w_aux), w_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jparams)
    leaves = tree_map(lambda p: p.clone().requires_grad_(True), params)
    log_pi, _, _ = score_tokens(build(CFG), leaves, torch.from_numpy(tokens),
                                PROMPT_LEN)
    loss, aux = grpo_token_loss(
        log_pi=log_pi, log_beta=torch.from_numpy(log_beta),
        advantages=torch.from_numpy(adv), token_mask=torch.from_numpy(mask),
        cfg=GRPOConfig(use_vaco=True))
    assert abs(loss.item() - float(w_loss)) <= 1e-5
    assert aux["filter_active"].item() == 1.0
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    it = iter(grads)
    grads = tree_map(lambda p: next(it), params)
    assert grads["value_head"]["w"] is None    # no gradient from the loss
    grads["value_head"] = tree_map(torch.zeros_like, params["value_head"])
    ssm_grads = tree_leaves(grads["layers"]["ssm"])
    assert all(g is not None and g.abs().max() > 0 for g in ssm_grads)
    for g, w in zip(tree_leaves(to_numpy(grads)), jax.tree.leaves(w_grads)):
        _close(g, w, 1e-5, "dparams")


def test_hymba_rlvr_trainer_matches_jax(tmp_path):
    """The slice end to end at reduced hymba: 2 warmup steps, one VACO
    phase of 2 minibatches (forward lag 0 and 1), then eval, on the JAX
    trainer's weights with its noise replayed; the trained params saved
    by the port load in ``repro.checkpoint`` bit for bit."""
    from repro.checkpoint import load_checkpoint as jax_load
    from repro_torch.checkpoint import save_checkpoint

    kw = dict(algorithm="grpo_vaco", n_minibatches=2, warmup_steps=2)
    jtr = JaxRLVRTrainer(jax_build(JCFG),
                         JaxMathTaskDataset(prompt_len=32, level=0),
                         JHyperparams(**kw), seed=0)
    tr = RLVRTrainer(build(CFG), MathTaskDataset(prompt_len=32, level=0),
                     RLVRHyperparams(**kw), seed=0, device="cpu",
                     params=from_jax_params(
                         jax.tree.map(np.asarray, jtr.state.params)))
    tr.generator._noise = _ReplayKeyChain(1, tr.hp.max_new_tokens)
    assert abs(tr.warmup() - jtr.warmup()) <= 1e-4
    want, got = jtr.train_phase(), tr.train_phase()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.mean_reward == w.mean_reward
        assert g.staleness == w.staleness
        assert g.filter_active == w.filter_active
        assert abs(g.tv - w.tv) <= 1e-4
        assert abs(g.frac_filtered - w.frac_filtered) <= 1e-4
    for g, w in zip(tree_leaves(to_numpy(tr.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jtr.state.params))):
        assert np.abs(g - w).max() <= 1e-4
    assert tr.evaluate(64) == jtr.evaluate(64)
    assert tr.store.version == jtr.store.version == 3
    assert tr.queue.stats().as_dict() == jtr.queue.stats().as_dict()
    path = save_checkpoint(str(tmp_path), 1, tr.state.params,
                           meta={"arch": CFG.name})
    tree, step, meta = jax_load(path, jtr.state.params)
    assert (step, meta) == (1, {"arch": CFG.name})
    for g, w in zip(tree_leaves(to_numpy(tr.state.params)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_train_launcher_trains_hymba_on_the_cpu(capsys):
    """``train rlvr --arch hymba-1.5b --device cpu`` (refused until the
    SSM and attention backwards were ported) trains and prints the JAX
    launcher's keys."""
    from repro_torch.launch import train

    assert train.main(["rlvr", "--arch", "hymba-1.5b", "--device", "cpu",
                       "--warmup-steps", "1", "--n-minibatches", "2",
                       "--phases", "1"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[warmup] loss=")
    report = json.loads(out[out.index("{"):])
    assert set(report) == {"arch", "algorithm", "runtime", "n_minibatches",
                           "eval_accuracy", "final_tv", "runtime_stats",
                           "train_step_ms"}
    assert report["arch"] == "hymba-1.5b-reduced"
    assert report["train_step_ms"]["count"] == 2
    assert report["runtime_stats"]["policy_version"] == 3


def test_train_launcher_refuses_hymba_through_the_serve_engine():
    """Both packages' engines refuse hybrid archs (unpaged SSM and conv
    state); the launcher refuses ``--producer serve`` with that reason
    before building anything."""
    from repro.models.transformer import paged_arch_unsupported
    from repro_torch.launch import train

    with pytest.raises(SystemExit) as err:
        train.main(["rlvr", "--arch", "hymba-1.5b", "--device", "cpu",
                    "--producer", "serve"])
    assert paged_arch_unsupported(JCFG) in str(err.value)


def test_train_launcher_defaults_to_the_card_for_hymba(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["rlvr", "--arch", "hymba-1.5b", "--warmup-steps", "0"])
