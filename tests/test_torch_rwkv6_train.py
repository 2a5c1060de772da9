"""Port vs JAX: training rwkv6, at ``reduced_config("rwkv6-1.6b")`` (2
layers, d 128, two 64-wide WKV heads, the math tokenizer's vocab), and
the plain backwards that the card's ``wkv6_bwd`` kernel is held to.

Inputs are made with numpy and handed to both packages; the trainer test
replays the JAX key chain, so sampling is token-exact.  The kernel
itself runs only on the card (``test_torch_cuda.py``, ``chip_smoke.py``
phase 33).

Tolerances and why:
* the WKV6 backward 1e-4 of max(1, |grad|): float32 recurrences summed
  in another order than ``jax.grad`` of the ``lax.scan``;
* the model's param grads 1e-4 of the largest (two layers of float32
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
from repro.models import rwkv6 as jax_rwkv
from repro.models.registry import build as jax_build
from repro.rollout.sampler import score_tokens as jax_score_tokens
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.configs import reduced_config
from repro_torch.core.losses import GRPOConfig, grpo_token_loss
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.kernels import ops, ref
from repro_torch.kernels.wkv6 import WKV6Fn
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import score_tokens
from repro_torch.train import RLVRHyperparams, RLVRTrainer
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_train import _ReplayKeyChain

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("rwkv6-1.6b", vocab=TOK.vocab_size)
CFG = reduced_config("rwkv6-1.6b", vocab=TOK.vocab_size)
PROMPT_LEN = 16
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _wkv6_inputs(b, s, h, kd, vd, state, edges, seed):
    """r, k, v ~ N(0, 1), decays in (0, 1) (``edges``: a fifth of them
    exactly 0 and a fifth exactly 1), u ~ 0.3 N(0, 1), a N(0, 1) state
    (or None) and the cotangents of y and of the final state."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v = f(b, s, h, kd), f(b, s, h, kd), f(b, s, h, vd)
    w = (1.0 / (1.0 + np.exp(-f(b, s, h, kd)))).astype(np.float32)
    if edges:
        m = rng.random(w.shape)
        w[m < 0.2] = 0.0
        w[(m >= 0.2) & (m < 0.4)] = 1.0
    return (r, k, v, w, 0.3 * f(h, kd), f(b, h, kd, vd) if state else None,
            f(b, s, h, vd), f(b, h, kd, vd))


@pytest.mark.parametrize("state,edges,s", [
    pytest.param(state, edges, 13, id=f"{state}-{tag}")
    for state in (False, True)
    for edges, tag in ((False, "mid"), (True, "w0_w1"))] + [
    pytest.param(False, False, 37, id="False-mid-s37"),
    pytest.param(True, True, 37, id="True-w0_w1-s37")])
def test_wkv6_backward_matches_jax_grad(state, edges, s):
    """``ref_wkv6_backward`` at chunks of 1, 4 and S, the chunked form
    ``ref_wkv6_backward_chunked`` (the card kernel's algebra: sub-chunks
    that do not divide S, one segment and several), autograd of
    ``ref_wkv6`` and ``WKV6Fn`` on the CPU, against ``jax.grad`` of
    ``repro.models.rwkv6.wkv6_scan`` with cotangents on y and on the
    final state, and on y alone (``WKV6Fn``'s unused output)."""
    b, h, kd, vd = 2, 3, 8, 5
    *inputs, gy, gs = _wkv6_inputs(b, s, h, kd, vd, state, edges,
                                   seed=3 + 2 * state + edges + s - 13)

    def jloss(with_state, r, k, v, w, u, s0):
        y, final = jax_rwkv.wkv6_scan(r, k, v, w, u, s0)
        return jnp.sum(y * gy) + with_state * jnp.sum(final * gs)

    argnums = (1, 2, 3, 4, 5) + ((6,) if state else ())
    want = {c: jax.jit(jax.grad(jloss, argnums=argnums),
                       static_argnums=0)(c, *inputs) for c in (0, 1)}
    t = lambda x: None if x is None else torch.from_numpy(x)
    targs = list(map(t, (*inputs, gy, gs)))
    for chunk in (1, 4, s):
        got = ref.ref_wkv6_backward(*targs, chunk=chunk)
        assert (got[5] is None) == (not state)
        for g, w, name in zip(got, want[1], NAMES):
            assert bool(torch.isfinite(g).all()), name
            _close(g, w, 1e-4, f"chunk {chunk} {name}")
    # (sub, seg): one segment; segments of sub-chunks with a ragged end.
    forms = ((16, None), (4, 8)) if s == 13 else ((16, None), (16, 16),
                                                  (8, 24))
    for sub, seg in forms:
        got = ref.ref_wkv6_backward_chunked(*targs, sub=sub, seg=seg)
        assert (got[5] is None) == (not state)
        for g, w, name in zip(got, want[1], NAMES):
            assert bool(torch.isfinite(g).all()), name
            _close(g, w, 1e-4, f"chunked sub {sub} seg {seg} {name}")
    for via_fn in (False, True):
        for with_state in (1, 0) if via_fn else (1,):
            leaves = [None if x is None else t(x).requires_grad_(True)
                      for x in inputs]
            fn = WKV6Fn.apply if via_fn else ref.ref_wkv6
            y, final = fn(*leaves)
            loss = (y * t(gy)).sum()
            if with_state:
                loss = loss + (final * t(gs)).sum()
            loss.backward()
            for x, w, name in zip([x for x in leaves if x is not None],
                                  want[with_state], NAMES):
                _close(x.grad, w, 1e-4, f"autograd {via_fn} {name}")


def test_plain_paths_keep_float64():
    """The float64 yardstick (``chip_smoke.py --grad-conditioning``) is
    float64 throughout: on float64 inputs ``ref_wkv6``,
    ``ref_wkv6_backward`` (through ``WKV6Fn``) and the plain log-prob
    path compute in float64, so their gradients match autograd of the
    step-by-step float64 forms within 1e-10 of max(1, |grad|), where a
    float32 pass would be ~1e-6 off."""
    *inputs, gy, gs = _wkv6_inputs(2, 11, 2, 8, 8, True, True, seed=9)
    t = lambda x: torch.from_numpy(x).double()
    grads = {}
    for fn in (ref.ref_wkv6, WKV6Fn.apply):
        leaves = [t(x).requires_grad_(True) for x in inputs]
        y, final = fn(*leaves)
        assert y.dtype == final.dtype == torch.float64
        ((y * t(gy)).sum() + (final * t(gs)).sum()).backward()
        grads[fn] = [x.grad for x in leaves]
    for g, w, name in zip(grads[WKV6Fn.apply], grads[ref.ref_wkv6], NAMES):
        assert g.dtype == torch.float64, name
        _close(g, w, 1e-10, f"float64 {name}")
    rng = np.random.default_rng(10)
    logits = torch.from_numpy(3 * rng.standard_normal((6, 50)))
    targets = torch.from_numpy(rng.integers(0, 50, 6))
    x = logits.clone().requires_grad_(True)
    logp, ent = ops.logprobs_from_logits(x, targets)
    assert logp.dtype == ent.dtype == torch.float64
    (logp.sum() + 0.5 * ent.sum()).backward()
    x2 = logits.clone().requires_grad_(True)
    lsm = torch.log_softmax(x2, -1)
    (lsm.gather(1, targets[:, None]).sum()
     - 0.5 * (lsm.exp() * lsm).sum()).backward()
    _close(logp.detach(), lsm.gather(1, targets[:, None])[:, 0].detach(),
           1e-12, "float64 logp")
    _close(x.grad, x2.grad, 1e-10, "float64 logit grad")


@pytest.fixture(scope="module")
def weights():
    params = jax_build(JCFG).init(jax.random.PRNGKey(0))
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


def test_rwkv6_param_grads_match_jax(weights):
    """The GRPO+VACO loss on scored rwkv6 sequences (filter active) and
    d loss / d params through ``WKV6Fn``'s plain backward, every
    time-mix leaf the recurrence feeds."""
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

    (w_loss, _), w_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jparams)
    leaves = tree_map(lambda p: p.clone().requires_grad_(True), params)
    log_pi, _, _ = score_tokens(build(CFG), leaves, torch.from_numpy(tokens),
                                PROMPT_LEN)
    loss, aux = grpo_token_loss(
        log_pi=log_pi, log_beta=torch.from_numpy(log_beta),
        advantages=torch.from_numpy(adv), token_mask=torch.from_numpy(mask),
        cfg=GRPOConfig(use_vaco=True))
    assert abs(loss.item() - float(w_loss)) <= 1e-4
    assert aux["filter_active"].item() == 1.0
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    it = iter(grads)
    grads = tree_map(lambda p: next(it), params)
    assert grads["value_head"]["w"] is None    # no gradient from the loss
    grads["value_head"] = tree_map(torch.zeros_like, params["value_head"])
    layer = grads["layers"]["rwkv"]
    for name in ("decay_base", "bonus_u", "mu_w", "mu_r", "mu_k", "mu_v",
                 "ln_x_scale"):
        assert layer[name].abs().max() > 0, name
    for name in ("decay_a", "decay_b"):
        assert all(g.abs().max() > 0 for g in tree_leaves(layer[name])), name
    for g, w in zip(tree_leaves(to_numpy(grads)), jax.tree.leaves(w_grads)):
        _close(g, w, 1e-4, "dparams")


def _reward(text, answer):
    """A reward both packages compute alike from the decoded completion,
    so groups of a random-init policy get non-zero advantages (the exact
    match would give every completion 0, and zero advantages would hide a
    wrong backward)."""
    return float(sum(map(ord, text)) % 3 == 0)


def test_rwkv6_rlvr_trainer_matches_jax(monkeypatch):
    """The slice end to end at reduced rwkv6 with non-zero advantages: 2
    warmup steps, one VACO phase of 2 minibatches (forward lag 0 and 1),
    then eval, on the JAX trainer's weights with its noise replayed."""
    import repro.data.mathgen as jax_mathgen
    import repro_torch.rollout.async_engine as engine

    monkeypatch.setattr(jax_mathgen, "verify", _reward)
    monkeypatch.setattr(engine, "verify", _reward)
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
    assert any(0.0 < w.mean_reward < 1.0 for w in want)
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


def test_train_launcher_trains_rwkv6_on_the_cpu(capsys):
    """``train rlvr --arch rwkv6-1.6b --device cpu`` (refused until the
    wkv6 backward was ported) trains and prints the JAX launcher's
    keys."""
    from repro_torch.launch import train

    assert train.main(["rlvr", "--arch", "rwkv6-1.6b", "--device", "cpu",
                       "--warmup-steps", "1", "--n-minibatches", "2",
                       "--phases", "1"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[warmup] loss=")
    report = json.loads(out[out.index("{"):])
    assert set(report) == {"arch", "algorithm", "runtime", "n_minibatches",
                           "eval_accuracy", "final_tv", "runtime_stats",
                           "train_step_ms"}
    assert report["arch"] == "rwkv6-1.6b-reduced"
    assert report["train_step_ms"]["count"] == 2
    assert report["runtime_stats"]["policy_version"] == 3


def test_train_launcher_refuses_rwkv6_through_the_serve_engine():
    """Both packages' engines refuse attention-free archs (recurrent
    state, not KV rows); the launcher refuses ``--producer serve`` with
    that reason before building anything."""
    from repro.models.transformer import paged_arch_unsupported
    from repro_torch.launch import train

    with pytest.raises(SystemExit) as err:
        train.main(["rlvr", "--arch", "rwkv6-1.6b", "--device", "cpu",
                    "--producer", "serve"])
    assert str(err.value).endswith(
        f"rwkv6-1.6b: {paged_arch_unsupported(JCFG)}")


def test_train_launcher_defaults_to_the_card_for_rwkv6(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["rlvr", "--arch", "rwkv6-1.6b", "--warmup-steps", "0"])
