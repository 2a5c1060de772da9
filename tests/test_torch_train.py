"""Port vs JAX: the RLVR learner path at ``reduced_config("qwen2.5-0.5b")``
(2 layers, d 256, the math tokenizer's vocab) on the same weights.

Weights cross over through ``utils.bridge.from_jax_params``; inputs and
Gumbel noise are made with numpy or replayed from the JAX key chain (the
JAX PRNG stream cannot be drawn in torch), so sampling is token-exact.

Tolerances and why:
* model outputs (logits, values, log-probs) 1e-5, entropies 1e-4: float32
  matmuls and reductions in another order, as in the kernel tests;
* gradients 1e-5 of their largest magnitude (the same, through the
  backward);
* AdamW over 3 steps 1e-6: elementwise float32 arithmetic only;
* the trainer after 2 warmup steps and 2 learner steps: losses and TV
  1e-4, params 1e-4.  AdamW divides each gradient entry by its own
  running magnitude, so float noise in a near-zero gradient entry
  becomes a visible (eps-bounded) update difference.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.losses import GRPOConfig as JGRPOConfig
from repro.core.losses import group_advantages as jax_group_advantages
from repro.core.losses import grpo_token_loss as jax_grpo_token_loss
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.models.registry import build as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.rollout.sampler import generate as jax_generate
from repro.rollout.sampler import score_tokens as jax_score_tokens
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.configs import reduced_config
from repro_torch.core.losses import GRPOConfig, group_advantages, \
    grpo_token_loss
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.models.registry import build
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    clip_by_global_norm
from repro_torch.rollout.sampler import generate, score_tokens
from repro_torch.runtime import PolicyStore
from repro_torch.train import (RLVRHyperparams, RLVRTrainer,
                               make_update_step)
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
CFG = reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
PROMPT_LEN = 12


@pytest.fixture(scope="module")
def weights():
    params = jax_build(JCFG).init(jax.random.PRNGKey(0))
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def scaled_weights(weights):
    """Dense weights scaled x3, so random-init sampling varies from token
    to token instead of repeating the last prompt token."""
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 3.0 if "'w'" in jax.tree_util.keystr(p) else a,
        weights[0])
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


def _close_trees(got, want, tol, scaled=False):
    got_l = tree_leaves(to_numpy(got))
    want_l = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        scale = max(1.0, float(np.abs(w).max())) if scaled else 1.0
        assert np.abs(g - w).max() <= tol * scale


def _sequences(n=6, seed=0):
    ds = MathTaskDataset(prompt_len=PROMPT_LEN, level=0, seed=seed)
    prompts, _, _ = ds.sample_batch(n)
    rng = np.random.default_rng(seed)
    completion = rng.integers(3, TOK.vocab_size, (n, 8)).astype(np.int32)
    return np.concatenate([prompts, completion], axis=1)


def test_forward_and_scoring_match_jax(weights):
    jparams, params = weights
    tokens = _sequences()
    want = jax_build(JCFG).forward(jparams, jnp.asarray(tokens))
    got = build(CFG).forward(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-5)
    w_lp, w_ent, w_val = jax_score_tokens(jax_build(JCFG), jparams,
                                          jnp.asarray(tokens), PROMPT_LEN)
    lp, ent, val = score_tokens(build(CFG), params,
                                torch.from_numpy(tokens), PROMPT_LEN)
    assert lp.shape == ent.shape == val.shape == (6, 8)
    np.testing.assert_allclose(lp.numpy(), np.asarray(w_lp), atol=1e-5)
    np.testing.assert_allclose(ent.numpy(), np.asarray(w_ent), atol=1e-4)
    np.testing.assert_allclose(val.numpy(), np.asarray(w_val), atol=1e-5)


def _jax_noise(key, n):
    """The port's noise hook replaying ``jax.random.categorical``'s draws
    under ``generate``'s per-step key split."""
    keys = jax.random.split(key, n)
    return lambda t, shape: torch.from_numpy(
        np.array(jax.random.gumbel(keys[t], shape)))


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9)])
def test_generate_matches_jax_token_exact(scaled_weights, temperature,
                                          top_p):
    jparams, params = scaled_weights
    prompts = _sequences(8, seed=1)[:, :PROMPT_LEN]
    key = jax.random.PRNGKey(7)
    want = jax_generate(jax_build(JCFG), jparams, jnp.asarray(prompts), key,
                        max_new_tokens=10, temperature=temperature,
                        top_p=top_p)
    got = generate(build(CFG), params, torch.from_numpy(prompts),
                   max_new_tokens=10, temperature=temperature, top_p=top_p,
                   noise=_jax_noise(key, 10))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # Scaled weights reach values of ~3: 1e-5 of the largest magnitude.
    for g, w in ((got.log_beta, want.log_beta), (got.values, want.values)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0,
                                                         np.abs(w).max())
    assert len(np.unique(got.completion.numpy())) > 5
    assert got.log_beta.min() < -0.5           # draws off the argmax


def test_group_advantages_match_jax():
    rewards = np.array([1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0], np.float32)
    want = np.asarray(jax_group_advantages(jnp.asarray(rewards), 4))
    got = group_advantages(torch.from_numpy(rewards), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[4:8] == 0)                 # equal rewards: no signal


@pytest.mark.parametrize("use_vaco", [True, False])
def test_grpo_loss_values_and_param_grads_match_jax(weights, use_vaco):
    """VACO with its filter active (behaviour log-probs 0.3 nats off the
    current policy) and PPO-clip: loss, aux and d loss / d params."""
    jparams, params = weights
    tokens = _sequences(8, seed=2)
    lp0, _, _ = jax_score_tokens(jax_build(JCFG), jparams,
                                 jnp.asarray(tokens), PROMPT_LEN)
    rng = np.random.default_rng(3)
    log_beta = (np.asarray(lp0) + 0.3 * rng.standard_normal(lp0.shape)
                ).astype(np.float32)
    mask = (rng.random(lp0.shape) > 0.2).astype(np.float32)
    adv = rng.standard_normal(8).astype(np.float32)
    jcfg = JGRPOConfig(use_vaco=use_vaco)

    def jloss(p):
        log_pi, _, _ = jax_score_tokens(jax_build(JCFG), p,
                                        jnp.asarray(tokens), PROMPT_LEN)
        return jax_grpo_token_loss(
            log_pi=log_pi, log_beta=jnp.asarray(log_beta),
            advantages=jnp.asarray(adv), token_mask=jnp.asarray(mask),
            cfg=jcfg)

    (w_loss, w_aux), w_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jparams)
    leaves = tree_map(lambda p: p.clone().requires_grad_(True), params)
    log_pi, _, _ = score_tokens(build(CFG), leaves, torch.from_numpy(tokens),
                                PROMPT_LEN)
    loss, aux = grpo_token_loss(
        log_pi=log_pi, log_beta=torch.from_numpy(log_beta),
        advantages=torch.from_numpy(adv), token_mask=torch.from_numpy(mask),
        cfg=GRPOConfig(use_vaco=use_vaco))
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    assert abs(loss.item() - float(w_loss)) <= 1e-5
    assert set(aux) == set(w_aux)
    for k in aux:
        assert abs(aux[k].item() - float(w_aux[k])) <= 1e-5, k
    if use_vaco:
        assert aux["filter_active"].item() == 1.0
        assert 0 < aux["frac_filtered"].item() < 1
    it = iter(grads)
    grads = tree_map(lambda p: next(it), params)
    # The value head takes no gradient from the policy loss.
    assert grads["value_head"]["w"] is None
    grads["value_head"] = tree_map(torch.zeros_like, params["value_head"])
    _close_trees(grads, w_grads, 1e-5, scaled=True)


def test_adamw_and_clip_match_jax_over_three_steps(weights):
    jparams, params = weights
    jcfg = JAdamWConfig(lr=1e-3, weight_decay=0.01, eps=1e-8)
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.01, eps=1e-8)
    jstate, state = jax_adamw_init(jparams), adamw_init(params)

    @jax.jit
    def jax_step(g, st, p):
        g, norm = jax_clip(g, 1.0)
        p, st = jax_adamw_update(g, st, p, jcfg)
        return p, st, norm

    rng = np.random.default_rng(4)
    for step, size in enumerate((0.01, 1.0, 0.001)):   # clips only step 1
        g_np = jax.tree.map(
            lambda a: (size * rng.standard_normal(a.shape)).astype(
                np.float32), jax.tree.map(np.asarray, jparams))
        jparams, jstate, jnorm = jax_step(g_np, jstate, jparams)
        g, norm = clip_by_global_norm(from_jax_params(g_np), 1.0)
        assert abs(norm.item() - float(jnorm)) <= 1e-5 * float(jnorm)
        params, state = adamw_update(g, state, params, cfg)
        assert int(state.step) == int(jstate.step) == step + 1
        _close_trees(params, jparams, 1e-6)
        _close_trees(state.m, jstate.m, 1e-6)
        _close_trees(state.v, jstate.v, 1e-6)


def test_policy_store_publishes_copies(weights):
    params = tree_map(torch.clone, weights[1])
    store = PolicyStore(params, capacity=2, guard_finite=True)
    before = tree_map(torch.clone, params)
    assert store.publish(params) == 1
    tree_map(lambda p: p.add_(1.0), params)             # learner writes
    assert store.publish(params) == 2
    _close_trees(store.get(1), jax.tree.map(jnp.asarray, to_numpy(before)),
                 0.0)
    latest, version = store.latest()
    assert version == 2
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(latest), tree_leaves(params)))
    assert store.retained_versions() == [1, 2]
    bad = tree_map(lambda p: torch.full_like(p, float("nan")), params)
    assert store.publish(bad) == 3 and store.quarantined_versions() == [3]
    assert store.latest()[1] == 2


def test_update_step_leaves_the_old_state_untouched(weights):
    """Updates are functional, so the finiteness guard's reference to the
    previous state is a snapshot, and its restore is real."""
    from repro_torch.train.trainer_rlvr import RLVRTrainState

    params = tree_map(torch.clone, weights[1])
    state = RLVRTrainState(params, adamw_init(params), 0)
    kept = tree_map(torch.clone, params)
    tokens = torch.from_numpy(_sequences(4, seed=5))
    update = make_update_step(build(CFG), RLVRHyperparams(
        algorithm="grpo_vaco"), PROMPT_LEN)
    new, aux = update(state, tokens, torch.full((4, 8), -3.0),
                      torch.ones(4, 8), torch.tensor([1.0, -1.0, 0.5, 0.0]))
    assert aux["grad_norm"].item() > 0 and new.updates == 1
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(state.params), tree_leaves(kept)))
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new.params), tree_leaves(kept)))


class _ReplayKeyChain:
    """The port generator's noise hook following the JAX
    ``ForwardLagGenerator`` key chain: one split per generate call."""

    def __init__(self, seed, n):
        self.key, self.n = jax.random.PRNGKey(seed), n

    def __call__(self):
        self.key, k = jax.random.split(self.key)
        return _jax_noise(k, self.n)


@pytest.mark.parametrize("controller", [
    None, "tv_gate:delta=0.05,mode=downweight"])
def test_rlvr_trainer_matches_jax(controller):
    """The slice end to end: 2 warmup steps, one VACO phase of 2
    minibatches (forward lag 0 and 1), then eval, on the JAX trainer's
    weights with its noise replayed; by default and with the TV gate
    scoring each item against the store's latest policy."""
    kw = dict(algorithm="grpo_vaco", n_minibatches=2, warmup_steps=2,
              controller=controller)
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
        assert abs(g.weight - w.weight) <= 1e-4    # (delta/2) / tv
        assert g.filter_active == w.filter_active
        assert abs(g.tv - w.tv) <= 1e-4
        assert abs(g.frac_filtered - w.frac_filtered) <= 1e-4
    assert any(w.mean_reward > 0 for w in want)    # advantages are nonzero
    assert want[1].filter_active == 1.0            # the filter acted
    _close_trees(tr.state.params, jtr.state.params, 1e-4)
    assert tr.evaluate(64) == jtr.evaluate(64)
    assert tr.store.version == jtr.store.version == 3
    stats = tr.queue.stats().as_dict()
    assert stats == jtr.queue.stats().as_dict()
    if controller:
        assert stats["downweighted"] == 1        # the lag-1 item


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch import train

    assert train.main(["rlvr", "--device", "cpu", "--warmup-steps", "1",
                       "--n-minibatches", "2", "--phases", "1"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[warmup] loss=")
    report = json.loads(out[out.index("{"):])
    assert report["arch"] == "qwen2.5-0.5b-reduced"
    assert report["train_step_ms"]["count"] == 2
    assert report["runtime_stats"]["policy_version"] == 3
    assert len(report["eval_accuracy"]) == 1


@pytest.mark.parametrize("argv", [
    ["rl", "--runtime", "threaded"], ["rlvr", "--runtime", "threaded"],
    ["rlvr", "--controller", "gac"], ["rlvr", "--fault-plan", "x"],
    ["rlvr", "--checkpoint-dir", "out"]])
def test_launcher_refuses_unported_options(argv):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="not ported"):
        train.main(argv)
