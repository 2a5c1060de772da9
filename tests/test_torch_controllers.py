"""Port vs JAX: the learner-side lag controllers (``gac``,
``stable_async``, ``asympo``), the registry that builds them, and the
split update step GAC runs on, at ``reduced_config("qwen2.5-0.5b")``.

Tolerances and why:
* GAC's cosine 1e-5: float32 dot products summed over the leaves in
  another order (the port walks dicts in insertion order, JAX sorts;
  the gradient trees here are built out of sorted order, so the port
  really sums in its own);
  the scale and the anchor EMA 1e-6 (a few float32 ops on equal
  inputs).  Every cosine is kept further than 1e-3 from ``cos_min``, so
  the branch taken cannot flip on that noise;
* ``stable_async`` and ``asympo`` are numpy on both sides: weights and
  ``item.meta`` exactly equal on the same arrays;
* the port's split step with an identity transform against JAX's
  fused, jitted step: params and AdamW moments rtol = atol = 1e-6, the
  loss's aux values 1e-5 of max(1, |value|) (float32 reductions in
  another order);
* the trainer, 2 warmup steps and 2 learner steps under each controller:
  params rtol = atol = 1e-5, per-step floats (tv, weight, frac,
  ``stable_async``'s ``c``/``var``/``mean_weight``) 1e-5, the rest
  exactly.  GAC's cosine over the model's gradients: the port's within
  1e-5 of the float64 cosine of the JAX trainer's own gradients.  The
  reference's jitted float32 reduction is itself 1e-3 from that value
  on the CPU (measured: -0.49512 against -0.494065), so the two
  packages' reported cosines are held to each other within 2e-3.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.models.registry import build as jax_build
from repro.runtime import controllers as jctl
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.configs import reduced_config
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.models.registry import build
from repro_torch.runtime import controllers as tctl
from repro_torch.train import (RLVRHyperparams, RLVRTrainer,
                               make_split_update_step)
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_map)

from test_torch_serve import _ReplayJaxNoise
from test_torch_serve_producer import _share_jax_rollouts
from test_torch_train import _ReplayKeyChain

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
CFG = reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
LEARNER = ("gac", "stable_async", "asympo")


# --- the registry -------------------------------------------------------------


def test_registry_builds_all_seven():
    assert set(tctl.available_controllers()) == set(
        jctl.available_controllers()) and len(
        tctl.available_controllers()) == 7
    for name, info in jctl.available_controllers().items():
        mine = tctl.available_controllers()[name]
        assert (mine.description, mine.paper) == (info.description,
                                                  info.paper)
        kw = dict(tv_fn=lambda p: 0.0)
        want, got = jctl.make_controller(name, **kw), tctl.make_controller(
            name, **kw)
        assert type(got).__name__ == type(want).__name__
        assert (got.needs_log_pi, got.needs_gradients) == (
            want.needs_log_pi, want.needs_gradients)
    for cls in ("GradientAlignmentController", "StableAsyncController",
                "AsymPOController"):
        assert cls in tctl.__all__ and cls in jctl.__all__


@pytest.mark.parametrize("spec", [
    "gac:bogus=1", "gac:ema=1.0", "stable_async:c_min=0",
    "stable_async:c_min=3.0,c_max=2.0", "stable_async:iters=5",
    "asympo:pos_decay=0", "asympo:pos_decay=1.5", "asympo:neg=1"])
def test_controller_option_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jctl.make_controller(spec)
    with pytest.raises(ValueError) as got:
        tctl.make_controller(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "gac:cos_min=0.5,fresh_lag=1,ema=0.5,min_scale=0.1",
    "stable_async:c_max=3.0,c_min=1.5,var_max=0.1",
    "asympo:pos_scale=2.0,neg_scale=0.5,pos_decay=0.8"])
def test_controller_options_parse_as_in_jax(spec):
    want, got = jctl.make_controller(spec), tctl.make_controller(spec)
    keep = lambda c: {k: v for k, v in vars(c).items()
                      if not k.startswith("_")}
    assert keep(got) == keep(want)


# --- GAC on one gradient sequence ---------------------------------------------


def _grad_trees(seed=0, n=7):
    """A base direction plus noise in amounts that give cosines on both
    sides of ``cos_min`` and below 0; dict keys out of sorted order."""
    rng = np.random.default_rng(seed)
    shapes = {"z": (4, 3), "b": {"w": (5,), "a": (2, 2)}, "c": (6,)}
    make = lambda f: {k: ({kk: f(ss) for kk, ss in s.items()}
                          if isinstance(s, dict) else f(s))
                      for k, s in shapes.items()}
    base = make(lambda s: rng.standard_normal(s).astype(np.float32))
    trees = []
    for a in (1.0, 0.9, 0.05, -0.8, 0.6, 0.3, 1.0)[:n]:
        noise = make(lambda s: rng.standard_normal(s).astype(np.float32))
        # The port's tree_map keeps the keys' order (jax.tree.map sorts).
        trees.append(tree_map(lambda x, e: a * x + 0.6 * e, base, noise))
    return trees


def test_gac_decisions_and_anchor_match_jax():
    lags = (0, 2, 1, 3, 0, 2, 4)
    jc, tc = jctl.make_controller("gac"), tctl.make_controller("gac")
    seen_scales = set()
    for lag, g in zip(lags, _grad_trees()):
        item = types.SimpleNamespace(lag=lag, meta={})
        want, winfo = jc.transform_gradients(item, jax.tree.map(
            jax.numpy.asarray, g))
        port_g = from_jax_params(g)
        assert list(port_g) == ["z", "b", "c"]      # not JAX's order
        got, info = tc.transform_gradients(item, port_g)
        assert set(info) == set(winfo) == {"gac_cos", "gac_scale"}
        assert abs(info["gac_cos"] - winfo["gac_cos"]) <= 1e-5
        if winfo["gac_cos"] != 1.0:
            assert abs(winfo["gac_cos"] - jc.cos_min) > 1e-3
        assert abs(info["gac_scale"] - winfo["gac_scale"]) <= 1e-6
        seen_scales.add(round(winfo["gac_scale"], 3))
        for mine, theirs in ((got, want), (tc._anchor, jc._anchor)):
            pairs = tree_leaves_with_path(to_numpy(mine))
            wpairs = jax.tree_util.tree_leaves_with_path(theirs)
            assert [p for p, _ in pairs] == [jax.tree_util.keystr(p)
                                             for p, _ in wpairs]
            for (_, a), (_, b) in zip(pairs, wpairs):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                           atol=1e-6)
    # Full scale, a partial scale and the floor all happened.
    assert 1.0 in seen_scales and 0.0 in seen_scales and len(seen_scales) > 2


def test_gac_anchor_is_a_copy():
    tc = tctl.make_controller("gac")
    grads = {"w": torch.ones(3)}
    tc.transform_gradients(types.SimpleNamespace(lag=0, meta={}), grads)
    grads["w"].mul_(-5.0)              # the update reusing its buffer
    assert torch.equal(tc._anchor["w"], torch.ones(3))


# --- stable_async and asympo on the same arrays -------------------------------


def _loss_inputs(case, b=6, s=5):
    rng = np.random.default_rng(case)
    log_beta = rng.normal(-2.0, 0.5, (b, s)).astype(np.float32)
    spread = (0.0, 0.3, 1.5, 4.0)[case % 4]
    log_pi = (log_beta + rng.normal(0.0, spread, (b, s))).astype(np.float32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    if case == 4:
        mask[:] = 0.0
    adv = rng.normal(0.0, 1.0, b).astype(np.float32)
    return dict(advantages=adv, log_beta=log_beta, mask=mask,
                log_pi=log_pi)


@pytest.mark.parametrize("spec", ["stable_async", "stable_async:var_max=0.05",
                                  "asympo", "asympo:pos_decay=0.5"])
@pytest.mark.parametrize("case", range(5))
def test_loss_weight_controllers_match_jax_exactly(spec, case):
    kw = _loss_inputs(case)
    lag = case % 3
    jitem = types.SimpleNamespace(lag=lag, meta={})
    titem = types.SimpleNamespace(lag=lag, meta={})
    want = jctl.make_controller(spec).loss_weights(jitem, **kw)
    got = tctl.make_controller(spec).loss_weights(titem, **kw)
    if want is None:
        assert got is None and titem.meta == jitem.meta == {}
        return
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert titem.meta == jitem.meta and len(titem.meta) == 1


def test_stable_async_requires_log_pi():
    kw = _loss_inputs(1)
    kw.pop("log_pi")
    with pytest.raises(ValueError, match="needs_log_pi"):
        tctl.make_controller("stable_async").loss_weights(
            types.SimpleNamespace(lag=1, meta={}), **kw)


# --- the split step ---------------------------------------------------------


def test_split_step_with_identity_transform_equals_fused_step():
    """The port's two halves with nothing between them (the step every
    controller but GAC runs) against JAX's fused, jitted update on the
    same params and minibatch, two steps."""
    from repro.optim import adamw_init as jax_adamw_init
    from repro.train.trainer_rlvr import RLVRTrainState as JaxTrainState
    from repro.train.trainer_rlvr import make_update_step as jax_update_step
    from repro_torch.optim import adamw_init
    from repro_torch.train import RLVRTrainState

    jparams = jax_build(JCFG).init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    jstate = JaxTrainState(jparams, jax_adamw_init(jparams), 0)
    state = RLVRTrainState(params, adamw_init(params), 0)
    jhp, hp = (JHyperparams(algorithm="grpo_vaco"),
               RLVRHyperparams(algorithm="grpo_vaco"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, TOK.vocab_size, (4, 20)).astype(np.int32)
    log_beta = rng.normal(-3, 0.3, (4, 8)).astype(np.float32)
    mask = np.ones((4, 8), np.float32)
    adv = np.array([1.0, -1.0, 0.5, -0.5], np.float32)
    fused = jax_update_step(jax_build(JCFG), jhp, 12)
    grad_step, apply_step = make_split_update_step(build(CFG), hp, 12)
    for _ in range(2):
        jstate, waux = fused(jstate, tokens, log_beta, mask, adv)
        grads, aux = grad_step(state, *map(torch.from_numpy,
                                           (tokens, log_beta, mask, adv)))
        state, aux["grad_norm"] = apply_step(state, tree_map(lambda g: g,
                                                             grads))
        assert set(aux) == set(waux) and state.updates == int(jstate.updates)
        for k in aux:
            assert abs(float(aux[k]) - float(waux[k])) <= 1e-5 * max(
                1.0, abs(float(waux[k]))), k
        for got, want in ((state.params, jstate.params),
                          (state.opt_state.m, jstate.opt_state.m),
                          (state.opt_state.v, jstate.opt_state.v)):
            for a, b in zip(tree_leaves(to_numpy(got)), jax.tree.leaves(
                    jax.tree.map(np.asarray, want))):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# --- the trainer under each controller --------------------------------------


def _host64(tree):
    return [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(
        jax.tree.map(np.asarray, tree))]


def _cos64(a, b):
    dot = sum(float(x @ y) for x, y in zip(a, b))
    return dot / np.sqrt(sum(float(x @ x) for x in a)
                         * sum(float(y @ y) for y in b))


def _record(trainer, is_jax):
    """Every consumed item, every learner step's aux, and the float64
    cosine of each stale GAC step's gradients with its anchor, as the
    controller sees them."""
    items, auxes, exact = [], [], []
    ctrl = trainer.controller
    next_item, on_step = trainer.regime.next_item, ctrl.on_learner_step
    transform = ctrl.transform_gradients

    def recording_transform(item, grads):
        if ctrl._anchor is not None and item.lag > ctrl.fresh_lag:
            as_np = (lambda t: t) if is_jax else to_numpy
            exact.append(_cos64(_host64(as_np(grads)),
                                _host64(as_np(ctrl._anchor))))
        return transform(item, grads)

    if ctrl.needs_gradients:
        ctrl.transform_gradients = recording_transform

    def recording_next_item(*a, **k):
        item = next_item(*a, **k)
        if item is not None:
            items.append(item)
        return item

    def recording_on_step(item, aux):
        auxes.append({k: float(np.asarray(v)) for k, v in aux.items()})
        return on_step(item, aux)

    trainer.regime.next_item = recording_next_item
    ctrl.on_learner_step = recording_on_step
    return items, auxes, exact


def _seeded_rewards(trainer, is_jax):
    """The serve producer's rewards replaced by a seeded draw (the random
    init earns none at this size), the same on both sides, so every
    learner step has a gradient."""
    produce = trainer.regime._produce_minibatch
    rng = np.random.default_rng(7)

    def produce_seeded():
        mb = produce()
        r = (rng.random(np.asarray(mb.rewards).shape) < 0.5).astype(
            np.float32)
        return mb._replace(rewards=jax.numpy.asarray(r) if is_jax
                           else torch.from_numpy(r))

    trainer.regime._produce_minibatch = produce_seeded


@pytest.fixture(scope="module")
def jax_rollouts():
    """The JAX serve producer's minibatches, shared by the serve-producer
    cases' JAX trainers (``test_torch_serve_producer.
    _share_jax_rollouts``)."""
    return {}


def _close(a, b, tol=1e-5):
    return abs(a - b) <= tol * max(1.0, abs(b))


@pytest.mark.parametrize("producer", ["legacy", "serve"])
@pytest.mark.parametrize("controller", LEARNER)
def test_rlvr_trainer_under_controller_matches_jax(controller, producer,
                                                  jax_rollouts):
    """2 warmup steps, then one VACO phase of 2 minibatches: legacy
    producer (forward lag 0 and 1), or the serve engine under forced lag
    2 with seeded rewards.  Phase logs, what the controller wrote into
    each item's ``meta`` and each step's aux (GAC's cosine and scale),
    and the params against the JAX trainer.

    Both RL phases start from the JAX warm start: the port's warmup is
    held to JAX's (1e-4, ``test_torch_train.py``), but AdamW turns float
    noise in a near-zero warmup gradient entry into an eps-bounded
    difference, which would hide what the two learner steps do.  The
    serve cases' JAX trainers share the JAX engine's rollouts, which
    under forced lag 2 do not depend on the controller
    (``_share_jax_rollouts``)."""
    kw = dict(algorithm="grpo_vaco", n_minibatches=2, warmup_steps=2,
              controller=controller)
    if producer == "serve":
        kw.update(producer="serve", forced_lag=2)
    jtr = JaxRLVRTrainer(jax_build(JCFG),
                         JaxMathTaskDataset(prompt_len=32, level=0),
                         JHyperparams(**kw), seed=0)
    tr = RLVRTrainer(build(CFG), MathTaskDataset(prompt_len=32, level=0),
                     RLVRHyperparams(**kw), seed=0, device="cpu",
                     params=from_jax_params(
                         jax.tree.map(np.asarray, jtr.state.params)))
    if producer == "serve":
        _ReplayJaxNoise(tr.engine, 2, tr.hp.temperature, 1.0)
        _share_jax_rollouts(jtr, jax_rollouts)
        _seeded_rewards(jtr, True)
        _seeded_rewards(tr, False)
    else:
        tr.generator._noise = _ReplayKeyChain(1, tr.hp.max_new_tokens)
    jitems, jaux, jexact = _record(jtr, True)
    items, aux, exact = _record(tr, False)
    assert abs(tr.warmup() - jtr.warmup()) <= 1e-4
    warm = from_jax_params(jax.tree.map(np.asarray, jtr.state.params))
    tr.state = tr.state._replace(params=warm)
    for slot, w in zip(tree_leaves(tr.store.get(1)), tree_leaves(warm)):
        slot.copy_(w)                  # v1, the ring's view of its slot
    want, got = jtr.train_phase(), tr.train_phase()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.mean_reward == w.mean_reward and g.staleness == w.staleness
        assert g.filter_active == w.filter_active
        for f in ("tv", "weight", "frac_filtered"):
            assert _close(getattr(g, f), getattr(w, f)), f
    assert any(w.mean_reward > 0 for w in want)
    for g, w in zip(items, jitems):
        assert g.meta.keys() == w.meta.keys() and g.lag == w.lag
        for key in ("stable_async", "asympo"):
            if key in w.meta:
                assert g.meta[key].keys() == w.meta[key].keys()
                for f, v in w.meta[key].items():
                    assert _close(g.meta[key][f], v), (key, f)
    for g, w in zip(aux, jaux):
        assert g.keys() == w.keys()
        if controller == "gac":
            assert abs(g["gac_cos"] - w["gac_cos"]) <= 2e-3
            assert g["gac_scale"] == pytest.approx(w["gac_scale"], abs=1e-6)
    if controller == "gac":
        assert jaux[0]["gac_cos"] == aux[0]["gac_cos"] == 1.0
        assert len(exact) == len(jexact) == 1      # the stale step
        assert abs(aux[1]["gac_cos"] - jexact[0]) <= 1e-5
        assert abs(exact[0] - jexact[0]) <= 1e-5
        assert abs(jexact[0] - 0.25) > 1e-2
    if controller == "stable_async":
        assert all("stable_async" in i.meta for i in items)
    if controller == "asympo":
        assert [i.meta["asympo"]["lag"] for i in items] == [
            w.staleness for w in want]
    for a, b in zip(tree_leaves(to_numpy(tr.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jtr.state.params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert tr.store.version == jtr.store.version == 3
    assert tr.queue.stats().as_dict() == jtr.queue.stats().as_dict()
