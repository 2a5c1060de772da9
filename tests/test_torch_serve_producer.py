"""Port vs JAX: RLVR through the serve engine at
``reduced_config("qwen2.5-0.5b")``: the phase-locked
``ServeRolloutProducer``, ``RLVRTrainer(producer="serve")`` and the
launcher's ``--producer serve --forced-lag``.

The engine's Gumbel noise is replayed from the JAX engine's key chain
(``test_torch_serve._ReplayJaxNoise``) and weights cross over through
``utils.bridge.from_jax_params``, so served tokens are equal.

Tolerances and why:
* ``log_beta`` 1e-5: float32 matmuls in another order, as for serving;
* the producer's ``log_beta`` re-scored through ``score_tokens`` on the
  generating weights: TV < 5e-3, the reference's own padded-prompt check
  (``tests/test_controllers.py``);
* the trainer after 2 warmup steps and one phase of 2 minibatches: tv,
  weight and frac_filtered 1e-4, params 1e-4 (AdamW divides each
  gradient entry by its running magnitude, so float noise in a near-zero
  entry becomes an eps-bounded update difference), as in
  ``test_torch_train.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.models.registry import build as jax_build
from repro.runtime import PolicyStore as JaxPolicyStore
from repro.runtime import ServeRolloutProducer as JaxServeRolloutProducer
from repro.runtime import TrajectoryQueue as JaxTrajectoryQueue
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.configs import reduced_config
from repro_torch.core.tv_filter import tv_estimate
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import score_tokens
from repro_torch.runtime import (PolicyStore, ServeRolloutProducer,
                                 TrajectoryQueue)
from repro_torch.serve import ServeEngine
from repro_torch.train import RLVRHyperparams, RLVRTrainer
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves

from test_torch_serve import _ReplayJaxNoise

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
CFG = reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)


def _producer_pair(version_offset):
    """The JAX producer and the port's over a store at v3 (four distinct
    inits), same dataset, same engine shape and noise."""
    inits = [jax_build(JCFG).init(jax.random.PRNGKey(i)) for i in range(4)]
    kw = dict(num_blocks=32, block_size=8, max_batch=4, max_seq_len=32,
              seed=0)
    pkw = dict(prompts_per_minibatch=2, completions_per_prompt=2,
               max_new_tokens=5, version_offset=version_offset)
    jstore = JaxPolicyStore(inits[0], capacity=4)
    store = PolicyStore(from_jax_params(
        jax.tree.map(np.asarray, inits[0]), "cpu"), capacity=4)
    for p in inits[1:]:
        jstore.publish(p)
        store.publish(from_jax_params(jax.tree.map(np.asarray, p), "cpu"))
    jeng = JaxServeEngine(jax_build(JCFG), store=jstore, **kw)
    eng = ServeEngine(build(CFG), store=store, device="cpu", **kw)
    _ReplayJaxNoise(eng, kw["seed"], 1.0, 1.0)

    def ds():
        return dict(prompt_len=12, level=0, pool_size=64, seed=0)

    jq, q = JaxTrajectoryQueue(), TrajectoryQueue()
    jprod = JaxServeRolloutProducer(jstore, jq, jeng,
                                    JaxMathTaskDataset(**ds()), **pkw)
    prod = ServeRolloutProducer(store, q, eng, MathTaskDataset(**ds()),
                                **pkw)
    return (jprod, jq), (prod, q)


def test_serve_producer_matches_jax_under_forced_lag():
    (jprod, jq), (prod, q) = _producer_pair(version_offset=2)
    assert prod.engine.swap_interval == 0
    jprod.fill()
    prod.fill()
    want = jq.get(learner_version=jprod.store.version)
    got = q.get(learner_version=prod.store.version)
    # Forced lag 2 from v3: every token from v1, the first minibatch too.
    np.testing.assert_array_equal(got.payload.versions,
                                  np.asarray(want.payload.versions))
    assert got.payload.versions.shape == (4, 5)
    assert got.payload.versions.min() == got.payload.versions.max() == 1
    for attr in ("behavior_version", "behavior_version_newest", "lag",
                 "lag_newest", "meta"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.meta["producer"] == "serve" and got.lag == 2
    g, w = got.payload.gen, want.payload.gen
    np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(w.tokens))
    np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
    np.testing.assert_allclose(g.log_beta.numpy(), np.asarray(w.log_beta),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.payload.rewards.numpy(),
                                  np.asarray(want.payload.rewards))
    assert got.payload.answers == want.payload.answers
    # The padded-prompt discipline: the engine's log_beta re-scores to ~0
    # TV against the generating weights through the learner's scoring.
    with torch.no_grad():
        log_pi, _, _ = score_tokens(build(CFG), prod.store.get(1), g.tokens,
                                    prod.dataset.prompt_len)
    tv = float(tv_estimate(log_pi - g.log_beta, g.mask))
    assert tv < 5e-3, f"serve log_beta disagrees with score_tokens: {tv}"


def test_serve_producer_refuses_what_is_not_ported():
    (_, _), (prod, q) = _producer_pair(version_offset=None)
    kw = dict(prompts_per_minibatch=1, completions_per_prompt=1,
              max_new_tokens=1)
    # The threaded mode is ported (tests/test_torch_threaded.py): it
    # builds, and starts no thread until start().
    threaded = ServeRolloutProducer(prod.store, q, prod.engine,
                                    prod.dataset, threaded=True, **kw)
    assert not threaded.phase_locked and not threaded.running
    other = PolicyStore(prod.store.get(3), capacity=2)
    with pytest.raises(ValueError, match="share"):
        ServeRolloutProducer(other, q, prod.engine, prod.dataset, **kw)
    assert prod.engine.swap_interval == 1      # no forced lag: it polls


def _close_trees(got, want, tol):
    got_l = tree_leaves(to_numpy(got))
    want_l = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert np.abs(g - w).max() <= tol


@pytest.fixture(scope="module")
def jax_rollouts():
    """The JAX serve producer's minibatches, shared by the cases' JAX
    trainers (see :func:`_share_jax_rollouts`)."""
    return {}


def _share_jax_rollouts(trainer, cache):
    """Under forced lag 2 both minibatches of the phase are generated
    from v0, the init every case starts from (``resolve_lagged(-2)`` at
    versions 1 and 2), by an engine in the same state, so the JAX
    engine's rollouts do not depend on the controller.  The first case
    runs the JAX engine and keeps its minibatches; each later case
    checks that its v0 is that case's and that its producer would serve
    the same version, then takes them instead of running (and compiling)
    the JAX engine again.  The port's engine runs in every case."""
    regime = trainer.regime
    v0 = [np.asarray(x) for x in jax.tree.leaves(trainer.store.get(0))]
    if "v0" not in cache:
        cache.update(v0=v0, minibatches=[], versions=[])
    for a, b in zip(v0, cache["v0"], strict=True):
        np.testing.assert_array_equal(a, b)
    produce = regime._produce_minibatch
    calls = []

    def shared():
        i = len(calls)
        calls.append(i)
        if i < len(cache["minibatches"]):
            regime._apply_forced_lag()
            assert int(regime.engine.version) == cache["versions"][i] == 0
            regime._last_timeouts = 0
            return cache["minibatches"][i]
        mb = produce()
        cache["minibatches"].append(mb)
        cache["versions"].append(int(regime.engine.version))
        return mb

    regime._produce_minibatch = shared


@pytest.mark.parametrize("controller", [
    None, "tv_gate:delta=0.05,mode=downweight"])
def test_serve_rlvr_trainer_matches_jax(controller, jax_rollouts):
    """2 warmup steps, then one VACO phase of 2 minibatches produced by
    the serve engine under forced lag 2: phase logs, params, queue stats
    and store versions against the JAX trainer.  Both items come from the
    random init (v0), which earns no reward at this size, so the
    update's gradient path is held by ``test_torch_train.py``; here the
    engine's provenance, the lag, VACO's filter and the TV gate's
    scoring are.  The two cases' JAX trainers share the JAX engine's
    rollouts, which under forced lag 2 do not depend on the controller
    (``_share_jax_rollouts``)."""
    kw = dict(algorithm="grpo_vaco", n_minibatches=2, warmup_steps=2,
              controller=controller, producer="serve", forced_lag=2)
    jtr = JaxRLVRTrainer(jax_build(JCFG),
                         JaxMathTaskDataset(prompt_len=32, level=0),
                         JHyperparams(**kw), seed=0)
    tr = RLVRTrainer(build(CFG), MathTaskDataset(prompt_len=32, level=0),
                     RLVRHyperparams(**kw), seed=0, device="cpu",
                     params=from_jax_params(
                         jax.tree.map(np.asarray, jtr.state.params)))
    _ReplayJaxNoise(tr.engine, 2, tr.hp.temperature, 1.0)   # seed + 2
    _share_jax_rollouts(jtr, jax_rollouts)
    assert abs(tr.warmup() - jtr.warmup()) <= 1e-4
    want, got = jtr.train_phase(), tr.train_phase()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.mean_reward == w.mean_reward
        assert g.staleness == w.staleness
        assert g.filter_active == w.filter_active
        assert abs(g.weight - w.weight) <= 1e-4
        assert abs(g.tv - w.tv) <= 1e-4
        assert abs(g.frac_filtered - w.frac_filtered) <= 1e-4
    # The first item comes from v0 (resolve_lagged(-2) at v1 clamps to
    # the oldest resident), the second from v0 at v2.
    assert [g.staleness for g in got] == [1, 2]
    assert all(w.filter_active == 1.0 and w.tv > 0.1 for w in want)
    assert tr.engine.version == jtr.engine.version == 0
    _close_trees(tr.state.params, jtr.state.params, 1e-4)
    assert tr.store.version == jtr.store.version == 3
    assert tr.store.retained_versions() == jtr.store.retained_versions()
    stats = tr.queue.stats().as_dict()
    assert stats == jtr.queue.stats().as_dict()
    if controller:
        assert stats["downweighted"] == 2


def test_launcher_trains_through_the_serve_engine(capsys):
    from repro_torch.launch import train

    assert train.main(["rlvr", "--device", "cpu", "--producer", "serve",
                       "--forced-lag", "2", "--warmup-steps", "1",
                       "--n-minibatches", "2", "--phases", "1",
                       "--engine-max-batch", "16"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    # The keys repro.launch.train prints for rlvr.
    assert set(report) == {"arch", "algorithm", "runtime", "n_minibatches",
                           "eval_accuracy", "final_tv", "runtime_stats",
                           "train_step_ms"}
    assert report["train_step_ms"]["count"] == 2
    assert report["runtime_stats"]["policy_version"] == 3
    assert report["runtime_stats"]["queue"]["lag_histogram"] == {"1": 1,
                                                                 "2": 1}
