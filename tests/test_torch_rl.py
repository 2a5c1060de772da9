"""Port vs JAX: the classic-RL path (``train rl``) on the CPU, at the
model's published width (two 2x64 tanh MLPs) and a small scale.

Weights cross over through ``utils.bridge.from_jax_params``.  Every
random draw of the port goes through ``rollout.env_rollout.Draws``;
here ``JaxDraws`` replays the JAX key chain through it (the JAX PRNG
stream cannot be drawn in torch), so both sides see the same numbers.

Tolerances and why:
* envs 1e-6 (float32 elementwise dynamics, the same formulas);
* policy outputs, rollouts 1e-5 (float32 matmuls in another order);
* one train phase: metrics 1e-5 relative, params 1e-4 (AdamW divides
  each gradient entry by its own running magnitude, so float noise in a
  near-zero entry becomes a visible, eps-bounded update difference);
* whole runs (2 phases + evaluation): returns and metrics 1e-4 relative.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributions import DiagGaussian as JDiagGaussian
from repro.envs import make_env as jax_make_env
from repro.envs import wrap_autoreset as jax_wrap_autoreset
from repro.models.mlp_policy import act as jax_act
from repro.models.mlp_policy import mlp_policy_init as jax_policy_init
from repro.models.mlp_policy import policy_dist as jax_policy_dist
from repro.models.mlp_policy import value_fn as jax_value_fn
from repro.rollout.async_engine import \
    SimulatedAsyncActors as JSimulatedAsyncActors
from repro.train.runner_rl import AsyncRLRunConfig as JRunConfig
from repro.train.runner_rl import run_async_rl as jax_run_async_rl
from repro.train.trainer_rl import RLHyperparams as JHyperparams
from repro.train.trainer_rl import init_train_state as jax_init_state
from repro.train.trainer_rl import make_train_phase as jax_train_phase
from repro_torch.core.distributions import DiagGaussian
from repro_torch.envs import make_env, wrap_autoreset
from repro_torch.models.mlp_policy import act, policy_dist, value_fn
from repro_torch.rollout.async_engine import SimulatedAsyncActors
from repro_torch.rollout.env_rollout import RolloutBatch
from repro_torch.train import (AsyncRLRunConfig, RLHyperparams,
                               init_train_state, make_train_phase,
                               run_async_rl)
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

ENVS = ("pendulum", "cartpole_swingup", "acrobot", "pointmass", "reacher")
ALGOS = ("vaco", "ppo", "ppo_kl", "spo", "impala")
U = jax.random.uniform
N = jax.random.normal
# The standard draws each JAX env's reset(key) makes, in column order.
RESET_DRAWS = {
    "pendulum": lambda k: jnp.stack([U(s, ()) for s in jax.random.split(k)]),
    "cartpole_swingup": lambda k: jnp.stack(
        [N(s) for s in jax.random.split(k)]),
    "acrobot": lambda k: U(k, (4,)),
    "pointmass": lambda k: jnp.concatenate(
        [U(s, (2,)) for s in jax.random.split(k)]),
    "reacher": lambda k: (lambda k1, k2, k3: jnp.concatenate(
        [U(k1, (2,)), U(k2, (1,)), U(k3, (1,))]))(*jax.random.split(k, 3)),
}


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


class JaxDraws:
    """``Draws`` replaying the JAX key that stands in the same place."""

    def __init__(self, key, env_name):
        self.key, self.env = key, env_name

    def split(self, num=2):
        return tuple(JaxDraws(k, self.env)
                     for k in jax.random.split(self.key, num))

    def _reset(self, key):
        return RESET_DRAWS[self.env](key)

    def _autoreset(self, key):   # wrap_autoreset's (k_step, k_reset)
        return self._reset(jax.random.split(key)[1])

    def env_reset(self, n, kinds):
        return _t(jax.vmap(self._reset)(jax.random.split(self.key, n)))

    def rollout(self, n, steps, act_dim, kinds):
        def step(k):
            k_act, k_env = jax.random.split(k)
            eps = jax.vmap(lambda a: N(a, (act_dim,)))(
                jax.random.split(k_act, n))
            return eps, jax.vmap(self._autoreset)(jax.random.split(k_env, n))

        eps, resets = jax.vmap(step)(jax.random.split(self.key, steps))
        return _t(eps), _t(resets)

    def slots(self, n, count):
        return _t(jax.random.randint(self.key, (n,), 0, count), torch.int64)

    def permutations(self, num, m):
        perm = jax.vmap(lambda k: jax.random.permutation(k, m))(
            jax.random.split(self.key, num))
        return _t(perm, torch.int64)

    def episodes(self, n, steps, kinds):
        def episode(k):
            k0, k1 = jax.random.split(k)
            return self._reset(k0), jax.vmap(self._autoreset)(
                jax.random.split(k1, steps))

        r0, rs = jax.vmap(episode)(jax.random.split(self.key, n))
        return _t(r0), _t(rs).transpose(0, 1)


def _close(got, want, tol, rel=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel else 1.0
    assert np.abs(got.astype(np.float64) - want).max() <= tol * scale


def _close_trees(got, want, tol):
    got_l = tree_leaves(to_numpy(got))
    want_l = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        _close(g, w, tol)


def _policy(env_name, seed=0):
    env = jax_make_env(env_name)
    jp = jax_policy_init(jax.random.PRNGKey(seed), env.obs_dim, env.act_dim)
    # Larger log-std and head weights, so actions and ratios vary.
    jp = dict(jp, log_std=jnp.full_like(jp["log_std"], -0.5))
    jp["actor"]["head"]["w"] = jp["actor"]["head"]["w"] * 30.0
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _jax_batch_to_torch(b):
    return RolloutBatch(*(_t(x) for x in b))


# ---------------------------------------------------------------------------
# Distributions, envs, policy
# ---------------------------------------------------------------------------


def test_diag_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    m, s, m2, s2, a = (rng.standard_normal((5, 2)).astype(np.float32)
                       for _ in range(5))
    jd, jo = JDiagGaussian(m, s), JDiagGaussian(m2, s2)
    d, o = DiagGaussian(_t(m), _t(s)), DiagGaussian(_t(m2), _t(s2))
    _close(d.log_prob(_t(a)), jd.log_prob(a), 1e-5)
    _close(d.entropy(), jd.entropy(), 1e-6)
    _close(d.kl(o), jd.kl(jo), 1e-5)
    key = jax.random.PRNGKey(1)
    eps = N(key, m.shape)
    _close(d.sample(_t(eps)), jd.sample(key), 1e-6)


def _perturb(state, rng, scale):
    return type(state)(*(np.asarray(f) + scale * rng.standard_normal(
        np.shape(f)).astype(np.float32) for f in state))


@pytest.mark.parametrize("name", ENVS)
def test_env_reset_and_step_match_jax(name):
    """Reset from replayed keys, then 6 steps from random states and
    random actions (clipped and unclipped)."""
    jenv, env = jax_make_env(name), make_env(name)
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    jstate = jax.vmap(jenv.reset)(keys)
    state = env.reset(JaxDraws(jax.random.PRNGKey(3), name).env_reset(
        16, env.reset_kinds))
    for g, w in zip(state, jstate):
        _close(g, w, 1e-6)
    rng = np.random.default_rng(4)
    jstate = _perturb(jstate, rng, 1.5)
    if name == "cartpole_swingup":      # some carts leave the track
        jstate = jstate._replace(
            x=np.linspace(-2.6, 2.6, 16, dtype=np.float32),
            xdot=np.full(16, 4.0, np.float32))
    state = type(state)(*(_t(f) for f in jstate))
    jstep = jax.vmap(jenv.step)
    for _ in range(6):
        a = (1.5 * rng.standard_normal((16, env.act_dim))).astype(np.float32)
        jstate, jts = jstep(jstate, a, keys)
        state, ts = env.step(state, _t(a), None)
        for g, w in zip(state, jstate):
            _close(g, w, 1e-6, rel=True)
        _close(ts.obs, jts.obs, 1e-6, rel=True)
        _close(ts.reward, jts.reward, 1e-6, rel=True)
        assert np.array_equal(ts.done.numpy(), np.asarray(jts.done))
    if name == "cartpole_swingup":
        assert 0 < ts.done.sum() < 16


@pytest.mark.parametrize("name", ["pendulum", "cartpole_swingup"])
def test_wrap_autoreset_matches_jax(name):
    """Time-limit truncation (5 steps) and, for cartpole, termination:
    resets drawn on every step, kept where done."""
    jenv = jax_wrap_autoreset(jax_make_env(name, max_steps=5))
    env = wrap_autoreset(make_env(name, max_steps=5))
    n, steps = 6, 12
    draws = JaxDraws(jax.random.PRNGKey(5), name)
    k0, k_roll = draws.split(2)
    jstate = jax.vmap(jenv.reset)(jax.random.split(k0.key, n))
    state = env.reset(k0.env_reset(n, env.reset_kinds))
    _, resets = k_roll.rollout(n, steps, env.act_dim, env.reset_kinds)
    step_keys = jax.random.split(k_roll.key, steps)
    rng = np.random.default_rng(6)
    dones = 0
    for t in range(steps):
        a = (3.0 * rng.standard_normal((n, 1))).astype(np.float32)
        k_env = jax.random.split(step_keys[t])[1]
        jstate, jts = jax.vmap(jenv.step)(jstate, a,
                                          jax.random.split(k_env, n))
        state, ts = env.step(state, _t(a), resets[t])
        _close(ts.obs, jts.obs, 1e-6, rel=True)
        _close(ts.reward, jts.reward, 1e-6, rel=True)
        assert np.array_equal(ts.done.numpy(), np.asarray(jts.done))
        assert np.array_equal(ts.info_steps.numpy(),
                              np.asarray(jts.info_steps))
        dones += int(ts.done.sum())
    assert dones >= 2 * n


def test_mlp_policy_matches_jax():
    jp, p = _policy("reacher")
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((9, 8)).astype(np.float32)
    jd, d = jax_policy_dist(jp, obs), policy_dist(p, _t(obs))
    _close(d.mean, jd.mean, 1e-5, rel=True)
    _close(d.log_std, jd.log_std, 0)
    _close(value_fn(p, _t(obs)), jax_value_fn(jp, obs), 1e-5, rel=True)
    key = jax.random.PRNGKey(8)
    ja, jlp = jax_act(jp, obs, key)
    a, lp = act(p, _t(obs), _t(N(key, (9, 2))))
    _close(a, ja, 1e-5, rel=True)
    _close(lp, jlp, 1e-5, rel=True)
    # Per-actor params (the mixture): a batched matmul per layer against
    # the JAX vmap.
    jps = [_policy("reacher", seed)[0] for seed in range(9)]
    jstack = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    stack = from_jax_params(jax.tree.map(np.asarray, jstack))
    keys = jax.random.split(key, 9)
    ja, jlp = jax.vmap(jax_act)(jstack, obs, keys)
    a, lp = act(stack, _t(obs), _t(jax.vmap(lambda k: N(k, (2,)))(keys)))
    _close(a, ja, 1e-5, rel=True)
    _close(lp, jlp, 1e-5, rel=True)


# ---------------------------------------------------------------------------
# Rollout and train phase
# ---------------------------------------------------------------------------


def _mixture_actors(name="pendulum", n=4, steps=16, cap=4):
    """JAX and port actors over the same 4-snapshot ring (versions 0-3 of
    perturbed weights); the port replays the producer's key chain."""
    jp, p = _policy(name)
    jenv, env = (jax_wrap_autoreset(jax_make_env(name)),
                 wrap_autoreset(make_env(name)))
    ja = JSimulatedAsyncActors(jenv, jax_act, jp, n_actors=n,
                               buffer_capacity=cap, rollout_steps=steps,
                               seed=11)
    ta = SimulatedAsyncActors(env, act, p, n_actors=n, buffer_capacity=cap,
                              rollout_steps=steps, device="cpu",
                              draws=JaxDraws(jax.random.PRNGKey(11), name))
    rng = np.random.default_rng(12)
    for _ in range(cap - 1):
        jp = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), jp)
        ja.push_policy(jp)
        ta.push_policy(from_jax_params(jax.tree.map(np.asarray, jp)))
    return ja, ta


def test_collect_rollout_over_a_mixture_matches_jax():
    ja, ta = _mixture_actors()
    for _ in range(2):                  # env states carry across calls
        (jb, jslots), (b, slots) = ja.collect(), ta.collect()
        assert np.array_equal(slots.numpy(), np.asarray(jslots))
        for g, w in zip(b, jb):
            _close(g, w, 1e-5, rel=True)
    assert len(set(slots.tolist())) > 1   # a real mixture
    # The store's host-side mixture reads on the same ring.
    key = jax.random.PRNGKey(15)
    jparams, jversions = ja.store.sample(key, 6)
    params, versions = ta.store.sample(JaxDraws(key, "pendulum"), 6)
    assert np.array_equal(versions, jversions)
    _close_trees(params, jparams, 0)
    assert np.array_equal(ta.store.versions_of_slots(slots),
                          ja.store.versions_of_slots(jslots))


@pytest.fixture(scope="module")
def phase_batch():
    """A collected mixture batch with log_beta 0.3 nats off (the VACO
    filter acts) and two episode ends (discounts cut)."""
    ja, _ = _mixture_actors("pendulum")
    jb, _ = ja.collect()
    rng = np.random.default_rng(13)
    log_beta = np.asarray(jb.log_beta) + 0.3 * rng.standard_normal(
        jb.log_beta.shape).astype(np.float32)
    dones = np.asarray(jb.dones).copy()
    dones[0, 5] = dones[2, 11] = True
    return jb._replace(log_beta=jnp.asarray(log_beta),
                       dones=jnp.asarray(dones))


@pytest.mark.parametrize("algorithm", ALGOS)
def test_train_phase_matches_jax(algorithm, phase_batch):
    jb = phase_batch
    jp, p = _policy("pendulum")
    kw = dict(algorithm=algorithm, num_epochs=2, num_minibatches=4,
              total_phases=10, kl_coef=1.0, entropy_coef=0.01)
    key = jax.random.PRNGKey(14)
    jstate = jax_init_state(jp)._replace(phase=jnp.asarray(3, jnp.int32))
    jstate, jm = jax_train_phase(JHyperparams(**kw))(jstate, jb, key,
                                                      weight=0.7)
    state = init_train_state(p)._replace(phase=3)
    state, m = make_train_phase(RLHyperparams(**kw))(
        state, _jax_batch_to_torch(jb), JaxDraws(key, "pendulum"),
        weight=0.7)
    assert set(m) == set(jm)
    for k in m:
        _close(np.float32(m[k]), jm[k], 1e-5, rel=True)
    assert m["grad_norm"] > 0
    if algorithm == "vaco":
        assert 0 < m["frac_filtered"] < 1
    _close_trees(state.params, jstate.params, 1e-4)
    assert state.phase == int(jstate.phase) == 4


def test_schedules_match_jax():
    from repro.optim.schedule import constant_schedule as jax_constant
    from repro.optim.schedule import linear_anneal as jax_anneal
    from repro_torch.optim import constant_schedule, linear_anneal

    for step in (0, 3, 7, 12):
        _close(linear_anneal(10, floor=0.1)(step),
               jax_anneal(10, floor=0.1)(step), 0)
        _close(constant_schedule()(step), jax_constant()(step), 0)


# ---------------------------------------------------------------------------
# The runner and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("controller", [
    None, "tv_gate:delta=0.002,mode=downweight"])
def test_run_async_rl_matches_jax(controller):
    """pendulum, VACO, backward_mixture, K=4, 2 phases; by default and
    with the TV gate scoring each item against the store's latest
    policy.  A 10x learning rate moves the policy enough in one phase
    that the gate downweights the lag-1 item (TV ~2e-3 > delta / 2)."""
    kw = dict(env_name="pendulum", algorithm="vaco", buffer_capacity=4,
              n_actors=4, rollout_steps=16, total_phases=2, eval_episodes=4,
              seed=0, controller=controller)
    hp = dict(num_epochs=2, num_minibatches=4, lr=3e-3)
    jres = jax_run_async_rl(JRunConfig(**kw, hp=JHyperparams(**hp)))
    jparams = jax_policy_init(jax.random.split(jax.random.PRNGKey(0), 3)[0],
                              3, 1)
    res = run_async_rl(
        AsyncRLRunConfig(**kw, hp=RLHyperparams(**hp), device="cpu"),
        params=from_jax_params(jax.tree.map(np.asarray, jparams)),
        make_draws=lambda seed, dev: JaxDraws(jax.random.PRNGKey(seed),
                                              "pendulum"))
    assert len(res.returns) == len(jres.returns) == 2
    _close(np.array(res.returns), np.array(jres.returns), 1e-4, rel=True)
    for m, jm in zip(res.metrics, jres.metrics):
        assert set(m) == set(jm)
        for k in m:
            _close(np.float64(m[k]), jm[k], 1e-4, rel=True)
    _close(np.float64(res.final_tv), jres.final_tv, 1e-4)
    assert res.runtime_stats == jres.runtime_stats
    if controller:
        queue = res.runtime_stats["queue"]
        assert queue["downweighted"] >= 1, queue
        assert 0.3 < res.metrics[1]["item_weight"] < 0.7


def test_run_grid_scores_the_mean_of_the_last_returns():
    from repro_torch.train import run_grid

    kw = dict(n_actors=4, rollout_steps=8, total_phases=4, eval_episodes=2,
              device="cpu", hp=RLHyperparams(num_epochs=1,
                                             num_minibatches=2))
    out = run_grid(["pendulum"], ["vaco"], [2], [0, 1], **kw)
    assert set(out) == {"vaco"} and set(out["vaco"]) == {2}
    assert out["vaco"][2].shape == (1, 2)
    res = run_async_rl(AsyncRLRunConfig(
        env_name="pendulum", algorithm="vaco", buffer_capacity=2, seed=1,
        **kw))
    assert out["vaco"][2][0, 1] == np.float64(np.mean(res.returns[-3:]))


def test_launcher_trains_rl_on_the_cpu(capsys):
    from repro_torch.launch import train

    assert train.main(["rl", "--device", "cpu", "--n-actors", "4",
                       "--rollout-steps", "8", "--phases", "2",
                       "--buffer-capacity", "2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"runtime", "returns", "final_tv",
                           "runtime_stats"}
    assert report["runtime"] == "backward_mixture"
    assert len(report["returns"]) == 2
    assert report["runtime_stats"]["policy_version"] == 2


@pytest.mark.parametrize("env_name,algorithm", list(zip(ENVS, ALGOS)))
def test_launcher_takes_every_env_and_algorithm(env_name, algorithm,
                                                capsys):
    from repro_torch.launch import train

    assert train.main(["rl", "--device", "cpu", "--env", env_name,
                       "--algorithm", algorithm, "--n-actors", "4",
                       "--rollout-steps", "8", "--phases", "1",
                       "--runtime", "forward_n"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert np.isfinite(report["returns"]).all()
