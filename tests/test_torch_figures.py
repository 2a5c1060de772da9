"""Port vs JAX: the paper's figure harnesses on the CPU.

* ``metrics.aggregate`` against ``repro.metrics.aggregate`` on seeded
  matrices: exactly equal (the same numpy code, the same
  ``default_rng(seed)`` bootstrap draws);
* ``configs.hparams``'s Table 1 / Table 2 against the reference's: equal
  fields;
* fig3's ``run`` on pendulum x {vaco, ppo} x K 4 x 2 seeds x 2 phases at
  4 actors x 16 steps against ``benchmarks.fig3_backward_lag.run``, the
  JAX key chain replayed (``JaxDraws``) and the JAX init bridged: raw
  scores within 1e-4 relative, as ``test_torch_rl.py``'s whole runs;
  the normalized aggregates (rounded to 4 decimals by both) within 2e-4;
* every runner's ``main`` on a tiny grid writing its reference's JSON
  keys (the keys each reference ``main`` writes, spelled out below).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import hparams as jax_hparams
from repro.metrics import aggregate as jax_aggregate
from repro.models.mlp_policy import mlp_policy_init as jax_policy_init
from repro_torch.configs import hparams
from repro_torch.metrics import aggregate
from repro_torch.utils.bridge import from_jax_params

from test_torch_rl import JaxDraws

torch.set_num_threads(1)


def _scores(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("shape", [(1, 2), (3, 5), (5, 3)])
def test_aggregates_equal_the_reference(shape):
    by_alg = {a: _scores(i, shape) for i, a in enumerate(("vaco", "ppo",
                                                          "spo"))}
    got = aggregate.minmax_normalize(by_alg)
    want = jax_aggregate.minmax_normalize(by_alg)
    for a in by_alg:
        np.testing.assert_array_equal(got[a], want[a])
    x = by_alg["vaco"]
    for name in ("iqm", "median", "mean", "optimality_gap"):
        assert getattr(aggregate, name)(x) == getattr(jax_aggregate, name)(x)
    assert aggregate.stratified_bootstrap_ci(
        x, aggregate.iqm, n_boot=200, seed=3) == \
        jax_aggregate.stratified_bootstrap_ci(
            x, jax_aggregate.iqm, n_boot=200, seed=3)
    assert aggregate.aggregate_metrics(by_alg, n_boot=100, seed=1) == \
        jax_aggregate.aggregate_metrics(by_alg, n_boot=100, seed=1)
    assert aggregate.aggregate_metrics(by_alg, normalize=False,
                                       n_boot=50) == \
        jax_aggregate.aggregate_metrics(by_alg, normalize=False, n_boot=50)
    curve = _scores(9, (4, shape[1] + 2))
    np.testing.assert_array_equal(aggregate.auc(curve),
                                  jax_aggregate.auc(curve))
    np.testing.assert_array_equal(aggregate.auc(curve, axis=0),
                                  jax_aggregate.auc(curve, axis=0))


def _fields(obj):
    return {k: v for k, v in vars(obj).items()}


def test_hparams_tables_equal_the_reference():
    assert hparams.TABLE1_SCALE == jax_hparams.TABLE1_SCALE
    assert hparams.TABLE2_SCALE == jax_hparams.TABLE2_SCALE
    assert _fields(hparams.TABLE1_RL) == _fields(jax_hparams.TABLE1_RL)
    ours, ref = _fields(hparams.TABLE2_RLVR), _fields(jax_hparams.TABLE2_RLVR)
    # The port's RLVRHyperparams has every knob of the reference's.
    assert set(ours) == set(ref)
    assert ours == {k: ref[k] for k in ours}
    assert hparams.TABLE2_RLVR.algorithm == "grpo_vaco"
    assert hparams.TABLE2_RLVR.max_new_tokens == 512


def _jax_params(env_name, seed):
    from repro.envs import make_env

    env = make_env(env_name)
    p = jax_policy_init(jax.random.split(jax.random.PRNGKey(seed), 3)[0],
                        env.obs_dim, env.act_dim)
    return from_jax_params(jax.tree.map(np.asarray, p))


def test_fig3_run_matches_jax():
    from benchmarks.fig3_backward_lag import run as jax_run
    from repro_torch.experiments.fig3_backward_lag import run

    grid = (["pendulum"], ["vaco", "ppo"], [4], [0, 1])
    kw = dict(n_actors=4, rollout_steps=16, phases=2)
    want = jax_run(*grid, **kw)
    got = run(*grid, **kw, device="cpu", params=_jax_params,
              make_draws=lambda seed, dev: JaxDraws(
                  jax.random.PRNGKey(seed), "pendulum"))
    assert set(got) == set(want)
    for alg in grid[1]:
        g = np.array(got["_raw"][alg]["4"])
        w = np.array(want["_raw"][alg]["4"])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
        for metric, (pt, lo, hi) in got["K=4"][alg].items():
            np.testing.assert_allclose(
                [pt, lo, hi], want["K=4"][alg][metric], rtol=0, atol=2e-4)
    # vaco and ppo differ: the grid ran both algorithms.
    assert got["_raw"]["vaco"] != got["_raw"]["ppo"]


def _keys(tree):
    """Nested key structure of a JSON report."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


AGG = {m: None for m in ("median", "iqm", "mean", "optimality_gap")}
FIG5_CELL = {"acc_final_mean": None, "per_seed": None}
# Each reference main's report on the tiny grid given to it below.
RUNNERS = {
    "fig3_backward_lag": (
        ["--envs", "pendulum", "--algorithms", "vaco", "ppo",
         "--capacities", "2", "--seeds", "0", "--phases", "1",
         "--n-actors", "4", "--rollout-steps", "8"],
        {"K=2": {"vaco": AGG, "ppo": AGG},
         "_raw": {"vaco": {"2": None}, "ppo": {"2": None}},
         "_seconds": None}),
    "fig4_sample_efficiency": (
        ["--envs", "pendulum", "--algorithms", "vaco", "ppo",
         "--capacity", "2", "--seeds", "0", "--phases", "2",
         "--n-actors", "4", "--rollout-steps", "8"],
        {a: {"iqm_curve": None, "auc": None} for a in ("vaco", "ppo")}),
    "fig11_tv_tracking": (
        ["--envs", "pendulum", "--capacities", "2", "--seeds", "0",
         "--phases", "1"],
        {a: {"K=2": {"mean_tv": None, "std_tv": None}}
         for a in ("vaco", "ppo", "ppo_kl")}),
    "ablation_delta": (
        ["--deltas", "0.1", "0.4", "--envs", "pendulum", "--capacity", "2",
         "--seeds", "0", "--phases", "1"],
        {f"delta={d}": {"mean_final_tv": None, "raw_scores": None,
                        "iqm": None} for d in (0.1, 0.4)}),
    "ablation_rho": (
        ["--rhos", "1.0", "2.0", "--envs", "pendulum", "--capacity", "2",
         "--seeds", "0", "--phases", "1"],
        {f"rho={r}": {"raw_scores": None, "iqm": None} for r in (1.0, 2.0)}),
    "ablation_realignment": (
        ["--envs", "pendulum", "--capacities", "2", "--seeds", "0",
         "--phases", "1"],
        {"K=2": {"vaco(realigned)": None, "vaco(no-realign)": None}}),
    "fig5_rlvr_forward_lag": (
        ["--minibatches", "1", "--phases", "1", "--warmup-steps", "1"],
        {a: {"N=1": FIG5_CELL} for a in ("grpo", "grpo_vaco")}),
}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_main_writes_the_reference_report(name, tmp_path, capsys):
    import importlib

    argv, keys = RUNNERS[name]
    mod = importlib.import_module(f"repro_torch.experiments.{name}")
    ref = importlib.import_module(f"benchmarks.{name}")
    # The port keeps every flag of its reference and adds --device (and
    # fig5 --full-width).
    ref_flags = {a.dest for a in _parser_actions(ref, capsys)}
    ours = {a.dest for a in _parser_actions(mod, capsys)}
    assert ours - ref_flags == ({"device", "full_width"} if "fig5" in name
                                else {"device"})
    assert ref_flags <= ours
    out = tmp_path / "report.json"
    assert mod.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert _keys(report) == keys
    if name == "fig5_rlvr_forward_lag":
        cell = report["grpo_vaco"]["N=1"]["per_seed"][0]
        assert set(cell) == {"acc_after_warmup", "acc_final",
                             "mean_reward_last", "filter_rate_by_staleness",
                             "tv_by_staleness"}
    flat = json.dumps(report)
    assert "NaN" not in flat and "Infinity" not in flat


def _parser_actions(mod, capsys):
    """The argparse actions ``mod.main`` builds (read off ``--help``)."""
    import argparse

    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        seen.extend(self._actions)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            mod.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    capsys.readouterr()
    return [a for a in seen if a.dest != "help"]
