"""Classic-RL trainer: VACO vs PPO / PPO-KL / SPO / IMPALA (§5.1), port of
``repro.train.trainer_rl``.

One ``train_phase`` per algorithm, following the paper's protocol and
Table 1 hyper-parameters:

    collect (mixture actors) -> estimate advantages ONCE (algorithm-
    specific) -> num_epochs x num_minibatches SGD -> publish policy.

Algorithm-specific advantage paths:
* ``vaco``    V-trace realigned to pi_T (Eqs. 14-15), computed once per
              phase; TV-filtered loss (Alg. 1).
* ``ppo``     GAE on the behavior data + clipped surrogate.
* ``ppo_kl``  ppo + KL penalty coefficient (the Fig. 3 baselines).
* ``spo``     GAE + squared-TV penalty, no clip (Xie et al., 2025).
* ``impala``  V-trace RE-ESTIMATED against the current policy at every
              minibatch update (the costly path of Fig. 2 bottom).

Both V-trace passes go through ``kernels.ops.vtrace``: the hand-written
CUDA kernel on the card, the plain version on the CPU.  The JAX
``lax.scan`` over epochs x minibatches is a loop; each ``stop_gradient``
is a ``.detach()`` (or a ``no_grad`` block) in the same place.  The
update is functional, as in JAX: new parameter and moment tensors each
step, nothing written in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.gae import gae, normalize_advantages
from repro_torch.core.losses import (IMPALAConfig, PPOConfig, SPOConfig,
                                     VACOConfig, impala_total_loss,
                                     ppo_total_loss, spo_total_loss,
                                     vaco_total_loss)
from repro_torch.core.vtrace import VTraceOutput, vtrace_impala_pg_advantage
from repro_torch.kernels import ops as kops
from repro_torch.models.mlp_policy import policy_dist, value_fn
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, clip_by_global_norm,
                               linear_anneal)
from repro_torch.rollout.env_rollout import Draws, RolloutBatch
from repro_torch.utils.tree import tree_grads, tree_trainable


@dataclass(frozen=True)
class RLHyperparams:
    """Table 1 defaults (CleanRL); the runner sets the scale."""

    algorithm: str = "vaco"
    gamma: float = 0.99
    gae_lambda: float = 0.95
    vtrace_lambda: float = 1.0
    rho_bar: float = 1.0
    c_bar: float = 1.0
    delta: float = 0.2           # clip ratio / TV threshold
    kl_coef: float = 0.0         # ppo_kl
    spo_coef: float = 20.0
    entropy_coef: float = 0.0
    value_coef: float = 0.5
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    num_epochs: int = 10
    num_minibatches: int = 32
    total_phases: int = 100      # for LR annealing
    normalize_adv: bool = True   # PPO-family minibatch normalization
    realign: bool = True         # Fig. 12 ablation: False => GAE advantages
                                 # on behavioral data + TV filter only


class RLTrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    phase: int   # phase counter for LR annealing


def init_train_state(params: Any) -> RLTrainState:
    return RLTrainState(params=params, opt_state=adamw_init(params), phase=0)


def _log_pi_and_entropy(params, obs, actions):
    dist = policy_dist(params, obs)
    return dist.log_prob(actions), dist.entropy()


def _discounts(hp: RLHyperparams, batch: RolloutBatch) -> torch.Tensor:
    return hp.gamma * (1.0 - batch.dones.float())


def _vtrace(hp: RLHyperparams, log_ratios, values, bootstrap, rewards,
            discounts) -> VTraceOutput:
    """V-trace through ``kernels.ops`` (no gradient: every caller treats
    the outputs as constants)."""
    vs, adv = kops.vtrace(log_ratios, values, bootstrap, rewards, discounts,
                          rho_bar=hp.rho_bar, c_bar=hp.c_bar,
                          lam=hp.vtrace_lambda)
    return VTraceOutput(vs=vs, advantages=adv, clipped_rhos=None)


@torch.no_grad()
def _phase_advantages(hp: RLHyperparams, params, batch: RolloutBatch):
    """Advantage/value-target estimation at phase start (once).  The
    trainer detaches both (``stop_gradient`` in JAX), so they are
    computed without a graph."""
    values = value_fn(params, batch.obs)                      # [N, T]
    bootstrap = value_fn(params, batch.final_obs)             # [N]
    discounts = _discounts(hp, batch)
    if hp.algorithm == "vaco" and hp.realign:
        log_pi_T, _ = _log_pi_and_entropy(params, batch.obs, batch.actions)
        out = _vtrace(hp, log_pi_T - batch.log_beta, values, bootstrap,
                      batch.rewards, discounts)
        return out.advantages, out.vs
    # PPO-family: GAE on the behavioral data.
    out = gae(values=values, bootstrap_value=bootstrap,
              rewards=batch.rewards, discounts=discounts, lam=hp.gae_lambda)
    return out.advantages, out.returns


TrainPhase = Callable[..., Tuple[RLTrainState, Dict[str, float]]]


def make_train_phase(hp: RLHyperparams) -> TrainPhase:
    """The phase update for ``hp.algorithm``:
    ``train_phase(state, batch, draws, weight=1.0) -> (state, metrics)``,
    with ``draws.permutations`` giving each epoch's minibatch order."""
    opt_cfg = AdamWConfig(lr=hp.lr, eps=1e-5)
    lr_schedule = linear_anneal(hp.total_phases, floor=0.0)

    vaco_cfg = VACOConfig(delta=hp.delta, entropy_coef=hp.entropy_coef,
                          value_coef=hp.value_coef)
    ppo_cfg = PPOConfig(clip_low=hp.delta, clip_high=hp.delta,
                        kl_coef=hp.kl_coef if hp.algorithm == "ppo_kl"
                        else 0.0,
                        entropy_coef=hp.entropy_coef,
                        value_coef=hp.value_coef)
    spo_cfg = SPOConfig(penalty_coef=hp.spo_coef,
                        entropy_coef=hp.entropy_coef,
                        value_coef=hp.value_coef)
    impala_cfg = IMPALAConfig(entropy_coef=hp.entropy_coef,
                              value_coef=hp.value_coef,
                              rho_bar_pg=hp.rho_bar)

    @torch.no_grad()
    def impala_targets(params, full_batch: RolloutBatch):
        """IMPALA's per-update V-trace against the CURRENT policy on the
        full batch, flattened to ``[N * T]``.  JAX runs the plain
        ``core.vtrace`` here (autodiff-able) but stop-gradients both
        outputs, so the kernel computes the same function."""
        full_values = value_fn(params, full_batch.obs)
        full_boot = value_fn(params, full_batch.final_obs)
        discounts = _discounts(hp, full_batch)
        full_log_pi, _ = _log_pi_and_entropy(params, full_batch.obs,
                                             full_batch.actions)
        log_ratios = full_log_pi - full_batch.log_beta
        out = _vtrace(hp, log_ratios, full_values, full_boot,
                      full_batch.rewards, discounts)
        pg_adv = vtrace_impala_pg_advantage(
            out, rewards=full_batch.rewards, discounts=discounts,
            values=full_values, bootstrap_value=full_boot,
            rho_bar_pg=hp.rho_bar, log_ratios=log_ratios)
        return pg_adv.reshape(-1), out.vs.reshape(-1)

    def minibatch_loss(params, mb, full_batch):
        """mb: dict of flat [M, ...] slices."""
        log_pi, entropy = _log_pi_and_entropy(params, mb["obs"],
                                              mb["actions"])
        values = value_fn(params, mb["obs"])

        if hp.algorithm == "vaco":
            return vaco_total_loss(
                log_pi=log_pi, log_beta=mb["log_beta"],
                advantages=mb["advantages"] * mb["weight"], values=values,
                value_targets=mb["value_targets"], cfg=vaco_cfg)
        if hp.algorithm in ("ppo", "ppo_kl"):
            adv = mb["advantages"]
            if hp.normalize_adv:
                adv = normalize_advantages(adv)
            return ppo_total_loss(
                log_pi=log_pi, log_beta=mb["log_beta"],
                advantages=adv * mb["weight"], values=values,
                value_targets=mb["value_targets"], entropy=entropy,
                cfg=ppo_cfg)
        if hp.algorithm == "spo":
            adv = mb["advantages"]
            if hp.normalize_adv:
                adv = normalize_advantages(adv)
            return spo_total_loss(
                log_pi=log_pi, log_beta=mb["log_beta"],
                advantages=adv * mb["weight"], values=values,
                value_targets=mb["value_targets"], entropy=entropy,
                cfg=spo_cfg)
        if hp.algorithm == "impala":
            pg_adv, vs = impala_targets(params, full_batch)
            idx = mb["flat_idx"]
            return impala_total_loss(
                log_pi=log_pi, log_beta=mb["log_beta"],
                pg_advantages=pg_adv[idx] * mb["weight"], values=values,
                value_targets=vs[idx], entropy=entropy, cfg=impala_cfg)
        raise ValueError(hp.algorithm)

    def train_phase(state: RLTrainState, batch: RolloutBatch, draws: Draws,
                    weight: float = 1.0):
        """One phase update.  ``weight`` scales the policy-gradient
        advantages: 1.0 normally; <1 when the runtime's admission policy
        downweighted the trajectory item instead of dropping it."""
        advantages, value_targets = _phase_advantages(hp, state.params,
                                                      batch)
        n, t = batch.rewards.shape
        dev = batch.rewards.device
        flat = lambda x: x.reshape(n * t, *x.shape[2:])
        data = {
            "obs": flat(batch.obs),
            "actions": flat(batch.actions),
            "log_beta": flat(batch.log_beta),
            "advantages": flat(advantages),
            "value_targets": flat(value_targets),
            "flat_idx": torch.arange(n * t, device=dev),
            "weight": torch.full((n * t,), float(weight),
                                 dtype=torch.float32, device=dev),
        }
        mb_size = (n * t) // hp.num_minibatches
        lr_scale = lr_schedule(state.phase)
        perms = draws.permutations(hp.num_epochs, n * t).to(dev)
        perms = perms[:, : mb_size * hp.num_minibatches].reshape(
            hp.num_epochs, hp.num_minibatches, mb_size)

        params, opt_state = state.params, state.opt_state
        auxs = []
        for idx in perms.reshape(-1, mb_size):
            mb = {k: v[idx] for k, v in data.items()}
            trainable = tree_trainable(params)
            with torch.enable_grad():
                loss, aux = minibatch_loss(trainable, mb, batch)
                grads = tree_grads(loss, trainable)
            grads, gnorm = clip_by_global_norm(grads, hp.max_grad_norm)
            params, opt_state = adamw_update(grads, opt_state, params,
                                             opt_cfg, lr_scale)
            aux = {k: v.detach() for k, v in aux.items()}
            aux["grad_norm"] = gnorm
            auxs.append(aux)

        names = list(auxs[0])
        means = torch.stack([torch.stack([a[k].float() for a in auxs]).mean()
                             for k in names])
        with torch.no_grad():
            # Final-policy TV vs the behavior data (Fig. 11 diagnostic).
            log_pi, _ = _log_pi_and_entropy(params, batch.obs,
                                            batch.actions)
            final_tv = 0.5 * torch.mean(
                torch.abs(torch.exp(log_pi - batch.log_beta) - 1.0))
            tail = torch.stack([torch.mean(batch.rewards), final_tv])
        # One host read for every metric of the phase.
        values = torch.cat([means, tail]).tolist()
        metrics = dict(zip(names + ["mean_reward", "final_tv"], values))
        new_state = RLTrainState(params=params, opt_state=opt_state,
                                 phase=state.phase + 1)
        return new_state, metrics

    return train_phase
