"""Five continuous-control environments, batched over ``N`` envs (port of
``repro.envs.classic``).

pendulum         1-act swing-up, dense cost            (obs 3)
cartpole_swingup 1-act cart + pole swing-up            (obs 5)
acrobot          1-act two-link underactuated swing-up (obs 6)
pointmass        2-act double integrator to random goal (obs 6)
reacher          2-act two-link arm to random target    (obs 8)

The dynamics are the JAX package's, written over a leading batch axis:
explicit Euler at fixed dt, clipped torques, float32.  Resets read their
standard draws (``envs.base``) in the order the JAX resets split their
keys, and scale them as ``jax.random.uniform`` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.envs.base import Env, Timestep, angle_normalize


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(key, minval=lo, maxval=hi)`` from its standard
    draw ``u``: ``max(lo, u * (hi - lo) + lo)`` with the bounds in
    float32."""
    lo32 = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi32 = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo32, u * (hi32 - lo32) + lo32)


def _zeros(draws: torch.Tensor, *shape: int) -> torch.Tensor:
    return torch.zeros((draws.shape[0], *shape), dtype=torch.float32,
                       device=draws.device)


def _timestep(obs, reward, done=None) -> Timestep:
    n = reward.shape[0]
    if done is None:
        done = torch.zeros(n, dtype=torch.bool, device=reward.device)
    return Timestep(obs=obs, reward=reward, done=done,
                    info_steps=torch.zeros(n, dtype=torch.int32,
                                           device=reward.device))


# ---------------------------------------------------------------------------
# Pendulum swing-up
# ---------------------------------------------------------------------------


class PendulumState(NamedTuple):
    th: torch.Tensor
    thdot: torch.Tensor


def make_pendulum(max_steps: int = 200) -> Env:
    g, m, l, dt = 10.0, 1.0, 1.0, 0.05
    max_torque, max_speed = 2.0, 8.0

    def observe(s: PendulumState):
        return torch.stack([torch.cos(s.th), torch.sin(s.th),
                            s.thdot / max_speed], dim=-1)

    def reset(draws):
        return PendulumState(th=_uniform(draws[:, 0], -math.pi, math.pi),
                             thdot=_uniform(draws[:, 1], -1.0, 1.0))

    def step(s: PendulumState, action, draws):
        u = torch.clamp(action[:, 0], -1.0, 1.0) * max_torque
        cost = (
            angle_normalize(s.th) ** 2
            + 0.1 * s.thdot**2
            + 0.001 * u**2
        )
        thdot = s.thdot + (
            3.0 * g / (2.0 * l) * torch.sin(s.th)
            + 3.0 / (m * l**2) * u
        ) * dt
        thdot = torch.clamp(thdot, -max_speed, max_speed)
        th = s.th + thdot * dt
        ns = PendulumState(th=th, thdot=thdot)
        return ns, _timestep(observe(ns), -cost)

    return Env("pendulum", 3, 1, max_steps, reset, step, observe,
               ("uniform", "uniform"))


# ---------------------------------------------------------------------------
# CartPole swing-up (continuous force)
# ---------------------------------------------------------------------------


class CartPoleState(NamedTuple):
    x: torch.Tensor
    xdot: torch.Tensor
    th: torch.Tensor
    thdot: torch.Tensor


def make_cartpole_swingup(max_steps: int = 250) -> Env:
    g, mc, mp, l, dt = 9.8, 1.0, 0.1, 0.5, 0.02
    force_mag, x_lim = 10.0, 2.4

    def observe(s: CartPoleState):
        return torch.stack(
            [s.x / x_lim, s.xdot / 5.0, torch.cos(s.th), torch.sin(s.th),
             s.thdot / 10.0], dim=-1)

    def reset(draws):
        th = math.pi + 0.1 * draws[:, 0]   # hanging down
        x = 0.2 * draws[:, 1]
        return CartPoleState(x=x, xdot=_zeros(draws), th=th,
                             thdot=_zeros(draws))

    def step(s: CartPoleState, action, draws):
        f = torch.clamp(action[:, 0], -1.0, 1.0) * force_mag
        sin, cos = torch.sin(s.th), torch.cos(s.th)
        total_m = mc + mp
        tmp = (f + mp * l * s.thdot**2 * sin) / total_m
        thacc = (g * sin - cos * tmp) / (
            l * (4.0 / 3.0 - mp * cos**2 / total_m)
        )
        xacc = tmp - mp * l * thacc * cos / total_m
        x = s.x + dt * s.xdot
        xdot = torch.clamp(s.xdot + dt * xacc, -5.0, 5.0)
        th = s.th + dt * s.thdot
        thdot = torch.clamp(s.thdot + dt * thacc, -10.0, 10.0)
        ns = CartPoleState(x=x, xdot=xdot, th=th, thdot=thdot)
        # Upright bonus minus control / off-center penalty.
        reward = torch.cos(th) - 0.05 * (x / x_lim) ** 2 - 0.001 * f**2
        return ns, _timestep(observe(ns), reward, torch.abs(x) > x_lim)

    return Env("cartpole_swingup", 5, 1, max_steps, reset, step, observe,
               ("normal", "normal"))


# ---------------------------------------------------------------------------
# Acrobot swing-up (continuous torque)
# ---------------------------------------------------------------------------


class AcrobotState(NamedTuple):
    th1: torch.Tensor
    th2: torch.Tensor
    dth1: torch.Tensor
    dth2: torch.Tensor


def make_acrobot(max_steps: int = 250) -> Env:
    m1 = m2 = 1.0
    l1 = 1.0
    lc1 = lc2 = 0.5
    i1 = i2 = 1.0
    g, dt, max_torque = 9.8, 0.05, 2.0

    def observe(s: AcrobotState):
        return torch.stack(
            [torch.cos(s.th1), torch.sin(s.th1), torch.cos(s.th2),
             torch.sin(s.th2), s.dth1 / (4.0 * math.pi),
             s.dth2 / (9.0 * math.pi)], dim=-1)

    def reset(draws):
        vals = _uniform(draws, -0.1, 0.1)
        return AcrobotState(th1=vals[:, 0], th2=vals[:, 1], dth1=vals[:, 2],
                            dth2=vals[:, 3])

    def step(s: AcrobotState, action, draws):
        tau = torch.clamp(action[:, 0], -1.0, 1.0) * max_torque
        d1 = (
            m1 * lc1**2
            + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(s.th2))
            + i1 + i2
        )
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(s.th2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(s.th1 + s.th2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * s.dth2**2 * torch.sin(s.th2)
            - 2 * m2 * l1 * lc2 * s.dth2 * s.dth1 * torch.sin(s.th2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(s.th1 - math.pi / 2.0)
            + phi2
        )
        ddth2 = (
            tau + d2 / d1 * phi1
            - m2 * l1 * lc2 * s.dth1**2 * torch.sin(s.th2) - phi2
        ) / (m2 * lc2**2 + i2 - d2**2 / d1)
        ddth1 = -(d2 * ddth2 + phi1) / d1
        dth1 = torch.clamp(s.dth1 + dt * ddth1, -4 * math.pi, 4 * math.pi)
        dth2 = torch.clamp(s.dth2 + dt * ddth2, -9 * math.pi, 9 * math.pi)
        ns = AcrobotState(
            th1=angle_normalize(s.th1 + dt * dth1),
            th2=angle_normalize(s.th2 + dt * dth2),
            dth1=dth1,
            dth2=dth2,
        )
        # Tip height in [-2, 2]; dense shaping toward swing-up.
        height = -torch.cos(ns.th1) - torch.cos(ns.th1 + ns.th2)
        reward = 0.5 * height - 0.001 * tau**2
        return ns, _timestep(observe(ns), reward)

    return Env("acrobot", 6, 1, max_steps, reset, step, observe,
               ("uniform",) * 4)


# ---------------------------------------------------------------------------
# Point-mass goal reaching (double integrator)
# ---------------------------------------------------------------------------


class PointMassState(NamedTuple):
    pos: torch.Tensor   # [N, 2]
    vel: torch.Tensor   # [N, 2]
    goal: torch.Tensor  # [N, 2]


def make_pointmass(max_steps: int = 150) -> Env:
    dt, max_force, arena = 0.05, 1.0, 2.0

    def observe(s: PointMassState):
        return torch.cat([s.pos / arena, s.vel, (s.goal - s.pos) / arena],
                         dim=-1)

    def reset(draws):
        return PointMassState(pos=_uniform(draws[:, 0:2], -arena, arena),
                              vel=_zeros(draws, 2),
                              goal=_uniform(draws[:, 2:4], -arena, arena))

    def step(s: PointMassState, action, draws):
        f = torch.clamp(action, -1.0, 1.0) * max_force
        vel = torch.clamp(s.vel + dt * f - 0.02 * s.vel, -2.0, 2.0)
        pos = torch.clamp(s.pos + dt * vel, -arena, arena)
        ns = PointMassState(pos=pos, vel=vel, goal=s.goal)
        dist = torch.linalg.vector_norm(s.goal - pos, dim=-1)
        reward = (-dist - 0.01 * torch.sum(f**2, dim=-1)
                  + torch.where(dist < 0.1, 1.0, 0.0))
        return ns, _timestep(observe(ns), reward)

    return Env("pointmass", 6, 2, max_steps, reset, step, observe,
               ("uniform",) * 4)


# ---------------------------------------------------------------------------
# Two-link reacher
# ---------------------------------------------------------------------------


class ReacherState(NamedTuple):
    th: torch.Tensor      # [N, 2]
    thdot: torch.Tensor   # [N, 2]
    target: torch.Tensor  # [N, 2]


def make_reacher(max_steps: int = 100) -> Env:
    l1, l2, dt, max_torque = 0.1, 0.11, 0.02, 1.0

    def _tip(th):
        x = l1 * torch.cos(th[:, 0]) + l2 * torch.cos(th[:, 0] + th[:, 1])
        y = l1 * torch.sin(th[:, 0]) + l2 * torch.sin(th[:, 0] + th[:, 1])
        return torch.stack([x, y], dim=-1)

    def observe(s: ReacherState):
        return torch.cat(
            [torch.cos(s.th), torch.sin(s.th), s.thdot / 10.0,
             (s.target - _tip(s.th)) * 5.0], dim=-1)

    def reset(draws):
        th = _uniform(draws[:, 0:2], -math.pi, math.pi)
        r = _uniform(draws[:, 2], 0.05, l1 + l2 - 0.01)
        ang = _uniform(draws[:, 3], -math.pi, math.pi)
        target = r[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)],
                                          dim=-1)
        return ReacherState(th=th, thdot=_zeros(draws, 2), target=target)

    def step(s: ReacherState, action, draws):
        tau = torch.clamp(action, -1.0, 1.0) * max_torque
        thdot = torch.clamp(s.thdot + dt * (tau * 40.0 - 1.0 * s.thdot),
                            -10.0, 10.0)
        th = s.th + dt * thdot
        ns = ReacherState(th=th, thdot=thdot, target=s.target)
        dist = torch.linalg.vector_norm(s.target - _tip(th), dim=-1)
        reward = -dist - 0.01 * torch.sum(tau**2, dim=-1)
        return ns, _timestep(observe(ns), reward)

    return Env("reacher", 8, 2, max_steps, reset, step, observe,
               ("uniform",) * 4)


ENV_MAKERS = {
    "pendulum": make_pendulum,
    "cartpole_swingup": make_cartpole_swingup,
    "acrobot": make_acrobot,
    "pointmass": make_pointmass,
    "reacher": make_reacher,
}


def make_env(name: str, **kwargs) -> Env:
    return ENV_MAKERS[name](**kwargs)
