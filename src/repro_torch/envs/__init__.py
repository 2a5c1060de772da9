"""Batched continuous-control environments of the classic-RL path (port of
``repro.envs``; the observation/reward normalisers of
``repro.envs.normalize`` are not ported)."""
from repro_torch.envs.base import (AutoResetState, Env, Timestep,
                                   angle_normalize, wrap_autoreset)
from repro_torch.envs.classic import (ENV_MAKERS, make_acrobot,
                                      make_cartpole_swingup, make_env,
                                      make_pendulum, make_pointmass,
                                      make_reacher)

__all__ = [
    "AutoResetState", "Env", "Timestep", "angle_normalize", "wrap_autoreset",
    "ENV_MAKERS", "make_env", "make_pendulum", "make_cartpole_swingup",
    "make_acrobot", "make_pointmass", "make_reacher",
]
