"""Learning-rate schedules, as step -> lr_scale callables (port of the
parts of ``repro.optim.schedule`` the trainers use).

Scales multiply ``AdamWConfig.lr``; the classic-RL setup uses
``linear_anneal`` (CleanRL's "Learning Rate Annealing = True", Table 1).
Each returns a 0-d float32 tensor, as the JAX schedules return a float32
array.
"""
from __future__ import annotations

import torch


def constant_schedule():
    def f(step):
        return torch.ones((), dtype=torch.float32)

    return f


def linear_anneal(total_steps: int, floor: float = 0.0):
    def f(step):
        t = (torch.as_tensor(step, dtype=torch.float32)
             / float(max(total_steps, 1)))
        return torch.clamp(1.0 - t, min=floor)

    return f
