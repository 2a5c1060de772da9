"""AdamW (port of ``repro.optim.adamw``).

Moments are float32 whatever the parameter dtype; the bias correction is
the reference's ``1 - b**t`` in float32.  The update is functional, as in
JAX: it returns new parameter and moment tensors and never writes the
ones it was given, so a state kept by a caller (the trainer's
finiteness guard) stays as it was.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: Any              # first moment, float32 tree
    v: Any              # second moment, float32 tree


def adamw_init(params: Any) -> AdamWState:
    """Fresh zero moments (new tensors; nothing shared with ``params``)."""
    leaf = tree_leaves(params)[0]
    zeros32 = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                    device=x.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        m=tree_map(zeros32, params), v=tree_map(zeros32, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig, lr_scale: float = 1.0):
    """One AdamW step; returns ``(new_params, new_state)``."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    m = tree_map(lambda m_, g: b1 * m_ + (1.0 - b1) * g.float(),
                 state.m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1.0 - b2) * g.float() * g.float(),
                 state.v, grads)
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)
    lr = cfg.lr * lr_scale

    def upd_p(p, m_, v_):
        update = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
        if cfg.weight_decay > 0.0:
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype)

    new_params = tree_map(upd_p, params, m, v)
    return new_params, AdamWState(step=step, m=m, v=v)
