"""AdamW (port of ``repro.optim.adamw``).

Moments are float32 whatever the parameter dtype; the bias correction is
the reference's ``1 - b**t`` in float32.  The update is functional, as in
JAX: it returns new parameter and moment tensors and never writes the
ones it was given, so a state kept by a caller (the trainer's
finiteness guard) stays as it was.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

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
                 cfg: AdamWConfig, lr_scale: float = 1.0,
                 grad_scale: Optional[torch.Tensor] = None):
    """One AdamW step; returns ``(new_params, new_state)``.
    ``grad_scale`` (a float32 scalar, e.g. the global-norm clip's) scales
    each gradient leaf as it is read, with the same arithmetic as
    scaling the tree first, but no scaled copy of the tree is ever held
    (one params' worth of memory at the learner's peak)."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2

    def g32(g):
        return (g if grad_scale is None
                else g * grad_scale.to(g.dtype)).float()

    # Each leaf's terms are formed as in the reference and summed in
    # place into the new tensor, so no more than two leaf-sized
    # temporaries live at once: at full-width hymba the largest leaf is
    # over 1 GiB, and the step runs with the card nearly full.
    def upd_m(m_, g):
        m = m_ * b1
        return m.add_(g32(g) * (1.0 - b1))

    def upd_v(v_, g):
        g = g32(g)
        gg = g * (1.0 - b2)
        gg.mul_(g)
        del g
        v = v_ * b2
        return v.add_(gg)

    m = tree_map(upd_m, state.m, grads)
    v = tree_map(upd_v, state.v, grads)
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)
    lr = cfg.lr * lr_scale

    def upd_p(p, m_, v_):
        den = v_ / bc2
        den.sqrt_().add_(cfg.eps)
        update = m_ / bc1
        update.div_(den)
        del den
        if cfg.weight_decay > 0.0:
            update.add_(cfg.weight_decay * p.float())
        # p - lr * u as p + (-(lr * u)): the same float32 result.
        return update.mul_(-lr).add_(p.float()).to(p.dtype)

    new_params = tree_map(upd_p, params, m, v)
    return new_params, AdamWState(step=step, m=m, v=v)
