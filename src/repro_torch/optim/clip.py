"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.utils.tree import tree_global_norm, tree_map


@torch.no_grad()
def global_norm_clip_scale(grads: Any, max_norm: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale, pre_clip_norm)``: the factor that brings the global L2
    norm of ``grads`` to at most ``max_norm`` (the norm floored at 1e-12
    before the division, as in the reference)."""
    norm = tree_global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                       max=1.0), norm


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled so their global L2 norm is at most ``max_norm``;
    returns ``(clipped_grads, pre_clip_norm)``."""
    scale, norm = global_norm_clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
