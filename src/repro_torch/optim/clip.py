"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.utils.tree import tree_global_norm, tree_map


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled so their global L2 norm is at most ``max_norm``;
    returns ``(clipped_grads, pre_clip_norm)``.  The norm is floored at
    1e-12 before the division, as in the reference."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
