"""Parameter bridge between the JAX reference and the port.

The JAX side hands over a numpy copy of its params
(``jax.tree.map(np.asarray, params)``, made by the caller); the port
never imports JAX.  Names, nesting and the ``[L]`` layer stacking are
kept, so ``to_numpy(from_jax_params(tree, ...))`` gives the tree back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def from_jax_params(tree: Any, device: Any = "cpu",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":          # ml_dtypes has no torch twin
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(params: Any) -> Any:
    """Nested dicts of tensors -> the same dicts of numpy arrays."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


__all__ = ["from_jax_params", "to_numpy"]
