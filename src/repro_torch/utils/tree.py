"""Tree helpers over the port's parameter trees (nested dicts of tensors;
port of the parts of ``repro.utils.tree`` the learner needs)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the dicts' insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_to(tree: Any, device: Any) -> Any:
    return tree_map(lambda t: t.to(device), tree)


def tree_global_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm across all leaves (float32 accumulation)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(sq)


__all__ = ["tree_global_norm", "tree_leaves", "tree_map", "tree_to"]
