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


def tree_trainable(params: Any) -> Any:
    """Leaves that share the params' storage and track gradients."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def tree_grads(loss: torch.Tensor, params: Any) -> Any:
    """``d loss / d params`` as a tree; leaves the loss does not reach get
    zeros, as ``jax.grad`` gives them."""
    leaves = tree_leaves(params)
    flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(flat, leaves))
    return tree_map(lambda _: next(it), params)


def tree_global_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm across all leaves (float32 accumulation)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(sq)


__all__ = ["tree_global_norm", "tree_grads", "tree_leaves", "tree_map",
           "tree_to", "tree_trainable"]
