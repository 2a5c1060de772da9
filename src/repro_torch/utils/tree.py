"""Tree helpers over the port's parameter trees (nested dicts of tensors;
port of the parts of ``repro.utils.tree`` the learner needs).

``tree_map`` and ``tree_leaves`` walk dicts in insertion order.  The
``*_with_path`` helpers follow ``jax.tree_util.tree_flatten`` instead:
dict keys sorted, NamedTuple fields in order, and each leaf named by
``jax.tree_util.keystr``'s string (``['a']['b']``,
``['opt_state'].m['w']``), so a fault or a checkpoint picks the leaf the
JAX package would.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

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


def tree_leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in ``jax.tree_util`` flatten order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name in tree._fields
                for pair in tree_leaves_with_path(getattr(tree, name),
                                                  f"{path}.{name}")]
    return [(path, tree)]


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       path: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, keeping the structure (paths as
    :func:`tree_leaves_with_path` names them)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, name),
                                               f"{path}.{name}")
                            for name in tree._fields))
    return fn(path, tree)


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


__all__ = ["tree_global_norm", "tree_grads", "tree_leaves",
           "tree_leaves_with_path", "tree_map", "tree_map_with_path",
           "tree_to", "tree_trainable"]
