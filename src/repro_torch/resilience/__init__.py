"""Resilience hooks, as far as the learner's defaults reach (port of
``repro.resilience``): the finiteness guard's ``tree_all_finite``, an
inert ``FaultInjector`` and the ``RestartContext`` a threaded producer's
loop body takes.

Fault injection and producer supervision are not ported yet: an injector
with a non-empty plan raises.  The inert one keeps the hook surface
the ported runtime calls (``active``, ``stall``, ``poison``,
``crash_if``, ``fired_counts``), so it calls them unconditionally, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_leaves


class FaultInjector:
    """The no-op fault plan: every hook is an early-out."""

    def __init__(self, plan: Any = "", *, seed: int = 0, **_: Any) -> None:
        if plan:
            raise NotImplementedError(
                "fault injection is not ported to the PyTorch runtime yet; "
                "use the repro package for --fault-plan")
        self.events: list = []
        self.seed = int(seed)

    @property
    def active(self) -> bool:
        return False

    def fired_counts(self) -> Dict[str, int]:
        return {}

    def stall(self, site: str, **ctx: Any) -> float:
        return 0.0

    def poison(self, site: str, params: Any, **ctx: Any) -> Tuple[Any, bool]:
        return params, False

    def crash_if(self, site: str, **ctx: Any) -> None:
        pass


NULL_INJECTOR = FaultInjector("")


@dataclasses.dataclass(frozen=True)
class RestartContext:
    """Handed to a producer's loop body on (re)entry (a copy of
    ``repro.resilience.supervision.RestartContext``): ``attempt`` is 0 on
    the first run and n after the n-th restart, which only supervision
    makes."""

    attempt: int = 0
    last_error: Optional[BaseException] = None


def tree_all_finite(tree: Any) -> bool:
    """True iff every floating-point leaf of the tree is fully finite
    (one host sync for the whole tree)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if torch.is_tensor(x) and x.is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


__all__ = ["FaultInjector", "NULL_INJECTOR", "RestartContext",
           "tree_all_finite"]
