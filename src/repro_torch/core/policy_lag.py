"""The policy snapshot ring (port of ``repro.core.policy_lag``'s
``PolicyBuffer``, ``buffer_init``, ``buffer_push`` and ``buffer_latest``).

JAX builds a new stacked tree on every push; here the ring is allocated
once, ``[capacity, ...]`` per leaf, and a push **copies** the snapshot
into its slot in place (``copy_``): one params-sized copy per publish.
A snapshot never aliases the learner's tensors, so later updates cannot
rewrite it.  ``buffer_latest`` returns views into the ring; a view stays
valid until ``capacity`` further pushes overwrite its slot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass
class PolicyBuffer:
    stacked: Any       # tree; every leaf has leading dim = capacity
    head: int          # next write position
    count: int         # number of valid entries (<= capacity)

    @property
    def capacity(self) -> int:
        return tree_leaves(self.stacked)[0].shape[0]


def buffer_init(params: Any, capacity: int) -> PolicyBuffer:
    """Start the ring with ``capacity`` copies of the initial policy."""
    stacked = tree_map(
        lambda x: x.detach()[None].expand(capacity, *x.shape).clone(),
        params)
    return PolicyBuffer(stacked=stacked, head=0, count=1)


@torch.no_grad()
def buffer_push(buf: PolicyBuffer, params: Any) -> PolicyBuffer:
    """FIFO insert of a new snapshot: copied into slot ``head``."""
    tree_map(lambda s, p: s[buf.head].copy_(p), buf.stacked, params)
    cap = buf.capacity
    return PolicyBuffer(stacked=buf.stacked, head=(buf.head + 1) % cap,
                        count=min(buf.count + 1, cap))


def buffer_slot(buf: PolicyBuffer, slot: int) -> Any:
    """Views of ring slot ``slot``."""
    return tree_map(lambda s: s[slot], buf.stacked)


def buffer_latest(buf: PolicyBuffer) -> Any:
    """The most recently pushed policy (== the learner's pi_T)."""
    return buffer_slot(buf, (buf.head - 1) % buf.capacity)
