"""Kernels of the port: plain versions (``ref``), CUDA wrappers (one
module per kernel, the two log-prob kernels together in ``logprobs``) and
the device dispatch (``ops``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (flash_attention, logprobs, paged_attention,
                                 paged_attention_varlen, paged_kv_write,
                                 ssm_scan, vtrace, wkv6)

_KERNELS = (paged_kv_write.KERNEL, paged_attention.KERNEL,
            paged_attention_varlen.KERNEL, logprobs.FWD_KERNEL,
            logprobs.BWD_KERNEL, vtrace.KERNEL, wkv6.KERNEL,
            flash_attention.KERNEL, ssm_scan.KERNEL)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset, by name."""
    return {k.name: k.launches for k in _KERNELS}


def reset_launch_counts() -> None:
    for k in _KERNELS:
        k.launches = 0
