"""Token sampling of the serve engine (port of ``repro.rollout.sampler``'s
``_top_p_filter`` and ``repro.serve.engine``'s ``_sample``).

The categorical draw is Gumbel-max: ``argmax(logits + g)`` with ``g``
Gumbel noise, which is how ``jax.random.categorical`` draws too.  The
noise comes from an explicit ``torch.Generator``; tests pass the noise
in instead, since the JAX PRNG stream cannot be reproduced.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Set the tail outside the nucleus to -inf (keeps >= 1 token)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # smallest set with cumulative prob >= top_p
    cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
    cutoff_idx = torch.clamp(cutoff_idx, max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits >= cutoff, logits,
                       torch.full_like(logits, float("-inf")))


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``, float32."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temperature: float, top_p: float,
           noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw one token per row of ``logits`` [B, V].

    ``temperature`` is floored at 1e-6, then top-p filters the tempered
    logits; the token is ``argmax(filtered + noise)`` and its behaviour
    log-prob ``log_beta`` is the log-softmax of the **tempered,
    filtered** logits at that token (what the TV filter consumes).
    Returns ``(tokens int32 [B], log_beta float32 [B])``."""
    logits = logits.float() / max(float(temperature), 1e-6)
    logits = _top_p_filter(logits, top_p)
    tok = torch.argmax(logits + noise, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, tok[:, None])[:, 0]
    return tok.to(torch.int32), lp
