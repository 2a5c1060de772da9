"""Token sampling, static generation and teacher-forced scoring (port of
``repro.rollout.sampler`` and ``repro.serve.engine``'s ``_sample``).

The categorical draw is Gumbel-max: ``argmax(logits + g)`` with ``g``
Gumbel noise, which is how ``jax.random.categorical`` draws too.  The
noise comes from an explicit ``torch.Generator``; tests pass the noise
in instead, since the JAX PRNG stream cannot be reproduced.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.kernels import ops as kops

# (step, shape) -> float32 Gumbel noise for that decode step.
NoiseFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


class GenerationResult(NamedTuple):
    tokens: torch.Tensor        # [B, P + N] prompt + completion ids
    completion: torch.Tensor    # [B, N]
    log_beta: torch.Tensor      # [B, N] behavior log-probs of sampled tokens
    mask: torch.Tensor          # [B, N] 1.0 up to and including EOS
    values: Optional[torch.Tensor]  # [B, N] critic values (or None)


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


@torch.no_grad()
def generate(
    bundle: Any,
    params: Any,
    prompt: torch.Tensor,        # [B, P] (left-padded) prompt token ids
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_p: float = 1.0,
    noise: Optional[NoiseFn] = None,
) -> GenerationResult:
    """Sample completions: one prefill that fills a dense cache sized for
    the whole rollout, then ``max_new_tokens`` one-token decode steps.

    Step ``t`` draws its Gumbel noise from ``noise(t, (B, V))`` when given
    (tests replay the JAX draws through it), else from ``generator`` on
    the prompt's device.  The EOS token itself is scored (mask 1);
    afterwards a row emits PAD with exact zeros for mask, log_beta and
    value."""
    b, p = prompt.shape
    dev = prompt.device
    if noise is None:
        noise = lambda t, shape: gumbel_noise(shape, generator, dev)
    out = bundle.forward(params, prompt, return_cache=True,
                         cache_len=p + max_new_tokens)
    cache, logits = out.cache, out.logits[:, -1]
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    toks, lps, masks, values = [], [], [], []
    for t in range(max_new_tokens):
        tok, lp = sample(logits, temperature, top_p,
                         noise(t, tuple(logits.shape)).to(dev))
        tok = torch.where(alive, tok, torch.full_like(tok, PAD))
        lp = torch.where(alive, lp, torch.zeros_like(lp))
        mask = alive.float()
        alive = alive & (tok != EOS)
        step_out, cache = bundle.decode_step(params, tok, cache)
        value = (step_out.value if step_out.value is not None
                 else torch.zeros(b, device=dev))
        toks.append(tok)
        lps.append(lp)
        masks.append(mask)
        values.append(value * mask)
        logits = step_out.logits
    completion = torch.stack(toks, dim=1)
    return GenerationResult(
        tokens=torch.cat([prompt.to(completion.dtype), completion], dim=1),
        completion=completion,
        log_beta=torch.stack(lps, dim=1),
        mask=torch.stack(masks, dim=1),
        values=(torch.stack(values, dim=1) if bundle.cfg.value_head
                else None))


def score_tokens(
    bundle: Any,
    params: Any,
    tokens: torch.Tensor,        # [B, T] full sequences (prompt + completion)
    prompt_len: int,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Teacher-forced per-completion-token ``(logp, entropy, value)``.

    Logits at position t predict token t+1; completion tokens live at
    ``[prompt_len, T)``, so logits ``[prompt_len - 1, T - 1)`` are scored,
    through the fused log-prob kernel on the card (``kernels.ops``)."""
    out = bundle.forward(params, tokens)
    logits = out.logits[:, prompt_len - 1:-1]             # [B, N, V]
    targets = tokens[:, prompt_len:]                      # [B, N]
    logp, entropy = kops.logprobs_from_logits(logits, targets)
    value = None
    if out.value is not None:
        value = out.value[:, prompt_len - 1:-1]
    return logp, entropy, value
