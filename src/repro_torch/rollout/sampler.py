"""Token sampling, static generation, the speculative accept rule and
teacher-forced scoring (port of ``repro.rollout.sampler`` and
``repro.serve.engine``'s ``_sample``).

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


def accept_noise(b: int, k: int, v: int,
                 generator: Optional[torch.Generator],
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws :func:`speculative_accept` takes: ``u`` ``[B, K]``
    uniform in ``[1e-7, 1)`` (JAX's ``uniform(minval=1e-7)``), then the
    correction draw's Gumbel noise ``[B, V]``."""
    u = torch.rand((b, k), generator=generator, device=device,
                   dtype=torch.float32)
    return u * (1.0 - 1e-7) + 1e-7, gumbel_noise((b, v), generator, device)


def speculative_accept(
    verifier_logits: torch.Tensor,  # [B, K, V] after consuming query i
    draft_tokens: torch.Tensor,     # [B, K] int32 proposed d_{i+1}
    draft_logits: torch.Tensor,     # [B, K, V] that sampled d_{i+1}
    u: torch.Tensor,                # [B, K] uniform in [1e-7, 1)
    gumbel: torch.Tensor,           # [B, V] the correction's noise
    *,
    temperature: float = 1.0,
    top_p: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative-sampling accept/rollback (Leviathan et al., 2023), as
    ``repro.rollout.sampler.speculative_accept`` with its draws passed in.

    Position ``i`` accepts ``d`` when ``log u_i < log p_i(d) - log
    q_i(d)``, with ``p``/``q`` the verifier/draft distributions under
    the engine's temperature and top-p.  The first rejection emits a
    correction ``argmax(log max(p - q, 0) + gumbel)`` (from ``p`` itself
    when the residual sums to at most 1e-9) and rolls back the rest;
    ``log_p`` is the verifier's log-prob of each emitted token.  Greedy
    (``temperature -> 1e-6``) accepts exactly the verifier's argmax.

    Returns ``(tokens [B, K] int32, log_p [B, K], n_accepted [B],
    n_emitted [B])``; positions ``>= n_emitted`` are PAD with log-prob
    exactly 0, and ``n_emitted == K`` appends no correction."""
    b, k, _ = verifier_logits.shape
    temp = max(float(temperature), 1e-6)

    def _log_dist(logits):
        return torch.log_softmax(
            _top_p_filter(logits.float() / temp, top_p), dim=-1)

    logp_p = _log_dist(verifier_logits)                     # [B, K, V]
    logp_q = _log_dist(draft_logits)
    idx = draft_tokens.long()[..., None]
    p_d = torch.gather(logp_p, -1, idx)[..., 0]             # [B, K]
    q_d = torch.gather(logp_q, -1, idx)[..., 0]
    # p_d = -inf always rejects (a NaN difference compares False too).
    accept = torch.log(u) < (p_d - q_d)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    rows = torch.arange(b, device=verifier_logits.device)
    rej = torch.clamp(n_acc, max=k - 1)
    pr, qr = logp_p[rows, rej], logp_q[rows, rej]           # [B, V]
    residual = torch.clamp(torch.exp(pr) - torch.exp(qr), min=0.0)
    res_sum = residual.sum(dim=-1, keepdim=True)
    corr_logits = torch.where(
        res_sum > 1e-9, torch.log(torch.clamp(residual, min=1e-38)), pr)
    corr = torch.argmax(corr_logits + gumbel, dim=-1)       # [B]
    corr_logp = torch.gather(pr, 1, corr[:, None])[:, 0]
    pos = torch.arange(k, device=verifier_logits.device)[None, :]
    is_acc = pos < n_acc[:, None]
    is_corr = (pos == n_acc[:, None]) & (n_acc[:, None] < k)
    pad = torch.full_like(draft_tokens, PAD)
    tokens = torch.where(is_acc, draft_tokens,
                         torch.where(is_corr, corr[:, None].to(pad.dtype),
                                     pad)).to(torch.int32)
    zero = torch.zeros_like(p_d)
    log_p = torch.where(is_acc, p_d,
                        torch.where(is_corr, corr_logp[:, None], zero))
    n_emit = torch.clamp(n_acc + 1, max=k)
    return tokens, log_p, n_acc, n_emit


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
