# Copied from src/repro/data/mathgen.py; keep the two in step.
"""Synthetic verifiable math-reasoning task (offline GSM8k stand-in).

Generates short multi-step word problems over small integers with an
exact-match verifiable answer — preserving the structure the paper's §5.2
experiment needs: prompt -> sampled completion -> binary reward from a
verifier (Lambert et al., 2025 RLVR).  Difficulty levels provide a
curriculum so a from-scratch ~1-10M char-level model can reach non-trivial
accuracy within CPU budgets:

    level 0:  "3+5=?#"            answer "8"
    level 1:  "12+7-4=?#"         answer "15"
    level 2:  "(3+5)*2=?#"        answer "16"
    level 3:  one-sentence word problem, two operations

The verifier extracts the first integer of the completion and compares it
to the canonical answer — same binary reward as GSM8k exact-match.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.data.tokenizer import CharTokenizer, get_tokenizer

_TEMPLATES_L3 = [
    ("tom has {a} apples and buys {b} more, then eats {c}. "
     "how many are left?#", lambda a, b, c: a + b - c),
    ("a box holds {a} pens. with {b} boxes and {c} loose pens, "
     "how many pens?#", lambda a, b, c: a * b + c),
    ("sara reads {a} pages a day for {b} days and then {c} pages. "
     "total pages?#", lambda a, b, c: a * b + c),
    ("{a} birds sit on a wire. {b} fly away and {c} arrive. "
     "how many now?#", lambda a, b, c: a - b + c),
]


@dataclass
class Problem:
    prompt: str
    answer: str


def sample_problem(rng: np.random.Generator, level: int = 1) -> Problem:
    if level <= 0:
        a, b = rng.integers(0, 10, 2)
        return Problem(f"{a}+{b}=?#", str(a + b))
    if level == 1:
        a, b, c = rng.integers(0, 20, 3)
        return Problem(f"{a}+{b}-{c}=?#", str(a + b - c))
    if level == 2:
        a, b = rng.integers(0, 10, 2)
        c = int(rng.integers(1, 5))
        return Problem(f"({a}+{b})*{c}=?#", str((a + b) * c))
    idx = int(rng.integers(0, len(_TEMPLATES_L3)))
    tmpl, fn = _TEMPLATES_L3[idx]
    a = int(rng.integers(2, 15))
    b = int(rng.integers(1, min(a, 9) + 1))
    c = int(rng.integers(1, 10))
    return Problem(tmpl.format(a=a, b=b, c=c), str(fn(a, b, c)))


_INT_RE = re.compile(r"-?\d+")


def extract_answer(completion: str) -> Optional[str]:
    m = _INT_RE.search(completion)
    return m.group(0) if m else None


def verify(completion: str, answer: str) -> float:
    """Binary exact-match reward, as in GSM8k RLVR."""
    got = extract_answer(completion)
    return 1.0 if got is not None and got == answer else 0.0


class MathTaskDataset:
    """Batch sampler for prompts + verifier targets.

    Mirrors the paper's protocol constants (Table 2): fixed prompt length,
    fixed completion budget, grouped completions per prompt handled by the
    rollout engine.
    """

    def __init__(
        self,
        prompt_len: int = 64,
        level: int = 1,
        seed: int = 0,
        tokenizer: Optional[CharTokenizer] = None,
        eval_fraction: float = 0.1,
        pool_size: int = 8192,
    ) -> None:
        self.tok = tokenizer or get_tokenizer()
        self.prompt_len = prompt_len
        self.level = level
        rng = np.random.default_rng(seed)
        pool = [sample_problem(rng, level) for _ in range(pool_size)]
        n_eval = max(1, int(pool_size * eval_fraction))
        self.eval_set: List[Problem] = pool[:n_eval]
        self.train_set: List[Problem] = pool[n_eval:]
        self._rng = rng

    def _encode_prompts(self, probs: List[Problem]) -> np.ndarray:
        rows = [
            self.tok.pad_to(
                self.tok.encode(p.prompt), self.prompt_len, left=True
            )
            for p in probs
        ]
        return np.stack(rows)

    def sample_batch(
        self, n_prompts: int
    ) -> Tuple[np.ndarray, List[str], List[str]]:
        """Returns (tokens [n, prompt_len] left-padded, prompts, answers)."""
        idx = self._rng.integers(0, len(self.train_set), n_prompts)
        probs = [self.train_set[i] for i in idx]
        return (
            self._encode_prompts(probs),
            [p.prompt for p in probs],
            [p.answer for p in probs],
        )

    def eval_batch(
        self, n: Optional[int] = None
    ) -> Tuple[np.ndarray, List[str], List[str]]:
        probs = self.eval_set if n is None else self.eval_set[:n]
        return (
            self._encode_prompts(probs),
            [p.prompt for p in probs],
            [p.answer for p in probs],
        )

    def supervised_batch(
        self, n: int, completion_len: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, loss_mask) for the warm-start pretraining phase.

        Sequence = <bos> prompt answer <eos> <pad>...; the mask covers the
        answer + eos positions (teacher forcing on the verifiable part).
        """
        idx = self._rng.integers(0, len(self.train_set), n)
        total = self.prompt_len + completion_len
        toks = np.zeros((n, total), np.int32)
        mask = np.zeros((n, total), np.float32)
        for r, i in enumerate(idx):
            p = self.train_set[i]
            prompt_ids = self.tok.encode(p.prompt)
            ans_ids = self.tok.encode(
                p.answer, add_bos=False, add_eos=True
            )
            seq = (prompt_ids + ans_ids)[:total]
            toks[r, : len(seq)] = seq
            lo = min(len(prompt_ids), total)
            hi = min(len(seq), total)
            mask[r, lo:hi] = 1.0
        return toks, mask
