# Copied from src/repro/data/tokenizer.py; keep the two in step.
"""Character-level tokenizer for the synthetic verifiable-math task.

The RLVR experiments (§5.2) need a tokenizer that is (a) fully offline,
(b) tiny, and (c) loss-free for arithmetic strings.  A fixed char
vocabulary covers the generator's alphabet; ids are stable across runs so
checkpoints and cached rollouts interoperate.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

PAD, BOS, EOS = 0, 1, 2
_SPECIALS = ["<pad>", "<bos>", "<eos>"]
_ALPHABET = list("0123456789+-*/()=<>. ,?abcdefghijklmnopqrstuvwxyz#")


class CharTokenizer:
    """Fixed-vocabulary char tokenizer. Vocab size 54 (3 specials + 51)."""

    def __init__(self) -> None:
        self.itos: List[str] = list(_SPECIALS) + list(_ALPHABET)
        self.stoi = {c: i for i, c in enumerate(self.itos)}
        self.pad_id, self.bos_id, self.eos_id = PAD, BOS, EOS

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def encode(
        self, text: str, add_bos: bool = True, add_eos: bool = False
    ) -> List[int]:
        ids = [self.stoi[c] for c in text.lower() if c in self.stoi]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int], strip_special: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i >= len(self.itos) or i < 0:
                continue
            if strip_special and i < len(_SPECIALS):
                if i == self.eos_id:
                    break
                continue
            out.append(self.itos[i])
        return "".join(out)

    def pad_to(
        self,
        ids: Sequence[int],
        length: int,
        left: bool = False,
    ) -> np.ndarray:
        ids = list(ids)[:length]
        pad = [self.pad_id] * (length - len(ids))
        return np.asarray(pad + ids if left else ids + pad, np.int32)


_DEFAULT = None


def get_tokenizer() -> CharTokenizer:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = CharTokenizer()
    return _DEFAULT
