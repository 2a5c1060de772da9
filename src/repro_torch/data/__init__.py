from repro_torch.data.mathgen import (
    MathTaskDataset,
    Problem,
    extract_answer,
    sample_problem,
    verify,
)
from repro_torch.data.tokenizer import CharTokenizer, get_tokenizer

__all__ = [
    "CharTokenizer",
    "MathTaskDataset",
    "Problem",
    "extract_answer",
    "get_tokenizer",
    "sample_problem",
    "verify",
]
