# Copied from src/repro/configs/qwen2_5_0_5b.py; keep the two in step.
"""qwen2.5-0.5b — the paper's OWN RLVR model (§5.2 / App. C.2).
[hf:Qwen/Qwen2.5-0.5B, arXiv:2412.15115]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, tied embeddings.
Not part of the assigned 10 — included because the paper trains it; the
RLVR example driver uses a reduced variant of exactly this family.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=True,
    value_head=True,
    source="hf:Qwen/Qwen2.5-0.5B (the paper's RLVR base model)",
)
