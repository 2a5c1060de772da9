# Copied from src/repro/configs/qwen2_5_14b.py; keep the two in step.
"""qwen2.5-14b — dense GQA decoder, QKV bias.  [hf:Qwen/Qwen2.5-0.5B]

Assigned: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,            # qwen-family attention bias
    rope_theta=1_000_000.0,
    activation="swiglu",
    value_head=True,
    source="hf:Qwen/Qwen2.5-0.5B (family card, 14B shape)",
)
