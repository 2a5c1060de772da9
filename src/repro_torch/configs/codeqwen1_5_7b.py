# Copied from src/repro/configs/codeqwen1_5_7b.py; keep the two in step.
"""codeqwen1.5-7b — qwen1.5-arch code model, full MHA.
[hf:Qwen/CodeQwen1.5-7B]

Assigned: 32L d_model=4096 32H (GQA kv=32 => MHA) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    value_head=True,
    source="hf:Qwen/CodeQwen1.5-7B",
)
