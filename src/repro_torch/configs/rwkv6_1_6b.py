# Copied from src/repro/configs/rwkv6_1_6b.py; keep the two in step.
"""rwkv6-1.6b — "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892]

Assigned: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
O(1) decode state (the WKV matrix per head) — the canonical long_500k
architecture; decode cost is independent of context length.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # 2048 / 64 WKV heads (informational)
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attn_free=True,
    activation="gelu",     # unused by the rwkv block (squared-relu inside)
    value_head=True,
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)
