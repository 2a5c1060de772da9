# Copied from src/repro/configs/gemma3_12b.py; keep the two in step.
"""gemma3-12b — dense GQA, 5:1 local:global interleave, 128k.
[hf:google/gemma-3-1b-pt]

Assigned: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
Sliding window 1024 on local layers; every 6th layer global — this is the
sub-quadratic pattern that qualifies gemma3 for the long_500k decode shape
(local layers bound their KV to the window; global-layer caches are
sequence-sharded, see repro.distributed).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=True,
    logit_softcap=30.0,
    sliding_window=1024,
    global_every=6,           # 5 local : 1 global
    value_head=True,
    source="hf:google/gemma-3-1b-pt (family card, 12B shape)",
)
