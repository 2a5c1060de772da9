# Copied from src/repro/configs/hymba_1_5b.py; keep the two in step.
"""hymba-1.5b — hybrid-head: parallel attention + SSM per layer.
[arXiv:2411.13676]

Assigned: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16.  Every layer fuses an attention branch and a Mamba branch
(mean of the two outputs, per the paper).  Most layers use sliding-window
attention; Hymba keeps 3 full-attention layers (first/middle/last) — we
approximate the pattern with ``global_every=16`` (layers 15 and 31 global)
since the layer scan expresses heterogeneity through the per-layer window
vector.  SWA + SSM makes the arch sub-quadratic => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    activation="swiglu",
    sliding_window=1024,
    global_every=16,
    hybrid_attn_ssm=True,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    value_head=True,
    source="arXiv:2411.13676 (Hymba)",
)
