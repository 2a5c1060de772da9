"""Architecture configs of the port: qwen2.5-0.5b, the paper's RLVR model,
qwen2.5-14b and codeqwen1.5-7b, dense decoders of the same family at
head dim 128, gemma3-12b, a dense decoder at head dim 256 with sliding
windows on five layers of six and a logit softcap, rwkv6-1.6b, the
attention-free arch, and hymba-1.5b, the hybrid attention + SSM arch.

``get_config(name)`` returns the full config; ``reduced_config(name)``
the CPU-smoke variant of the same family.  Both follow
``src/repro/configs/__init__.py`` exactly for the archs they cover.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs.codeqwen1_5_7b import CONFIG as _codeqwen
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.qwen2_5_0_5b import CONFIG as _qwen05b
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen14b
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_qwen05b, _qwen14b, _codeqwen, _gemma3, _rwkv6,
                        _hymba)}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")


def reduced_config(name: str, vocab: int = 512) -> ModelConfig:
    """Family-preserving reduction: 2 layers, d_ff 256; d_model 256 for
    the GQA branch, 128 (two 64-wide WKV heads) for attention-free
    configs; the SSM's state, conv width and expansion kept; windowed
    configs get window 16 with every second layer global.  As the
    reference's ``reduced_config`` does."""
    cfg = get_config(name)
    group = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    if cfg.attn_free:
        heads, kv = 2, 2
        d_model = 128  # rwkv requires d_model % 64 == 0
    else:
        heads = min(group, 8) if group > 1 else 2
        kv = max(1, heads // min(group, heads))
        d_model = 256
    changes = dict(n_layers=2, d_model=d_model, n_heads=heads,
                   n_kv_heads=kv, d_head=64, d_ff=256, vocab_size=vocab)
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(
            state_dim=cfg.ssm.state_dim, conv_width=cfg.ssm.conv_width,
            expand=cfg.ssm.expand)
    if cfg.sliding_window is not None:
        changes["sliding_window"] = 16
        changes["global_every"] = 2
    return cfg.replace(name=f"{cfg.name}-reduced", **changes)


__all__ = ["ARCHS", "ModelConfig", "get_config", "reduced_config"]
