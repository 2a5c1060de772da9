"""Architecture configs of the port: qwen2.5-0.5b, the paper's RLVR model.

``get_config(name)`` returns the full config; ``reduced_config(name)``
the CPU-smoke variant of the same family.  Both follow
``src/repro/configs/__init__.py`` exactly for the archs they cover.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen2_5_0_5b import CONFIG as _qwen05b

ARCHS: Dict[str, ModelConfig] = {_qwen05b.name: _qwen05b}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")


def reduced_config(name: str, vocab: int = 512) -> ModelConfig:
    """Family-preserving reduction: 2 layers, d_model 256 (dense GQA
    branch of the reference's ``reduced_config``)."""
    cfg = get_config(name)
    group = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    heads = min(group, 8) if group > 1 else 2
    kv = max(1, heads // min(group, heads))
    return cfg.replace(
        name=f"{cfg.name}-reduced", n_layers=2, d_model=256, n_heads=heads,
        n_kv_heads=kv, d_head=64, d_ff=256, vocab_size=vocab)


__all__ = ["ARCHS", "ModelConfig", "get_config", "reduced_config"]
