"""Model registry (port of ``repro.models.registry`` for dense archs).

``build(cfg)`` returns a ``ModelBundle`` of plain functions over the
config, so the serve engine and the learner never special-case
architectures:

    bundle.init(gen, dtype, device)                      -> params
    bundle.forward(params, tokens, ...)                  -> ModelOutput
    bundle.init_cache(batch, max_len, ...)               -> dense cache
    bundle.decode_step(params, token, cache)             -> (out, cache)
    bundle.init_paged_cache(num_blocks, block_size, ...) -> pages
    bundle.decode_step_paged(params, token, pages, ...)  -> (out, pages)
    bundle.decode_step_paged_multi(...) / decode_step_paged_varlen(...)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_mod


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable
    forward: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    decode_step_paged_multi: Optional[Callable] = None
    decode_step_paged_varlen: Optional[Callable] = None


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet")

    def init(gen: torch.Generator, dtype=torch.float32, device=None):
        return tf_mod.init_params(gen, cfg, dtype, device)

    def forward(params, tokens, **kw):
        return tf_mod.forward(params, cfg, tokens, **kw)

    def init_cache(batch, max_len, dtype=torch.float32, device=None):
        return tf_mod.init_cache(cfg, batch, max_len, dtype, device)

    def decode_step(params, token, cache):
        return tf_mod.decode_step(params, cfg, token, cache)

    def decode_step_paged(params, token, pages, block_tables, pos, active):
        return tf_mod.decode_step_paged(params, cfg, token, pages,
                                        block_tables, pos, active)

    def decode_step_paged_multi(params, tokens, pages, block_tables, pos,
                                active, write_cap):
        return tf_mod.decode_step_paged_multi(
            params, cfg, tokens, pages, block_tables, pos, active, write_cap)

    def decode_step_paged_varlen(params, tokens, pages, block_tables,
                                 row_start, row_len, write_cap):
        return tf_mod.decode_step_paged_varlen(
            params, cfg, tokens, pages, block_tables, row_start, row_len,
            write_cap)

    def init_paged_cache(num_blocks, block_size, dtype=torch.float32,
                         device=None):
        return tf_mod.init_paged_cache(cfg, num_blocks, block_size, dtype,
                                       device)

    return ModelBundle(cfg, init, forward=forward, init_cache=init_cache,
                       decode_step=decode_step,
                       decode_step_paged=decode_step_paged,
                       init_paged_cache=init_paged_cache,
                       decode_step_paged_multi=decode_step_paged_multi,
                       decode_step_paged_varlen=decode_step_paged_varlen)
