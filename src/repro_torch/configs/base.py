# Copied from src/repro/configs/base.py; keep the two in step.
"""Model/architecture configuration schema + the assigned input shapes.

Every assigned architecture instantiates ``ModelConfig`` in its own module
under ``repro.configs`` (one file per arch, citing its source), and a
``reduced()`` variant (<= 2 layers, d_model <= 512, <= 4 experts) for the
CPU smoke tests.  The FULL configs are exercised only through the
multi-pod dry-run (abstract lowering, no allocation).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    group_size: int = 512          # tokens per dispatch group (perf knob:
                                   # dispatch memory = N*group*k*cf)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16          # per-channel state (hymba: ssm_state=16)
    conv_width: int = 4
    expand: int = 2              # mamba inner expansion
    dt_rank: Optional[int] = None  # defaults to ceil(d_model/16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                # qwen-family
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    activation: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None  # gemma-style final softcap
    # Sliding-window pattern: window size for "local" layers; a layer l is
    # global iff (l + 1) % global_every == 0 (gemma3's 5 local : 1 global).
    # sliding_window=None => all layers global full attention.
    sliding_window: Optional[int] = None
    global_every: int = 6
    # MoE / SSM / hybrid extensions.
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_ssm: bool = False          # hymba: parallel attn+SSM heads
    attn_free: bool = False                # rwkv6: no attention at all
    # Encoder-decoder (whisper): encoder consumes stubbed frame embeddings.
    encoder_layers: int = 0
    encoder_seq_len: int = 0               # e.g. 1500 mel frames
    # VLM (paligemma): prefix of stubbed patch embeddings, prefix-LM mask.
    vision_prefix_len: int = 0
    prefix_lm: bool = False
    # RL heads.
    value_head: bool = True
    # Citation for the assigned config (paper/model-card).
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else (
            self.d_model // self.n_heads
        )

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can serve long_500k (harness long-decode rule)."""
        if self.attn_free:
            return True
        if self.hybrid_attn_ssm and self.sliding_window is not None:
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def window_for_layer(self, layer: int) -> Optional[int]:
        """None => full/global attention at this layer."""
        if self.sliding_window is None:
            return None
        if (layer + 1) % self.global_every == 0:
            return None
        return self.sliding_window

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + heads)."""
        d, h, kv, dh, ff, v = (
            self.d_model, self.n_heads, self.n_kv_heads, self.head_dim,
            self.d_ff, self.vocab_size,
        )
        n_attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.qkv_bias:
            n_attn += (h + 2 * kv) * dh
        if self.activation == "swiglu":
            n_mlp_dense = 3 * d * ff
        else:
            n_mlp_dense = 2 * d * ff
        per_layer = 2 * d  # norms
        if self.attn_free:
            # rwkv6: time-mix (~4 d^2 per layer incl. decay MLPs) +
            # channel-mix (2*d*ff approximately, rwkv uses square relu ffn)
            per_layer += 4 * d * d + d * ff * 2
        elif self.hybrid_attn_ssm:
            inner = (self.ssm.expand if self.ssm else 2) * d
            per_layer += n_attn + n_mlp_dense + 2 * d * inner + inner * d
        else:
            per_layer += n_attn
            if self.moe is not None:
                m = self.moe
                per_layer += d * m.n_experts  # router
                per_layer += m.n_experts * 3 * d * m.d_ff_expert
                per_layer += m.n_shared_experts * 3 * d * m.d_ff_expert
            else:
                per_layer += n_mlp_dense
        total = self.n_layers * per_layer
        total += v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        if self.encoder_layers:
            enc_per = 2 * d + n_attn + n_mlp_dense
            total += self.encoder_layers * (enc_per + n_attn + d)  # + cross
        total += 2 * d  # final norm(s)
        if self.value_head:
            total += d + 1
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_like = self.replace(moe=None)
        base = dense_like.param_count() - self.n_layers * (
            3 * self.d_model * self.d_ff
        )
        active_ff = self.n_layers * (
            (m.top_k + m.n_shared_experts) * 3 * self.d_model * m.d_ff_expert
            + self.d_model * m.n_experts
        )
        return int(base + active_ff)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
