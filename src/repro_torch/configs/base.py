"""Model / run configuration system.

A copy of ``repro/configs/base.py`` (stdlib only), kept in the port so that
``repro_torch`` imports nothing of the JAX package. The port serves every
family: dense, moe, ssm, hybrid, vlm and audio.

Every assigned architecture is a `ModelConfig` registered under its public id
(``--arch <id>``). Configs are plain frozen dataclasses so they can be hashed
and round-tripped through launch scripts.

The four assigned input shapes live in `INPUT_SHAPES`; each carries the step
kind it lowers (train / prefill / decode) per the spec.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0          # kimi-k2 style always-on shared expert
    router_aux_loss: float = 0.01      # load-balance loss weight
    router_jitter: float = 0.0
    capacity_factor: float = 1.25      # expert buffer slack (tokens dropped beyond)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                    # d_inner = expand * d_model
    dt_rank: int = 0                   # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style block pattern."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")   # 1:2 attn:recurrent
    tail: Tuple[str, ...] = ()          # unrolled remainder layers
    lru_width: int = 0                  # 0 -> d_model
    conv_width: int = 4
    window: int = 2048                  # local-attention window


@dataclass(frozen=True)
class VLMConfig:
    n_vis_tokens: int = 576             # patch embeddings supplied by the (stubbed) tower
    vis_embed_dim: int = 0              # 0 -> d_model (projector output dim)


@dataclass(frozen=True)
class AudioConfig:
    n_enc_layers: int = 12
    n_audio_frames: int = 1500          # post-conv frame count (stub supplies embeddings)


@dataclass(frozen=True)
class PEFTConfig:
    """Paper §III-A: prompt modules + head are the tunable part; backbone frozen."""
    n_prefix: int = 16                  # prefix-KV tokens per attention layer
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q", "v")
    head_dim_out: int = 0               # classification head width; 0 -> LM head reuse
    state_prompt: bool = True           # learned initial state for SSM / RG-LRU layers


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                         # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_variant: str = "full"          # full | sliding
    sliding_window: int = 4096
    dtype: str = "bfloat16"
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    vlm: VLMConfig = field(default_factory=VLMConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    peft: PEFTConfig = field(default_factory=PEFTConfig)

    # -- derived ------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm.dt_rank or math.ceil(self.d_model / 16)

    @property
    def lru_width(self) -> int:
        return self.hybrid.lru_width or self.d_model

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- analytic parameter counts (for rooflines / MODEL_FLOPS) ------------
    def param_count(self) -> int:
        """Total backbone parameters (analytic, matches init to within ties)."""
        d, hd = self.d_model, self.head_dim_
        emb = self.vocab_size * d
        lm_head = 0 if self.tie_embeddings else self.vocab_size * d
        bias = d if self.qkv_bias else 0

        def attn_p(n_h, n_kv):
            q = d * n_h * hd + (bias and n_h * hd)
            kv = 2 * (d * n_kv * hd + (bias and n_kv * hd))
            o = n_h * hd * d
            return q + kv + o

        def mlp_p(ff):
            return 3 * d * ff            # gated (SwiGLU-style)

        def moe_p():
            m = self.moe
            per = 3 * d * m.d_ff_expert
            return (m.n_experts + m.n_shared_experts) * per + d * m.n_experts

        def ssm_p():
            di, ds, dr = self.d_inner, self.ssm.d_state, self.dt_rank
            return (d * 2 * di            # in_proj (x, z)
                    + di * self.ssm.d_conv
                    + di * (dr + 2 * ds)  # x_proj
                    + dr * di + di        # dt_proj
                    + di * ds + di        # A_log, D
                    + di * d)             # out_proj

        def rglru_p():
            w = self.lru_width
            return (d * 2 * w + w * self.hybrid.conv_width * 2  # in proj + conv
                    + 2 * w               # a_param, input gate params (diagonal)
                    + 2 * w * w           # gates (rg, input) dense
                    + w * d)              # out proj

        norms = 2 * d
        if self.family == "ssm":
            layer = ssm_p() + d
        elif self.family == "moe":
            layer = attn_p(self.n_heads, self.n_kv_heads) + moe_p() + norms
        elif self.family == "hybrid":
            pat = list(self.hybrid.pattern)
            n_block = (self.n_layers - len(self.hybrid.tail)) // len(pat)
            tot = 0
            for kind in pat * n_block + list(self.hybrid.tail):
                tot += (attn_p(self.n_heads, self.n_kv_heads) if kind == "attn"
                        else rglru_p()) + mlp_p(self.d_ff) + norms
            return emb + lm_head + tot + d
        elif self.family == "audio":
            enc = self.audio.n_enc_layers * (attn_p(self.n_heads, self.n_kv_heads)
                                             + mlp_p(self.d_ff) + norms)
            dec = self.n_layers * (2 * attn_p(self.n_heads, self.n_kv_heads)
                                   + mlp_p(self.d_ff) + 3 * d)
            return emb + lm_head + enc + dec + d
        else:                              # dense / vlm
            layer = attn_p(self.n_heads, self.n_kv_heads) + mlp_p(self.d_ff) + norms
        return emb + lm_head + self.n_layers * layer + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        per = 3 * self.d_model * m.d_ff_expert
        inactive = (m.n_experts - m.top_k) * per
        return self.param_count() - self.n_layers * inactive

    # -- reduced variant for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family, 2 layers, d_model<=256, <=4 experts (smoke tests)."""
        d = min(self.d_model, 256)
        n_h = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_h))
        kw = dict(
            n_layers=2, d_model=d, n_heads=n_h, n_kv_heads=n_kv,
            head_dim=d // n_h, d_ff=min(self.d_ff, 4 * d) or 0,
            vocab_size=min(self.vocab_size, 512), sliding_window=64,
            peft=dataclasses.replace(self.peft, n_prefix=4, lora_rank=4),
        )
        if self.family == "moe":
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=min(self.moe.d_ff_expert, d),
                n_shared_experts=min(self.moe.n_shared_experts, 1))
        if self.family == "hybrid":
            kw["n_layers"] = 3
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, tail=(), lru_width=d, window=32)
        if self.family == "vlm":
            kw["vlm"] = dataclasses.replace(self.vlm, n_vis_tokens=16)
        if self.family == "audio":
            kw["n_layers"] = 2
            kw["audio"] = dataclasses.replace(self.audio, n_enc_layers=2, n_audio_frames=32)
        return self.with_(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        falcon_mamba_7b, kimi_k2_1t_a32b, recurrentgemma_2b, qwen2_7b,
        llava_next_mistral_7b, qwen1_5_32b, qwen2_5_32b, qwen2_5_14b,
        granite_moe_1b_a400m, whisper_small, vit_edge)
