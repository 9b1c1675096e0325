"""Model configuration (port of kubeai_tpu/models/base.py).

The port keeps its own copy: the JAX module imports ``ops/rope.py`` and
with it ``jax.numpy``. Field names and defaults are the same, so a
config converts field by field (``ModelConfig(**dataclasses.asdict(c))``),
and ``from_hf`` / ``from_json_file`` read an HF config.json as the JAX
package does. The presets below are the published config.json of each
model family the catalog serves, read through ``from_hf``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style NTK-by-parts scaling parameters."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int | None = None  # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    rms_norm_eps: float = 1e-5
    max_position: int = 8192
    tie_word_embeddings: bool = False
    # Model-family variants: MoE (Mixtral), q/k/v biases (Qwen2), Gemma's
    # gelu, embedding scale, 1 + w norms, post norms, softcaps, query
    # scale and sliding window (Gemma2: even layers).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0
    qkv_bias: bool = False
    hidden_act: str = "silu"
    embed_scale: bool = False
    rms_one_offset: bool = False
    post_norms: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    query_scale: float | None = None
    sliding_window: int = 0
    sliding_layers: str = "all"
    # Kernel gates, as in the JAX package: flash attention for cold
    # prefill buckets >= 256, the paged-attention kernels for every other
    # paged call. The engine turns both on for CUDA devices.
    use_flash_prefill: bool = False
    use_paged_kernel: bool = False
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""
    kv_scale_k: float = 1.0
    kv_scale_v: float = 1.0

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def from_hf(cls, config) -> "ModelConfig":
        """Build from an object with HF config attributes (Llama / Mistral /
        Mixtral / Gemma / Qwen2 field names), field for field as the JAX
        package does."""
        get = lambda k, d=None: getattr(config, k, d)  # noqa: E731
        scaling = None
        rs = get("rope_scaling")
        if isinstance(rs, dict):
            rope_type = rs.get("rope_type", rs.get("type"))
            if rope_type == "llama3":
                scaling = RopeScaling(
                    factor=rs.get("factor", 8.0),
                    low_freq_factor=rs.get("low_freq_factor", 1.0),
                    high_freq_factor=rs.get("high_freq_factor", 4.0),
                    original_max_position=rs.get("original_max_position_embeddings", 8192),
                )
            elif rope_type == "linear":
                # Every band divided by factor: llama3-style scaling whose
                # always-scaled low-frequency band covers the spectrum.
                scaling = RopeScaling(
                    factor=rs.get("factor", 1.0),
                    low_freq_factor=1e9,
                    high_freq_factor=2e9,
                    original_max_position=get("max_position_embeddings", 8192),
                )
            elif rope_type not in ("default", None):
                raise ValueError(
                    f"unsupported rope_scaling type {rope_type!r}; supported: llama3, linear"
                )
        model_type = get("model_type", "llama")
        variant = {}
        if model_type == "qwen2":
            variant["qkv_bias"] = True  # Qwen2 hardcodes q/k/v biases
        if model_type in ("gemma", "gemma2"):
            variant = dict(hidden_act="gelu_tanh", embed_scale=True, rms_one_offset=True)
            if model_type == "gemma2":
                variant.update(
                    post_norms=True,
                    attn_softcap=get("attn_logit_softcapping", 50.0) or 0.0,
                    logit_softcap=get("final_logit_softcapping", 30.0) or 0.0,
                    query_scale=get("query_pre_attn_scalar") ** -0.5
                    if get("query_pre_attn_scalar")
                    else None,
                    # HF Gemma2 applies the window on even layer indices.
                    sliding_window=get("sliding_window") or 0,
                    sliding_layers="even",
                )
        return cls(
            **variant,
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=get("intermediate_size") or get("ffn_dim"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads") or get("num_attention_heads"),
            head_dim=get("head_dim"),
            rope_theta=get("rope_theta", 10000.0),
            rope_scaling=scaling,
            rms_norm_eps=get("rms_norm_eps", 1e-5),
            max_position=get("max_position_embeddings", 8192),
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            num_experts=get("num_local_experts", 0) or 0,
            num_experts_per_tok=get("num_experts_per_tok", 2) or 2,
        )

    @classmethod
    def from_json_file(cls, path: str) -> "ModelConfig":
        """Load from an HF-format config.json (a file, or the directory
        holding it)."""
        with open(os.path.join(path, "config.json") if os.path.isdir(path) else path) as f:
            raw = json.load(f)
        return cls.from_hf(_Attrs(raw))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


class _Attrs:
    """A config.json dict read through attributes, as from_hf expects."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


def llama_3_1_8b(**overrides) -> ModelConfig:
    """Llama-3.1-8B widths, from Meta's published config.json for
    meta-llama/Llama-3.1-8B-Instruct (bf16, untied embeddings)."""
    cfg = ModelConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        rope_scaling=RopeScaling(
            factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
            original_max_position=8192,
        ),
        rms_norm_eps=1e-5,
        max_position=131072,
        tie_word_embeddings=False,
        dtype="bfloat16",
    )
    return cfg.replace(**overrides) if overrides else cfg


# The published config.json fields of each family's preset model, by
# preset name (read through from_hf, as a checkpoint's config.json is).
HF_CONFIGS = {
    # Qwen/Qwen2.5-7B-Instruct: q/k/v biases (Qwen2 always has them); 28
    # query heads over 4 KV heads, groups of 7.
    "qwen2.5-7b": dict(
        model_type="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        rope_theta=1000000.0, rms_norm_eps=1e-6, max_position_embeddings=32768,
        tie_word_embeddings=False,
    ),
    # google/gemma-2b-it: head dim 256, one KV head; the tied head is
    # GemmaConfig's default.
    "gemma-2b": dict(
        model_type="gemma", vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
        rope_theta=10000.0, rms_norm_eps=1e-6, max_position_embeddings=8192,
        hidden_act="gelu", tie_word_embeddings=True,
    ),
    # google/gemma-2-2b-it: attention softcap 50, final softcap 30,
    # query_pre_attn_scalar 256, a 4096-token window on even layers.
    "gemma2-2b": dict(
        model_type="gemma2", vocab_size=256000, hidden_size=2304, intermediate_size=9216,
        num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4, head_dim=256,
        rope_theta=10000.0, rms_norm_eps=1e-6, max_position_embeddings=8192,
        hidden_activation="gelu_pytorch_tanh", attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=256, sliding_window=4096,
        tie_word_embeddings=True,
    ),
    # mistralai/Mixtral-8x7B-Instruct-v0.1: 8 experts, top 2 (capacity
    # factor 2.0: the JAX package's default).
    "mixtral-8x7b": dict(
        model_type="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        rope_theta=1000000.0, rms_norm_eps=1e-5, max_position_embeddings=32768,
        num_local_experts=8, num_experts_per_tok=2, tie_word_embeddings=False,
    ),
}


def _preset(name: str, overrides: dict) -> ModelConfig:
    cfg = ModelConfig.from_hf(_Attrs(HF_CONFIGS[name]))
    return cfg.replace(**overrides) if overrides else cfg


def qwen2_5_7b(**overrides) -> ModelConfig:
    """Qwen2.5-7B widths (HF_CONFIGS: Qwen/Qwen2.5-7B-Instruct)."""
    return _preset("qwen2.5-7b", overrides)


def gemma_2b(**overrides) -> ModelConfig:
    """Gemma-2B widths (HF_CONFIGS: google/gemma-2b-it)."""
    return _preset("gemma-2b", overrides)


def gemma2_2b(**overrides) -> ModelConfig:
    """Gemma2-2B widths (HF_CONFIGS: google/gemma-2-2b-it)."""
    return _preset("gemma2-2b", overrides)


def mixtral_8x7b(**overrides) -> ModelConfig:
    """Mixtral-8x7B widths (HF_CONFIGS: mistralai/Mixtral-8x7B-Instruct-v0.1)."""
    return _preset("mixtral-8x7b", overrides)
