"""Model configuration (port of kubeai_tpu/models/base.py).

The port keeps its own copy: the JAX module imports ``ops/rope.py`` and
with it ``jax.numpy``. Field names and defaults are the same, so a
config converts field by field (``ModelConfig(**dataclasses.asdict(c))``).
"""

from __future__ import annotations

import dataclasses
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
    # Variants the JAX package serves; the port raises NotImplementedError
    # on each until its ROADMAP item lands (see models/llama.py).
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

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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
