"""Rotary position embeddings (port of kubeai_tpu/ops/rope.py).

Inverse frequencies are computed on the host in float64 and stored as
float32, exactly as the JAX package does; ``apply_rope`` rotates in
float32 with the rotate-half formulation (HF Llama).
"""

from __future__ import annotations

import numpy as np
import torch

from kubeai_tpu_torch.models.base import RopeScaling


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    scaling: RopeScaling | None = None,
) -> np.ndarray:
    """Inverse frequencies [head_dim//2], float32, host-side.

    Linear scaling is expressed, as in the JAX package's config loader,
    as llama3 scaling whose low-frequency band covers the whole spectrum
    (a huge ``low_freq_factor``)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is not None:
        low_wavelen = scaling.original_max_position / scaling.low_freq_factor
        high_wavelen = scaling.original_max_position / scaling.high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        smooth = (scaling.original_max_position / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        inv_freq = np.where(
            wavelen > low_wavelen,
            inv_freq / scaling.factor,
            np.where(
                wavelen < high_wavelen,
                inv_freq,
                (1 - smooth) * inv_freq / scaling.factor + smooth * inv_freq,
            ),
        )
    return inv_freq.astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply RoPE to q, k of shape [B, S, heads, head_dim] at *positions* [B, S]."""
    angles = positions[..., None].float() * inv_freq  # [B, S, hd/2]
    emb = torch.cat([angles, angles], dim=-1)
    cos = torch.cos(emb)[:, :, None, :]
    sin = torch.sin(emb)[:, :, None, :]

    def rot(x):
        x32 = x.float()
        return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)

    return rot(q), rot(k)
