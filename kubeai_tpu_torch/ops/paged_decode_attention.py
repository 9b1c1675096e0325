"""Dedicated paged-attention kernel for decode (port of
kubeai_tpu/ops/paged_decode_attention.py).

Replaces the Pallas kernel
``kubeai_tpu/ops/paged_decode_attention.py::_decode_kernel`` (launched by
``_decode_kernel_call``) with the hand-written CUDA kernel
``csrc/paged_decode_attention.cu``: the same function as
``paged_attention_ragged`` restricted to S <= 8 queries per slot, with
one block per (KV head, slot) holding the slot's S*G query rows so each
page is read once for all G query heads, walking the page table and
stopping at kv_len.

Bound on the H100: memory (every valid K/V byte read once; ~5 us per
layer call at B=8, kv_len 512). ``paged_decode_attention`` launches the
kernel for CUDA tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.paged_attention import (
    _no_quant,
    launch_paged_kernel,
    paged_attention_plain,
)

# Decode/speculative query lengths the dedicated kernel accepts; "auto"
# dispatch uses the ragged kernel above this.
MAX_DECODE_QUERY_LEN = 8

# Shared memory one block may use on Hopper (227 KB).
_MAX_SMEM = 232448

_SIG = {
    "paged_decode_attention_launch": [_build.PTR] * 5
    + [_build.INT] * 8 + [_build.FLOAT, _build.FLOAT, _build.PTR],
    "paged_decode_smem_bytes": [_build.INT, _build.INT],
}


def resolve_decode_kernel(mode: str, query_len: int) -> str:
    """Map EngineConfig.decode_kernel to a concrete kernel for a decode
    dispatch of *query_len* tokens per slot: "auto" takes the dedicated
    kernel up to MAX_DECODE_QUERY_LEN and the ragged one above."""
    if mode == "dedicated":
        return "dedicated"
    if mode == "auto":
        return "dedicated" if query_len <= MAX_DECODE_QUERY_LEN else "ragged"
    return "ragged"


def paged_decode_attention(
    q: torch.Tensor,  # [B, S, H, h] — S = 1 (decode) or G+1 (speculative)
    kv_pages: torch.Tensor,  # [P, page, 2*Kv, h] (K even, V odd)
    page_table: torch.Tensor,  # [B, max_pages] int32
    kv_lengths: torch.Tensor,  # [B] valid keys INCLUDING the S new tokens
    scale: float | None = None,
    softcap: float = 0.0,
    k_scale: float | None = None,
    v_scale: float | None = None,
) -> torch.Tensor:
    """Returns the [B, S, H, h] attention output (the same contract as
    paged_attention_ragged, finished-slot length clamp included)."""
    _no_quant(k_scale, v_scale)
    B, S, H, h = q.shape
    if scale is None:
        scale = h**-0.5
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pages, page_table, kv_lengths, scale, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    if S > MAX_DECODE_QUERY_LEN:
        raise ValueError(
            f"paged_decode_attention: S={S} > {MAX_DECODE_QUERY_LEN} queries per slot"
        )
    lib = _build.load("paged_decode_attention", _SIG)
    Kv = kv_pages.shape[2] // 2
    smem = lib.paged_decode_smem_bytes(S * (H // max(Kv, 1)), h)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"paged_decode_attention: {S} queries x {H // Kv} heads per KV head "
            f"need {smem} bytes of shared memory (> {_MAX_SMEM})"
        )
    out = launch_paged_kernel(
        lib, "paged_decode_attention_launch", "paged_decode_attention",
        q, kv_pages, page_table, kv_lengths, scale, softcap,
    )
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

