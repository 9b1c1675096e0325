"""Flash attention for cold prefill (port of kubeai_tpu/ops/flash_attention.py).

Replaces the Pallas kernel ``kubeai_tpu/ops/flash_attention.py::_flash_kernel``
(launched by ``flash_attention_tpu``) with the hand-written CUDA kernel
``csrc/flash_attention.cu``: causal (or full) GQA attention over
contiguous q [B, S, H, h] and k/v [B, S, Kv, h], online softmax in
float32, key tiles above the diagonal skipped.

Bound on the H100 at the main path's shapes (S=1024, H=32, Kv=8, h=128,
bf16): ~8.6 GFLOP causal against ~20 MB of I/O, so the tensor-core rate
bounds it. bf16 runs on the tensor cores (wgmma, TMA-fed K/V tiles; one
block per 64/G whole positions of one KV head, G*floor(64/G) query rows,
each K/V tile read once for the G heads sharing it; head dims 32 to 256,
256 in a library of its own); float32 keeps the CUDA-core tile (head dims
32 to 128). The source describes both.

``flash_attention`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback between the two.
"""

from __future__ import annotations

import collections

import torch

from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.attention import attention, causal_mask

_SIG = {
    "flash_attention_launch": [_build.PTR] * 4
    + [_build.INT] * 7 + [_build.FLOAT, _build.PTR],
}


def flash_attention_plain(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """The plain PyTorch version: masked GQA attention in float32."""
    B, S = q.shape[0], q.shape[1]
    mask = causal_mask(S, S, device=q.device).expand(B, S, S) if causal else None
    return attention(q, k, v, mask, scale=sm_scale)


def flash_regime(q, k) -> str:
    """The tile the kernel runs: "tensor_core" (bf16 with at most 64 query
    heads per KV head: a tile takes 64/G whole positions, G*floor(64/G)
    rows, so Qwen2.5's G = 7 runs 63 rows of 9 positions), else
    "cuda_core" (csrc/flash_attention.cu's rule)."""
    G = q.shape[2] // k.shape[2]
    return "tensor_core" if q.dtype == torch.bfloat16 and G <= 64 else "cuda_core"


def flash_attention(q, k, v, causal: bool = True, sm_scale: float | None = None):
    """[B, S, H, h] attention output for q [B, S, H, h], k/v [B, S, Kv, h]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, h = q.shape
    Kv = k.shape[2]
    if k.shape != (B, S, Kv, h) or v.shape != k.shape or H % Kv:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    dtype, _ = _build.check_cuda_inputs("flash_attention", h, {"q": q, "k": k, "v": v})
    scale = h**-0.5 if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    lib = _build.load(_build.attention_library("flash_attention", h), _SIG)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, Kv, h, int(causal), dtype, float(scale), _build.stream_of(q),
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_regime[flash_regime(q, k)] += 1
    return out


flash_attention.launches = 0
# The same launches by the tile they ran (flash_regime).
flash_attention.launches_by_regime = collections.Counter()
