"""Weight-only int8 quantization (port of kubeai_tpu/ops/quant.py).

Weights are stored int8 with a float32 scale per output channel (per row
for the embedding table) and dequantized at the product. On the TPU XLA
fuses the int8 -> bf16 convert into the dot's operand read; eager PyTorch
cannot, so on CUDA ``qdot`` and ``qmatT`` launch the hand-written W8A16
kernel ``csrc/w8a16_matmul.cu``, which converts in registers and reads
each weight byte once (the source says how). On the CPU they run the
plain versions, which follow the JAX formula literally; there is no
fallback between the two. ``qgather`` (an embedding row gather, not a
matrix product) is plain PyTorch on both devices, and clamps ids as
JAX's gather does.

Bound on the H100: bytes at decode and verify shapes (M <= 64: the
weights, ~2.2 ms per Llama-3.1-8B step), the tensor cores at prefill.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from kubeai_tpu_torch.ops import _build

QKEY, SKEY = "int8_q", "int8_s"

# Column and K tiles of the kernel (csrc/w8a16_matmul.cu: BN, BK), and
# the rows up to which it runs the weight-read regime (one row block,
# split-K over the column blocks).
BN, BK = 128, 64
MAX_SMALL_M = 64

_SIG = {
    "w8a16_launch": [_build.PTR] * 5 + [_build.INT] * 7 + [_build.PTR],
}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and QKEY in w


def quantize(w, contract_axis: int = -2) -> dict[str, Any]:
    """Symmetric int8 with the absmax reduced only over *contract_axis*
    (the dim a product sums over), so scales stay per output channel and,
    for layer-stacked weights [L, in, out], per layer. numpy in, numpy
    out (the JAX function's host path, bit for bit); a torch tensor gives
    torch tensors on its device, with the same float32 arithmetic (IEEE
    division, round half to even), so the int8 values and scales are the
    JAX function's exactly."""
    if isinstance(w, np.ndarray):
        w32 = w.astype(np.float32)
        amax = np.max(np.abs(w32), axis=contract_axis, keepdims=True)
        scale = np.maximum(amax / 127.0, 1e-12)
        q = np.clip(np.round(w32 / scale), -127, 127).astype(np.int8)
        return {QKEY: q, SKEY: scale.astype(np.float32)}
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32), dim=contract_axis, keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not IEEE division and moves scales by an ulp.
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)
    q = (w32 / scale).round_().clamp_(-127, 127).to(torch.int8)  # in place: one f32 temporary
    return {QKEY: q, SKEY: scale}


def quantize_rows(w) -> dict[str, Any]:
    """Per-row scales (embedding tables: lookups scale row-wise)."""
    return quantize(w, contract_axis=-1)


def dequantize(w: dict[str, torch.Tensor], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (w[QKEY].to(torch.float32) * w[SKEY]).to(dtype)


def qdot_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x @ (q * s) as the JAX package writes it: the product in x's dtype,
    then the scale squeezed over the contracted dim."""
    return (x @ q.to(x.dtype)) * s.squeeze(-2).to(x.dtype)


def qmatT_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x @ (q * s).T for a per-row-quantized table [N, K]."""
    return (x @ q.to(x.dtype).T) * s.squeeze(-1).to(x.dtype)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or quantized weights (q [K, N] int8, s [1, N])."""
    if not is_quantized(w):
        return x @ w
    q, s = w[QKEY], w[SKEY]
    if x.device.type == "cpu":
        return qdot_plain(x, q, s)
    return _launch(x, q, s, layout=0)


def qmatT(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for plain or per-row-quantized tables (the tied lm_head:
    the embedding's rows [N, K] become output channels)."""
    if not is_quantized(w):
        return x @ w.to(x.dtype).T
    q, s = w[QKEY], w[SKEY]
    if x.device.type == "cpu":
        return qmatT_plain(x, q, s)
    return _launch(x, q, s, layout=1)


def qgather(w, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row gather (embedding lookup) for plain or per-row-quantized
    tables. Ids follow JAX's gather: a negative id counts from the end,
    and an id outside the table is clamped to its first or last row (a
    byte tokenizer's BOS 256 over a 256-row table reads row 255). On the
    card an out-of-range index would trip a device-side assert, which
    leaves the process's CUDA context unusable."""
    rows = (w[QKEY] if is_quantized(w) else w).shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + rows, idx).clamp_(0, rows - 1)
    if not is_quantized(w):
        return w.to(dtype)[idx]
    return (w[QKEY][idx].to(torch.float32) * w[SKEY][idx]).to(dtype)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def split_plan(M: int, N: int, K: int, sms: int) -> tuple[int, int]:
    """(splits, k_split) of a launch. M <= 64 runs one row block over
    ceil(N / 128) column blocks; when those cannot give two blocks per
    SM, K is split (each piece at least 4 stages of 64, a multiple of 64)
    and a second kernel reduces the partials. Larger M runs row blocks
    and no split."""
    steps = -(-K // BK)
    if M > MAX_SMALL_M:
        return 1, steps * BK
    n_blocks = -(-N // BN)
    want = max(1, min(-(-2 * sms // n_blocks), steps // 4))
    k_split = -(-steps // want) * BK
    return -(-K // k_split), k_split


def _launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, layout: int) -> torch.Tensor:
    """One kernel launch for x [..., K] bf16 and a 2-D int8 weight: layout
    0 is q [K, N] with s [1, N], layout 1 is q [N, K] with s [N, 1]."""
    what = "qmatT" if layout else "qdot"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the W8A16 kernel takes bfloat16 activations, got {x.dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"{what}: weights must be int8 with float32 scales, got {q.dtype}, {s.dtype}")
    if q.dim() != 2:
        raise ValueError(f"{what}: the kernel takes one 2-D weight, got shape {tuple(q.shape)}")
    K = x.shape[-1]
    N = q.shape[1] if layout == 0 else q.shape[0]
    if (q.shape[0] if layout == 0 else q.shape[1]) != K or s.numel() != N:
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)} do not match"
        )
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y.reshape(*x.shape[:-1], N)
    # 16-byte copies where every base and row stride allows them, else 4.
    aligns = (x2.data_ptr(), 2 * K, q.data_ptr(), N if layout == 0 else K, s.data_ptr())
    vec = 16 if all(a % 16 == 0 for a in aligns) else 4
    if any(a % vec for a in aligns):
        raise ValueError(
            f"{what}: x, q and s need 4-byte aligned bases and rows "
            f"(x rows {2 * K} bytes, q rows {aligns[3]} bytes)"
        )
    splits, k_split = split_plan(M, N, K, _sm_count(x.device.index or 0))
    part = y if splits == 1 else torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    lib = _build.load("w8a16_matmul", _SIG)
    err = lib.w8a16_launch(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), part.data_ptr(),
        M, N, K, layout, k_split, splits, vec, _build.stream_of(x),
    )
    _build.check(err, what)
    qdot.launches += 1
    return y.reshape(*x.shape[:-1], N)


# Kernel launches through qdot and qmatT together.
qdot.launches = 0
