"""Weight-only int8 quantization (port of kubeai_tpu/ops/quant.py).

Weights are stored int8 with a float32 scale per output channel (per row
for the embedding table) and dequantized at the product. On the TPU XLA
fuses the int8 -> bf16 convert into the dot's operand read; eager PyTorch
cannot, so on CUDA ``qdot``, ``qmatT`` and ``qdot_many`` (up to three
weights that share x, one launch) run the hand-written W8A16 kernels of
``csrc/w8a16_matmul.cu``, which convert on the card and read each weight
byte once (the source says how). :func:`regime` picks the kernel from
the rows M: mma.sync weight streaming for decode (M <= 16), a wgmma tile
fed by TMA for verify and prefill, FFMA for float32 activations (the JAX
package computes in x's dtype). On the CPU they run the plain versions,
which follow the JAX formula literally; there is no fallback between the
two. ``qgather`` (an embedding row gather, not a matrix product) is
plain PyTorch on both devices, and clamps ids as JAX's gather does.

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

# Column and K tiles of the kernels (csrc/w8a16_matmul.cu: BN, BK).
BN, BK = 128, 64
# Rows up to which a launch may split K (one row block; the fused
# reduction), and up to which the decode regime (mma.sync) runs.
MAX_SMALL_M = 64
MAX_DECODE_M = 16
# Kernels of the launcher: mma.sync (decode), wgmma + TMA (verify and
# prefill), FFMA (float32 activations).
MMA, WGMMA, FFMA = 0, 1, 2
# Columns per block of the wgmma tile at M <= 64 (64 or 128;
# tools/w8a16_split_sweep.py times both). Larger M takes 128 x 128.
WGMMA_SMALL_BN = 64
# Weights per launch (qdot_many).
MAX_GROUP = 3

_SIG = {
    "w8a16_launch": [_build.PTR, _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
                     _build.INT, _build.INT, _build.INT]
    + ([_build.PTR] * 3 + [_build.INT] * 2) * MAX_GROUP + [_build.PTR] * 3,
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
    return _launch(x, ((q, s),), 0, "qdot")[0]


def qdot_many(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """[x @ w for w in ws]: the projections that share x (wq|wk|wv,
    wg|wu). Quantized weights on CUDA take one launch for up to three of
    them, each output bit-identical to its own qdot (the same kernel and
    split plan, every element summed in the same order); plain weights,
    or weights of other alignment classes, take one product each."""
    if x.device.type == "cpu" or not all(is_quantized(w) for w in ws):
        return [qdot(x, w) for w in ws]
    pairs = [(w[QKEY], w[SKEY]) for w in ws]
    if len({_tma_class(q) for q, _ in pairs}) > 1:
        return [qdot(x, w) for w in ws]
    out = []
    for i in range(0, len(pairs), MAX_GROUP):
        out += _launch(x, pairs[i:i + MAX_GROUP], 0, "qdot_many")
    return out


def qmatT(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T for plain or per-row-quantized tables (the tied lm_head:
    the embedding's rows [N, K] become output channels)."""
    if not is_quantized(w):
        return x @ w.to(x.dtype).T
    q, s = w[QKEY], w[SKEY]
    if x.device.type == "cpu":
        return qmatT_plain(x, q, s)
    return _launch(x, ((q, s),), 1, "qmatT")[0]


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


def _tma_class(q: torch.Tensor) -> bool:
    """Whether a weight's rows sit on TMA's 16-byte grid (base and row
    stride): the wgmma tile's copies need it."""
    return q.data_ptr() % 16 == 0 and q.shape[1] % 16 == 0


def regime(M: int, tma: bool, f32: bool = False, n_cols: int = 0,
           sms: int = 132) -> tuple[int, int, int]:
    """(kernel, rows per block, columns per block) of a launch with M rows
    of x: float32 x takes FFMA tiles of 64 x 64; decode (M <= 16) the
    mma.sync kernel's 16-row tile; larger M the wgmma tile (64 rows up to
    M = 64, else 128) where x and the weight sit on TMA's grid (*tma*),
    else the mma.sync kernel at 16, 32 or 64 rows. The 128-row tile is
    256 columns wide (x read from L2 half as often) unless the launch's
    narrowest weight (*n_cols*; 0: unknown) would then leave more than
    half of the *sms* SMs without a block."""
    if f32:
        return FFMA, 64, 64
    if M <= MAX_DECODE_M:
        return MMA, 16, BN
    if tma:
        if M <= MAX_SMALL_M:
            return WGMMA, 64, WGMMA_SMALL_BN
        wide = not n_cols or -(-M // 128) * -(-n_cols // 256) >= sms // 2
        return WGMMA, 128, 256 if wide else 128
    return MMA, 16 if M <= 16 else 32 if M <= 32 else 64, BN


@functools.lru_cache(maxsize=4096)
def split_plan(M: int, N: int, K: int, sms: int, bn: int = BN,
               blocks_per_sm: int = 2) -> tuple[int, int]:
    """(splits, k_split) of a weight's launch. M <= 64 runs one row block
    over ceil(N / bn) column blocks; when those cannot give
    *blocks_per_sm* blocks per SM, K is split into pieces of k_split (a
    multiple of 64, at least 4 stages deep), and the last block of each
    output tile to finish sums the f32 partials. The split count is also
    held to K / (16 M), so the partials (M * 4 bytes a column per split,
    written and read once) stay within a quarter of the weight's bytes,
    and to 64 KB of partials per output tile, which the last block reads
    back (a few L2 round trips). Larger M runs row blocks and no split."""
    steps = -(-K // BK)
    if M > MAX_SMALL_M:
        return 1, steps * BK
    n_blocks = -(-N // bn)
    want = max(1, min(-(-blocks_per_sm * sms // n_blocks), steps // 4, K // (16 * M),
                      (64 << 10) // (4 * M * bn)))
    k_split = -(-steps // want) * BK
    return -(-K // k_split), k_split


# Blocks per SM that each kernel's shared memory allows, the split plan's
# target (mma.sync: 4 stages of ~24 KB; wgmma at 64 rows: 96 KB or 64 KB).
_BLOCKS_PER_SM = {(MMA, BN): 2, (WGMMA, 128): 2, (WGMMA, 64): 3}


@functools.lru_cache(maxsize=4096)
def _plan(M: int, N: int, K: int, tma: bool, f32: bool, sms: int, n_cols: int = 0):
    """(kernel, bm, bn, splits, k_split) of one weight's launch among
    weights whose narrowest has *n_cols* columns (its own N alone)."""
    kernel, bm, bn = regime(M, tma, f32, n_cols or N, sms)
    if kernel == FFMA:
        return kernel, bm, bn, 1, -(-K // BK) * BK
    return (kernel, bm, bn) + split_plan(M, N, K, sms, bn, _BLOCKS_PER_SM.get((kernel, bn), 1))


# Checked weights, by (pointer, dtype, shape, strides, scale pointer,
# layout): (N, q pointer, s pointer, TMA class, 16-byte class). A model's
# step names the same per-layer views every step, so each is checked once.
_weights: dict = {}

_lib = None


def reserve_workspace(device: torch.device, parts: int, counters: int) -> tuple:
    """The current stream's split-K workspace on *device* (f32 partials,
    int32 counters), grown to hold at least *parts* floats and *counters*
    counters. The counters are zeroed when allocated and every launch
    leaves them zero, in stream order. A CUDA graph that captures
    launches reserves its capture stream's workspace first (an eager run
    on that stream) and then holds it: _build.scratch refuses to grow it."""
    def make(size):
        return (torch.empty(max(size[0], 1), dtype=torch.float32, device=device),
                torch.zeros(max(size[1], 1), dtype=torch.int32, device=device))

    return _build.scratch(device, "w8a16", (parts, counters), make)


def _check_weight(q, s, layout: int, K: int, device, what: str):
    key = (q.data_ptr(), q.dtype, q.shape, q.stride(), s.data_ptr(), layout)
    info = _weights.get(key)
    if info is not None:
        return info
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"{what}: weights must be int8 with float32 scales, got {q.dtype}, {s.dtype}")
    if q.dim() != 2:
        raise ValueError(f"{what}: the kernel takes 2-D weights, got shape {tuple(q.shape)}")
    N = q.shape[1] if layout == 0 else q.shape[0]
    if (q.shape[0] if layout == 0 else q.shape[1]) != K or s.numel() != N:
        raise ValueError(f"{what}: x [..., {K}], q {tuple(q.shape)}, s {tuple(s.shape)} do not match")
    for name, t in (("q", q), ("s", s)):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    row = q.shape[1]
    if q.data_ptr() % 4 or row % 4 or s.data_ptr() % 4:
        raise ValueError(f"{what}: x, q and s need 4-byte aligned bases and rows "
                         f"(q rows {row} bytes)")
    info = (N, q.data_ptr(), s.data_ptr(), _tma_class(q),
            q.data_ptr() % 16 == 0 and row % 16 == 0)
    if len(_weights) > 4096:
        _weights.clear()
    _weights[key] = info
    return info


def _launch(x: torch.Tensor, pairs, layout: int, what: str) -> list[torch.Tensor]:
    """One kernel launch for x [..., K] (bf16 or float32) and up to three
    2-D int8 weights that share it: layout 0 is q [K, N] with s [1, N],
    layout 1 is q [N, K] with s [N, 1]. Returns each [..., N] in x's
    dtype."""
    global _lib
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    dt = x.dtype
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise ValueError(f"{what}: the W8A16 kernels take bfloat16 or float32 activations, "
                         f"got {dt}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    K = x.shape[-1]
    infos = [_check_weight(q, s, layout, K, dev, what) for q, s in pairs]
    lead = x.shape[:-1]
    M = x.numel() // K if K else 0
    ys = [torch.empty((*lead, info[0]), dtype=dt, device=dev) for info in infos]
    if M == 0:
        return ys
    xp = x.data_ptr()
    if xp % 4 or (K * x.element_size()) % 4:
        raise ValueError(f"{what}: x, q and s need 4-byte aligned bases and rows "
                         f"(x rows {K * x.element_size()} bytes)")
    x16 = xp % 16 == 0 and (K * x.element_size()) % 16 == 0
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sm_count(index)
    tma = x16 and all(info[3] for info in infos)
    n_cols = min(info[0] for info in infos)
    plans = [_plan(M, info[0], K, tma, dt is torch.float32, sms, n_cols) for info in infos]
    kernel, bm, bn = plans[0][:3]
    vec = 16 if x16 and all(info[4] for info in infos) else 4
    args = []
    parts = counters = 0
    for info, y, (_, _, _, splits, k_split) in zip(infos, ys, plans):
        args += [info[1], info[2], y.data_ptr(), info[0], k_split]
        if splits > 1:
            parts += -(-splits * M * info[0] // 4) * 4  # each weight's at 16 bytes
            counters += -(-M // bm) * -(-info[0] // bn)
    args += [0, 0, 0, 0, BK] * (MAX_GROUP - len(infos))
    part = cnt = 0
    if parts:
        ws = reserve_workspace(dev, parts, counters)
        part, cnt = ws[0].data_ptr(), ws[1].data_ptr()
    if _lib is None:
        _lib = _build.load("w8a16_matmul", _SIG)
    err = _lib.w8a16_launch(xp, M, K, layout, kernel, bm, bn, vec, len(infos), *args, part, cnt,
                            _build.stream_key(dev)[1])
    _build.check(err, what)
    qdot.launches += 1
    if len(infos) > 1:
        qdot_many.launches += 1
    return ys


# Kernel launches through qdot, qdot_many and qmatT together (a grouped
# launch counts once), and the grouped launches among them.
qdot.launches = 0
qdot_many.launches = 0
