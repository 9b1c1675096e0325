"""Dedicated paged-attention kernel for decode (port of
kubeai_tpu/ops/paged_decode_attention.py).

Replaces the Pallas kernel
``kubeai_tpu/ops/paged_decode_attention.py::_decode_kernel`` (launched by
``_decode_kernel_call``) with the hand-written CUDA kernel
``csrc/paged_decode_attention.cu``: the same function as
``paged_attention_ragged`` for the few queries per slot of a decode (S =
1) or speculative verify step (S = G+1, any G, as the Pallas kernel
takes). For bf16 it runs split KV on the tensor cores
(``csrc/split_kv_decode.cuh``, shared with the ragged kernel's decode
regime): each slot's keys are cut into the splits that
:func:`~kubeai_tpu_torch.ops.paged_attention.split_kv_plan` chooses here,
and the S*G query rows of a (slot, KV head) go in groups of at most 64
(:func:`row_groups`), each group one, two or four 16-row tiles. float32
keeps a simple CUDA-core kernel, one block per (KV head, slot, row
group). The source says what each design does.

Bound on the H100: memory (every valid K/V byte read once; ~5 us per
layer call at B=8, kv_len 512; half that for a one-byte pool, int8 or
float8_e4m3fn, which the kernel dequantizes with the static ``k_scale`` /
``v_scale``). ``paged_decode_attention`` launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; there
is no fallback between them.
"""

from __future__ import annotations

import collections

import torch

from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.paged_attention import (
    MAX_SMEM,
    _or_one,
    _split_kv_setup,
    check_paged_inputs,
    library,
    paged_attention_plain,
)

# "auto" dispatch takes the dedicated kernel up to this many queries per
# slot and the ragged one above (the JAX package's threshold); the
# dedicated kernel itself takes any number.
MAX_DECODE_QUERY_LEN = 8

# Query rows per block: four 16-row tiles (S = 16 at G = 4). A (slot, KV
# head) with more rows takes several groups of blocks.
MAX_ROWS = 64

_SIG = {
    "paged_decode_attention_launch": [_build.PTR] * 8
    + [_build.INT] * 11 + [_build.FLOAT] * 4 + [_build.PTR],
    "paged_decode_smem_bytes": [_build.INT] * 5,
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


def row_groups(R: int) -> tuple[int, int]:
    """(groups, rows per group) of a (slot, KV head)'s R query rows: runs
    of MAX_ROWS consecutive rows, the last one shorter."""
    rows = min(R, MAX_ROWS)
    return -(-R // rows), rows


def _launch_dedicated(q, kv_pages, page_table, kv_lengths, scale, softcap, n_splits=None,
                      k_scale=None, v_scale=None):
    """One launch of the kernel; *n_splits* overrides the bf16 split
    choice (chip_smoke.py times the choice against others)."""
    B, S, H, h = q.shape
    lens, dtype, pool_code = check_paged_inputs(
        "paged_decode_attention", q, kv_pages, page_table, kv_lengths)
    page, Kv, max_pages = kv_pages.shape[1], kv_pages.shape[2] // 2, page_table.shape[1]
    groups, rows = row_groups(S * (H // Kv))
    part = ml = cnt = lens  # used by the bf16 kernel alone
    if q.dtype != torch.bfloat16:
        n_splits = 1
    else:
        n_splits, part, ml, cnt = _split_kv_setup(q, Kv, max_pages, page, rows, n_splits,
                                                  groups)
    lib = _build.load(library("paged_decode_attention", h, pool_code), _SIG)
    smem = lib.paged_decode_smem_bytes(rows, h, n_splits, dtype, pool_code)
    if smem > MAX_SMEM:
        raise ValueError(
            f"paged_decode_attention: {rows} rows x {n_splits} splits need {smem} bytes "
            f"of shared memory (> {MAX_SMEM})"
        )
    out = torch.empty_like(q)
    err = lib.paged_decode_attention_launch(
        q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), ml.data_ptr(), cnt.data_ptr(),
        B, S, H, Kv, h, page, max_pages, n_splits, rows, dtype, pool_code,
        float(scale), float(softcap), _or_one(k_scale), _or_one(v_scale), _build.stream_of(q),
    )
    _build.check(err, "paged_decode_attention")
    return out


def paged_decode_attention(
    q: torch.Tensor,  # [B, S, H, h] — S = 1 (decode) or G+1 (speculative, any G)
    kv_pages: torch.Tensor,  # [P, page, 2*Kv, h] (K even, V odd)
    page_table: torch.Tensor,  # [B, max_pages] int32
    kv_lengths: torch.Tensor,  # [B] valid keys INCLUDING the S new tokens
    scale: float | None = None,
    softcap: float = 0.0,
    k_scale: float | None = None,
    v_scale: float | None = None,
) -> torch.Tensor:
    """Returns the [B, S, H, h] attention output (the same contract as
    paged_attention_ragged, finished-slot length clamp and one-byte pools
    included)."""
    B, S, H, h = q.shape
    if scale is None:
        scale = h**-0.5
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pages, page_table, kv_lengths, scale, softcap,
                                     k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    out = _launch_dedicated(q, kv_pages, page_table, kv_lengths, scale, softcap,
                            k_scale=k_scale, v_scale=v_scale)
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_pool[str(kv_pages.dtype).removeprefix("torch.")] += 1
    return out


paged_decode_attention.launches = 0
# The same launches by the pool's dtype (a quantized pool's int8 or
# float8_e4m3fn, else q's dtype).
paged_decode_attention.launches_by_pool = collections.Counter()

