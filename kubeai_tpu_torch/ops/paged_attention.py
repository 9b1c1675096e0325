"""Paged attention over the interleaved KV pool (port of
kubeai_tpu/ops/paged_attention.py).

Replaces the library Pallas kernel
``jax.experimental.pallas.ops.tpu.ragged_paged_attention``, which
``kubeai_tpu/ops/paged_attention.py::paged_attention_ragged`` calls, with
the hand-written CUDA kernel ``csrc/paged_attention.cu``. KV lives as
[P, page, 2*Kv, h] pages with K at even and V at odd head indices; a
block table maps each slot's positions onto pages; each slot's S queries
(1 for decode, a bucket or chunk for prefill) sit at positions
kv_len-S .. kv_len-1 and attend causally, reading pages in place.

Bound on the H100: memory for decode (B=8, kv_len 512: ~16.8 MB per
layer call, ~5 us at 3.35 TB/s), the tensor-core rate for 1024-token
chunks. For bf16 the kernel has two regimes, chosen here from the rows
per (slot, KV head), S*G (:func:`ragged_regime`): split-KV decode on the
tensor cores below 64 rows (a decode step, or a speculative verify step
of up to 15 tokens at 4 query heads per KV head), whose number of splits
:func:`split_kv_plan` chooses so that the grid fills the card, and from
64 rows the prefill tile (the flash kernel's, keys found through the
page table).
float32 keeps a CUDA-core tile. Its source says what each design does.

A pool in one byte per element (int8 or float8_e4m3fn, the JAX
package's ``--kv-cache-dtype int8|fp8``) holds K/V divided by the static
scales ``k_scale`` / ``v_scale``; every regime reads its pages at one
byte per element and dequantizes on the card. The plain version follows
the JAX package's CPU twin: (x as float32 * scale) in q's dtype.

``paged_attention_ragged`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import collections
import functools

import torch

from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.attention import attention

_SIG = {
    "paged_attention_launch": [_build.PTR] * 8
    + [_build.INT] * 11 + [_build.FLOAT] * 4 + [_build.PTR],
    "paged_attention_split_smem_bytes": [_build.INT] * 4,
}

# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232448

# Pool dtypes stored at one byte per element and dequantized on read.
QUANT_POOL_DTYPES = (torch.int8, torch.float8_e4m3fn)
# Head dim whose one-byte instances live in a library of their own (the
# same source built with KATTN_ONE_BYTE_D32: in the main library they
# doubled its build time), loaded at first use.
SMALL_QUANT_HEAD_DIM = 32


def library(name: str, h: int, pool_code: int) -> str:
    """The library of paged kernel *name* for head dim *h* and a pool of
    element code *pool_code* (_build.POOL_*): the "_q8d32" one for a
    one-byte pool at head dim 32, the "_d256" one at head dim 256."""
    if pool_code != _build.POOL_SAME and h == SMALL_QUANT_HEAD_DIM:
        return f"{name}_q8d32"
    return _build.attention_library(name, h)

# bf16 launches with at most this many query rows per (slot, KV head),
# S*G, take the split-KV decode regime (up to four m16 tiles of mma.sync).
SPLIT_MAX_ROWS = 64
# Keys of one 64-row page-sized tile of the prefill tile.
TILE_KEYS = 64
# Keys of the shortest split (split_chunk's multiple of 16): the table
# span in such pieces bounds the number of splits.
SPLIT_KEYS = 16
# The decode grid aims at this many blocks per SM. Each warp of a block
# keeps two slices of K/V copies in flight (~67 KB of shared memory a
# block, three blocks fit an SM), which two blocks per SM already make
# enough for the memory; more splits only add partials to merge and a
# second wave. chip_smoke.py times the choice against others
# ("split_sweep").
SPLIT_BLOCKS_PER_SM = 2
# Splits per slot the kernel takes at most (its merge holds every
# split's (m, l) in shared memory).
MAX_SPLITS = 64


def split_kv_plan(B: int, Kv: int, max_pages: int, page: int, sm_count: int) -> int:
    """Splits per (slot, KV head) of the decode regime: as many as keep
    B*Kv*n_splits within SPLIT_BLOCKS_PER_SM * sm_count blocks, at least
    one, at most one per SPLIT_KEYS keys of the table span (the shortest
    split the kernel takes) and at most MAX_SPLITS. The kernel cuts each
    slot's own kv_len into that many pieces (split_chunk). With one KV
    head (Gemma-2B) a short table still fills the card."""
    tiles = max(1, -(-max_pages * page // SPLIT_KEYS))
    want = SPLIT_BLOCKS_PER_SM * sm_count // (B * Kv)
    return max(1, min(tiles, want, MAX_SPLITS))


def split_chunk(kv_len: int, n_splits: int) -> int:
    """Keys per split for a slot of *kv_len* keys: kv_len / n_splits
    rounded up to a multiple of 16, so a split may end inside a page (the
    kernel's own rule, csrc/paged_attention.cu::split_chunk). Splits that
    start past kv_len have no keys and take no part in the merge."""
    c = -(-kv_len // n_splits)
    return max(16, -(-c // 16) * 16)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_kv_setup(q, Kv: int, max_pages: int, page: int, R: int, n_splits=None,
                    groups: int = 1):
    """(n_splits, partials, (m, l) pairs, counters) of a split-KV decode
    launch with *groups* groups of R query rows per (slot, KV head), each
    its own set of blocks: :func:`split_kv_plan`'s choice for that many
    blocks unless *n_splits* is given, and the current stream's scratch
    (f32, f32 and int32, at least groups times B*Kv*n_splits*R*h,
    2*B*Kv*n_splits*R and B*Kv long), which the ragged kernel's decode
    regime and the dedicated decode kernel share. The counters outlive a
    launch on purpose: each launch leaves them zero again, in stream
    order, so they are zeroed once, when allocated, and no launch pays a
    second kernel to clear them. The scratch grows on demand, except on
    a stream whose CUDA graph holds it (_build.scratch)."""
    B, h = q.shape[0], q.shape[-1]
    if n_splits is None:
        dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
        n_splits = split_kv_plan(B * groups, Kv, max_pages, page, _sm_count(dev))
    n = groups * B * Kv
    want = (n * n_splits * R * h, 2 * n * n_splits * R, n)

    def make(size):
        return (
            torch.empty(size[0], dtype=torch.float32, device=q.device),
            torch.empty(size[1], dtype=torch.float32, device=q.device),
            torch.zeros(size[2], dtype=torch.int32, device=q.device),
        )

    return (n_splits, *_build.scratch(q.device, "split_kv", want, make))


def paged_attention_plain(q, kv_pages, page_table, kv_lengths, scale=None, softcap=0.0,
                          k_scale=None, v_scale=None):
    """The plain PyTorch version (the JAX package's ``_cpu_twin``): gather
    the table's pages into a contiguous view and run masked attention with
    queries at positions kv_len - S + s. kv_len is clamped to the table
    span first (a finished slot's decode overrun). A quantized pool (or a
    given scale) dequantizes as the twin does, (x as float32 * scale) in
    q's dtype; a one-byte pool without scales reads with 1.0."""
    B, S, H, h = q.shape
    max_pages = page_table.shape[1]
    page = kv_pages.shape[1]
    Kv = kv_pages.shape[2] // 2
    skv = max_pages * page
    kv_lens = torch.clamp(kv_lengths.to(torch.int64), max=skv)
    gathered = kv_pages[page_table.long()]  # [B, mp, page, 2Kv, h]
    k_att = gathered[..., 0::2, :].reshape(B, skv, Kv, h)
    v_att = gathered[..., 1::2, :].reshape(B, skv, Kv, h)
    quant = kv_pages.dtype in QUANT_POOL_DTYPES
    if quant or k_scale is not None:
        k_att = (k_att.float() * (1.0 if k_scale is None else k_scale)).to(q.dtype)
    if quant or v_scale is not None:
        v_att = (v_att.float() * (1.0 if v_scale is None else v_scale)).to(q.dtype)
    pos_q = kv_lens[:, None] - S + torch.arange(S, device=q.device)[None, :]
    mask = torch.arange(skv, device=q.device)[None, None, :] <= pos_q[:, :, None]
    return attention(q, k_att, v_att, mask, scale=scale, softcap=softcap)


def _or_one(scale) -> float:
    return 1.0 if scale is None else float(scale)


def check_paged_inputs(what: str, q, kv_pages, page_table, kv_lengths):
    """Shared argument checks of the two paged kernels (the ragged one
    here and the dedicated decode one). Returns (int32 lengths, dtype
    code, pool element code)."""
    B, S, H, h = q.shape
    P, page, two_kv, h2 = kv_pages.shape
    Kv = two_kv // 2
    if h2 != h or two_kv % 2 or H % Kv or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(
            f"{what}: bad shapes q{tuple(q.shape)} pool{tuple(kv_pages.shape)} "
            f"table{tuple(page_table.shape)}"
        )
    if kv_lengths.shape != (B,):
        raise ValueError(f"{what}: kv_lengths must be [B], got {tuple(kv_lengths.shape)}")
    lens = kv_lengths.to(torch.int32).contiguous()
    dtype, pool_code = _build.check_cuda_inputs(
        what, h, {"q": q}, {"page_table": page_table, "kv_lengths": lens},
        pool={"kv_pages": kv_pages},
    )
    return lens, dtype, pool_code


def ragged_regime(q, kv_pages) -> str:
    """The tile the kernel runs for these inputs: "prefill_tile" (bf16
    from 64 rows per (slot, KV head), at most 64 query heads per KV head
    (a tile takes 64/G whole positions, G*floor(64/G) rows), pages of 8
    rows or more that tile 64 keys evenly: csrc/paged_attention.cu's
    rule; at 64 rows it took under half the split-KV body's time on the
    H100, PERF.md §6), else "split_kv" (bf16 up to SPLIT_MAX_ROWS rows),
    else "cuda_core"."""
    _, S, H, _ = q.shape
    page, G = kv_pages.shape[1], H // (kv_pages.shape[2] // 2)
    if q.dtype == torch.bfloat16:
        tma_pages = page % 8 == 0 and (TILE_KEYS % page == 0 or page % TILE_KEYS == 0)
        if S * G >= 64 and G <= 64 and tma_pages:
            return "prefill_tile"
        if S * G <= SPLIT_MAX_ROWS:
            return "split_kv"
    return "cuda_core"


def _launch_ragged(q, kv_pages, page_table, kv_lengths, scale, softcap, n_splits=None,
                   k_scale=None, v_scale=None, split_kv=None):
    """One launch of the kernel; *n_splits* overrides the split-KV
    regime's split choice and *split_kv* the choice of that regime
    (chip_smoke.py times both against others). A scale not given is 1."""
    lens, dtype, pool_code = check_paged_inputs(
        "paged_attention_ragged", q, kv_pages, page_table, kv_lengths)
    B, S, H, h = q.shape
    P, page, two_kv, _ = kv_pages.shape
    Kv, max_pages = two_kv // 2, page_table.shape[1]
    R = S * (H // Kv)
    if split_kv is None:
        split_kv = ragged_regime(q, kv_pages) == "split_kv"
    part = ml = cnt = lens  # used by the split-KV regime alone
    lib = _build.load(library("paged_attention", h, pool_code), _SIG)
    if q.dtype != torch.bfloat16 or not split_kv:
        n_splits = 0  # the prefill tile or the CUDA-core tile
    else:
        if R > SPLIT_MAX_ROWS:
            raise ValueError(f"paged_attention_ragged: split KV takes at most "
                             f"{SPLIT_MAX_ROWS} rows, got {R}")
        n_splits, part, ml, cnt = _split_kv_setup(q, Kv, max_pages, page, R, n_splits)
        smem = lib.paged_attention_split_smem_bytes(R, h, n_splits, pool_code)
        if smem > MAX_SMEM:
            raise ValueError(f"paged_attention_ragged: {R} rows x {n_splits} splits need "
                             f"{smem} bytes of shared memory (> {MAX_SMEM})")
    out = torch.empty_like(q)
    err = lib.paged_attention_launch(
        q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), ml.data_ptr(), cnt.data_ptr(),
        B, S, H, Kv, h, P, page, max_pages, n_splits, dtype, pool_code,
        float(scale), float(softcap), _or_one(k_scale), _or_one(v_scale), _build.stream_of(q),
    )
    _build.check(err, "paged_attention_ragged")
    return out


def paged_attention_ragged(
    q: torch.Tensor,  # [B, S, H, h] the slots' newest S queries
    kv_pages: torch.Tensor,  # [P, page, 2*Kv, h] (K even, V odd)
    page_table: torch.Tensor,  # [B, max_pages] int32
    kv_lengths: torch.Tensor,  # [B] valid keys INCLUDING the S new tokens
    scale: float | None = None,
    softcap: float = 0.0,
    k_scale: float | None = None,
    v_scale: float | None = None,
) -> torch.Tensor:
    """Returns the [B, S, H, h] attention output. *k_scale* / *v_scale*
    dequantize a one-byte pool (static per-tensor scales)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pages, page_table, kv_lengths, scale, softcap,
                                     k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_ragged: unsupported device {q.device}")
    regime = ragged_regime(q, kv_pages)
    out = _launch_ragged(q, kv_pages, page_table, kv_lengths, scale, softcap,
                         k_scale=k_scale, v_scale=v_scale, split_kv=regime == "split_kv")
    paged_attention_ragged.launches += 1
    paged_attention_ragged.launches_by_pool[str(kv_pages.dtype).removeprefix("torch.")] += 1
    paged_attention_ragged.launches_by_regime[regime] += 1
    return out


paged_attention_ragged.launches = 0
# The same launches by the pool's dtype (a quantized pool's int8 or
# float8_e4m3fn, else q's dtype).
paged_attention_ragged.launches_by_pool = collections.Counter()
# The same launches by the tile they ran (ragged_regime).
paged_attention_ragged.launches_by_regime = collections.Counter()
