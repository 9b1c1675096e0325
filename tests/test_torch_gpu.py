"""The port's CUDA kernels on the card (marker `gpu`), each against its
plain PyTorch version on the same inputs. They skip where no CUDA card
is present. The card's machine has no JAX, so this file imports none and
runs without the suite's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import pytest
import torch

from kubeai_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    MAX_DECODE_QUERY_LEN,
    paged_decode_attention,
)
from kubeai_tpu_torch.ops.quant import qdot, qdot_many, qmatT, quantize, quantize_rows


@pytest.fixture
def cuda():
    # Decided at run time, never at collection: every worker collects the
    # same tests whether or not it has a card.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# One bf16 rounding of the output (2^-8 relative) plus float32
# summation order; float32 kernels are held to summation order alone.
def _assert_close(got, want, dtype):
    if dtype == torch.bfloat16:
        err = (got.float() - want).abs() - (2.0**-8 * want.abs() + 1e-3)
        assert err.max().item() <= 0, err.max().item()
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "S,H,Kv,h,causal",
    [
        (300, 8, 2, 128, True), (64, 4, 4, 64, False), (256, 4, 2, 32, True),
        (1024, 32, 8, 128, True), (256, 32, 8, 128, True), (768, 32, 8, 128, True),
    ],
)
def test_flash_kernel_matches_plain(cuda, dtype, S, H, Kv, h, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, S, H, h), generator=g, device=cuda).to(dtype)
    k = torch.randn((2, S, Kv, h), generator=g, device=cuda).to(dtype)
    v = torch.randn((2, S, Kv, h), generator=g, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(got, flash_attention_plain(q.float(), k.float(), v.float(), causal), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,Kv,h,page,lens,softcap",
    [
        (8, 1, 32, 8, 128, 64, [1, 63, 64, 65, 300, 511, 700, 2048], 0.0),
        (2, 4, 8, 2, 128, 16, [19, 45], 0.0),
        (2, 2, 4, 2, 64, 16, [30, 61], 30.0),
        (4, 1, 4, 2, 32, 16, [1, 17, 100, 256], 0.0),
        (1, 128, 32, 8, 128, 64, [128], 0.0),
        (1, 1024, 32, 8, 128, 64, [2048], 0.0),
        (1, 3, 4, 2, 128, 16, [5000], 0.0),  # overrun: clamped to the table span
        (1, 128, 32, 8, 128, 16, [300], 0.0),  # prefill tile of 4 page-16 boxes
        (2, 64, 32, 8, 128, 64, [300, 77], 30.0),  # prefill tiles with softcap
    ],
)
def test_paged_kernels_match_plain(cuda, dtype, B, S, H, Kv, h, page, lens, softcap):
    g = torch.Generator(device=cuda).manual_seed(1)
    mp = -(-min(max(lens), 2048) // page)
    P = 1 + B * mp
    pool = torch.randn((P, page, 2 * Kv, h), generator=g, device=cuda).to(dtype)
    table = (torch.randperm(P - 1, generator=g, device=cuda)[: B * mp] + 1).reshape(B, mp).to(torch.int32)
    q = torch.randn((B, S, H, h), generator=g, device=cuda).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = paged_attention_plain(q.float(), pool.float(), table, kv_lens, h**-0.5, softcap)
    fns = [paged_attention_ragged] + ([paged_decode_attention] if S <= MAX_DECODE_QUERY_LEN else [])
    for fn in fns:
        before = fn.launches
        got = fn(q, pool, table, kv_lens, softcap=softcap)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_decode_uneven_splits(cuda, dtype):
    """Decode over a 4096-key table at B=8 (bf16: split KV, 4 splits per
    slot, many slices per split for the long slots, slots whose kv_lens
    end in different splits; float32: the CUDA-core tile)."""
    from kubeai_tpu_torch.ops.paged_attention import split_kv_plan

    B, H, Kv, h, page, mp = 8, 32, 8, 128, 64, 64
    lens = [1, 100, 1000, 2047, 2048, 3000, 4000, 4096]
    assert split_kv_plan(B, Kv, mp, page, 132) == 4
    g = torch.Generator(device=cuda).manual_seed(2)
    P = 1 + B * mp
    pool = torch.randn((P, page, 2 * Kv, h), generator=g, device=cuda).to(dtype)
    table = (torch.randperm(P - 1, generator=g, device=cuda) + 1).reshape(B, mp).to(torch.int32)
    q = torch.randn((B, 1, H, h), generator=g, device=cuda).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = paged_attention_plain(q.float(), pool.float(), table, kv_lens, h**-0.5)
    for _ in range(2):  # the second launch finds the counters the first left
        got = paged_attention_ragged(q, pool, table, kv_lens)
        torch.cuda.synchronize()
        _assert_close(got, want, dtype)


def _decode_case(cuda, dtype, B, S, H, Kv, lens, seed, h=128, page=64, mp=32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = 1 + B * mp
    pool = torch.randn((P, page, 2 * Kv, h), generator=g, device=cuda).to(dtype)
    table = (torch.randperm(P - 1, generator=g, device=cuda) + 1).reshape(B, mp).to(torch.int32)
    q = torch.randn((B, S, H, h), generator=g, device=cuda).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = paged_attention_plain(q.float(), pool.float(), table, kv_lens, h**-0.5)
    return q, pool, table, kv_lens, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "S,H,lens",
    [
        (2, 32, [2, 17, 64, 65, 300, 777, 1500, 2048]),  # 8 rows: one m16 tile
        (5, 32, [5, 40, 129, 511, 512, 1024, 1999, 2048]),  # 20 rows: two tiles
        (8, 32, [8, 9, 100, 256, 640, 1300, 2047, 2048]),  # 32 rows: two tiles
        (8, 64, [8, 70, 300, 2048]),  # G = 8, 64 rows: four tiles
    ],
)
def test_dedicated_decode_main_widths(cuda, dtype, S, H, lens):
    """The dedicated kernel at the main path's widths (Kv=8, h=128, page
    64, a 2048-key table) for S up to 8, slots of uneven lengths."""
    q, pool, table, kv_lens, want = _decode_case(cuda, dtype, len(lens), S, H, 8, lens, seed=3)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, pool, table, kv_lens)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    _assert_close(got, want, dtype)


@pytest.mark.gpu
def test_decode_kernels_share_counters(cuda):
    """The two split-KV kernels share one scratch per stream: every launch
    must leave its counters at zero for the next, in stream order. Two
    dedicated launches back to back, then a ragged launch between two
    dedicated ones, each checked against its plain version, then the
    counters."""
    from kubeai_tpu_torch.ops import _build

    dtype = torch.bfloat16
    lens = [8, 300, 511, 2048, 1000, 64, 65, 1]
    q8, pool, table, kv_lens, want8 = _decode_case(cuda, dtype, 8, 8, 32, 8,
                                                   [max(n, 8) for n in lens], seed=4)
    q1 = q8[:, -1:].contiguous()
    want1 = paged_attention_plain(q1.float(), pool.float(), table, kv_lens, 128**-0.5)
    runs = [(paged_decode_attention, q8, want8), (paged_decode_attention, q1, want1),
            (paged_decode_attention, q8, want8), (paged_attention_ragged, q1, want1),
            (paged_decode_attention, q8, want8)]
    outs = [fn(q, pool, table, kv_lens) for fn, q, _ in runs]
    torch.cuda.synchronize()
    for got, (_, _, want) in zip(outs, runs):
        _assert_close(got, want, dtype)
    counters = _build._stream_scratch[_build.stream_key(q8.device)]["split_kv"][2]
    assert int(counters.abs().sum().item()) == 0


def _verify_case(cuda, dtype, kv, B, S, H, Kv, h, page, lens, seed):
    """q, a pool (bf16/float32 in q's dtype, or one byte per element:
    KV_QUANT), a shuffled table, lengths, the pool's scales and the plain
    version's output in float32."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    mp = -(-max(lens) // page)
    P = 1 + B * mp
    if kv is None:
        pool = torch.randn((P, page, 2 * Kv, h), generator=g, device=cuda).to(dtype)
        ks = vs = None
    else:
        pool, ks, vs = _quant_pool(g, (P, page, 2 * Kv, h), kv, cuda)
    table = (torch.randperm(P - 1, generator=g, device=cuda)[: B * mp] + 1).reshape(B, mp).to(torch.int32)
    q = torch.randn((B, S, H, h), generator=g, device=cuda).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = paged_attention_plain(q.float(), pool if kv else pool.float(), table, kv_lens,
                                 h**-0.5, 0.0, ks, vs)
    return q, pool, table, kv_lens, ks, vs, want


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, "fp8", "int8"], ids=["bf16", "fp8", "int8"])
@pytest.mark.parametrize("kv_len", [512, 2048])
@pytest.mark.parametrize("S,h", [(5, 128), (8, 128), (12, 128), (16, 128), (8, 32)])
def test_ragged_verify_rows_on_split_kv(cuda, kv, kv_len, S, h):
    """A speculative verify step of S = G+1 tokens on the ragged kernel at
    Llama-3.1-8B's 32 query and 8 KV heads (S*4 = 20 to 64 rows per KV
    head, and 32 at head dim 32: the q8d32 library for one-byte pools):
    the split-KV body with two or four row tiles below 64 rows, the
    prefill tile at 64, against the plain version, for a bf16, fp8 and
    int8 pool, 8 slots of uneven lengths."""
    from kubeai_tpu_torch.ops.paged_attention import ragged_regime

    lens = [kv_len - 3 * i for i in range(8)]
    q, pool, table, kv_lens, ks, vs, want = _verify_case(
        cuda, torch.bfloat16, kv, 8, S, 32, 8, h, 64, lens, seed=S + h)
    assert ragged_regime(q, pool) == ("prefill_tile" if S * 4 == 64 else "split_kv")
    before = paged_attention_ragged.launches
    for _ in range(2):  # the second launch finds the counters the first left
        got = paged_attention_ragged(q, pool, table, kv_lens, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        _assert_close(got, want, torch.bfloat16)
    assert paged_attention_ragged.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", [None, "fp8", "int8"], ids=["same", "fp8", "int8"])
@pytest.mark.parametrize(
    "S,H,lens",
    [
        (9, 32, [9, 100, 511, 2048]),  # 36 rows: past auto's threshold of 8
        (16, 32, [16, 300, 1024, 2048]),  # 64 rows: four tiles
        (17, 32, [17, 64, 700, 2048]),  # 68 rows: groups of 64 and 4
        (16, 64, [16, 77, 512, 1500]),  # G = 8, 128 rows: two groups of 64
    ],
)
def test_dedicated_verify_any_rows(cuda, dtype, kv, S, H, lens):
    """The dedicated kernel takes every S the Pallas kernel takes: rows
    past 64 per (slot, KV head) run in groups of 64, one launch."""
    q, pool, table, kv_lens, ks, vs, want = _verify_case(
        cuda, dtype, kv, len(lens), S, H, 8, 128, 64, lens, seed=S + H)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, pool, table, kv_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    _assert_close(got, want, dtype)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_inputs(cuda):
    q = torch.zeros((1, 4, 4, 128), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 2, 128), device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k, k.clone())
    pool = torch.zeros((5, 16, 4, 128), device=cuda, dtype=torch.bfloat16)
    table = torch.ones((1, 4), device=cuda, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_ragged(q, pool, table, torch.tensor([4], device=cuda))
    # (The dedicated kernel takes any S and any number of rows: see
    # test_dedicated_verify_any_rows.) One-byte pools: no other pool dtypes (head dim 32 is served: see
    # test_quantized_pool_kernels_match_plain).
    for fn in (paged_attention_ragged, paged_decode_attention):
        with pytest.raises(ValueError, match="kv_pages must be"):
            fn(q, pool.to(torch.float16), table.to(torch.int32), torch.tensor([4], device=cuda))


# Quantized pools (one byte per element): the JAX package's int8 scales
# of tests/test_kv_quant.py; fp8 is scale-free.
KV_QUANT = {"int8": (torch.int8, 0.05, 0.02), "fp8": (torch.float8_e4m3fn, 1.0, 1.0)}


def _quant_pool(g, shape, kv, device):
    """A one-byte pool whose dequantized K/V are ~N(0, 1): int8 values
    round(N(0, 1) / scale) within +-127 (K and V rows with their own
    scales), fp8 values N(0, 1) in e4m3."""
    dt, ks, vs = KV_QUANT[kv]
    x = torch.randn(shape, generator=g, device=device)
    if dt == torch.int8:
        scale = torch.tensor([ks, vs] * (shape[2] // 2), device=device)[:, None]
        return torch.clamp(torch.round(x / scale), -127, 127).to(dt), ks, vs
    return x.to(dt), ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,Kv,h,page,lens,softcap",
    [
        (8, 1, 32, 8, 128, 64, [1, 63, 64, 65, 300, 511, 700, 2048], 0.0),  # split KV, 8 rows
        (8, 4, 32, 8, 128, 64, [4, 40, 129, 511, 512, 1024, 1999, 2048], 0.0),  # 32 rows
        (4, 8, 64, 8, 128, 64, [8, 70, 300, 2048], 0.0),  # 64 rows: four tiles
        (2, 4, 8, 2, 128, 16, [19, 45], 0.0),  # page 16
        (2, 2, 4, 2, 64, 16, [30, 61], 30.0),  # softcap, head dim 64
        (4, 1, 4, 2, 64, 16, [1, 17, 100, 256], 0.0),  # head dim 64, lengths at the edges
        (1, 6, 32, 8, 128, 64, [700], 0.0),  # 24 rows: the ragged kernel's split KV too
        (1, 128, 32, 8, 128, 64, [128], 0.0),  # prefill: TMA tile
        (1, 1024, 32, 8, 128, 64, [2048], 0.0),  # chunk at 1024
        (1, 128, 32, 8, 128, 16, [300], 0.0),  # prefill tile of 4 page-16 boxes
        (2, 64, 32, 8, 128, 64, [300, 77], 30.0),  # prefill tiles with softcap
        # Head dim 32 (the JAX package's test configuration; a library of
        # its own): split KV, 32 rows (CUDA-core tile / two tiles), TMA tile.
        (4, 1, 4, 2, 32, 16, [1, 17, 100, 256], 0.0),
        (2, 8, 8, 2, 32, 16, [40, 61], 0.0),
        (1, 128, 4, 2, 32, 16, [300], 0.0),
    ],
)
def test_quantized_pool_kernels_match_plain(cuda, kv, dtype, B, S, H, Kv, h, page, lens,
                                            softcap):
    """Every regime of both paged kernels over an int8 and an fp8 pool at
    a shuffled (ragged) page table, against the plain version: the pool
    dequantized to float32 (x * scale), float32 attention."""
    g = torch.Generator(device=cuda).manual_seed(7)
    mp = -(-min(max(lens), 2048) // page)
    P = 1 + B * mp
    pool, ks, vs = _quant_pool(g, (P, page, 2 * Kv, h), kv, cuda)
    table = (torch.randperm(P - 1, generator=g, device=cuda)[: B * mp] + 1).reshape(B, mp).to(torch.int32)
    q = torch.randn((B, S, H, h), generator=g, device=cuda).to(dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = paged_attention_plain(q.float(), pool, table, kv_lens, h**-0.5, softcap, ks, vs)
    fns = [paged_attention_ragged] + ([paged_decode_attention] if S <= MAX_DECODE_QUERY_LEN else [])
    for fn in fns:
        before = fn.launches
        got = fn(q, pool, table, kv_lens, softcap=softcap, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 4, 24])
def test_quantized_pool_edges(cuda, kv, dtype, S):
    """The widening and the scale folds at the edges. Query 0 of each slot
    sees key 0 alone, so its output is key 0's V row times v_scale; those
    rows hold every byte (int8 -128..127; every e4m3 pattern: +-448, the
    subnormals, NaN), so the output shows each byte's value exactly
    (float32) or rounded once (bf16). Then, NaN bytes cleared, K rows at
    the format's ends (+-127, +-448) meet 40 keys through the softmax.
    S = 1, 4 and 24 take the split-KV, CUDA-core and TMA tiles (G = 8)."""
    dt, ks, vs = KV_QUANT[kv]
    B, H, Kv, h, page, mp = 2, 8, 1, 128, 16, 4
    P = 1 + B * mp
    g = torch.Generator(device=cuda).manual_seed(8)
    # Scores of O(1) against the K rows at the format's ends (as real
    # keys meet queries), where float32 summation order stays below 1e-4.
    q_std = 2.0 / ((127 * ks) if dt == torch.int8 else 448.0)
    byte = torch.arange(256, dtype=torch.int32, device=cuda).to(torch.uint8)
    nan = torch.tensor([0x7F, 0xFF], dtype=torch.uint8, device=cuda)
    finite = byte if dt == torch.int8 else byte[(byte != nan[0]) & (byte != nan[1])]
    ends = torch.tensor([127, 129] if dt == torch.int8 else [0x7E, 0xFE], dtype=torch.uint8,
                        device=cuda)  # +-127 / +-448
    pool = torch.empty((P, page, 2, h), dtype=torch.uint8, device=cuda)
    pool[..., 0, :] = ends[torch.randint(0, 2, (P, page, h), generator=g, device=cuda)]
    pool[..., 1, :] = finite[torch.randint(0, len(finite), (P, page, h), generator=g,
                                           device=cuda)]
    pool[1, 0, 1] = byte[:128]  # slot 0's key 0 (its table starts at page 1)
    pool[1 + mp, 0, 1] = byte[128:]  # slot 1's key 0
    table = torch.arange(1, P, dtype=torch.int32, device=cuda).reshape(B, mp)
    q = (torch.randn((B, S, H, h), generator=g, device=cuda) * q_std).to(dtype)
    fns = [paged_attention_ragged] + ([paged_decode_attention] if S <= MAX_DECODE_QUERY_LEN else [])

    def run(lens):
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
        want = paged_attention_plain(q.float(), pool.view(dt), table, kv_lens, h**-0.5, 0.0,
                                     ks, vs)
        outs = [fn(q, pool.view(dt), table, kv_lens, k_scale=ks, v_scale=vs) for fn in fns]
        torch.cuda.synchronize()
        return want, outs

    want, outs = run([S, S])
    v_row = want[:, 0]  # [B, H, h]: every head's V row times v_scale
    for got in outs:
        first = got[:, 0].float()
        assert torch.equal(torch.isnan(first), torch.isnan(v_row))
        ok = ~torch.isnan(v_row)
        if dtype == torch.float32:
            assert torch.equal(first[ok], v_row[ok])
        else:
            _assert_close(first[ok], v_row[ok], dtype)
    if dt != torch.int8:
        pool[(pool == nan[0]) | (pool == nan[1])] = 0
    want, outs = run([40, 40])
    assert torch.isfinite(want).all()
    for got in outs:
        _assert_close(got, want, dtype)


@pytest.mark.gpu
def test_quantized_pool_smem_fits(cuda):
    """The one-byte staging fits the card's per-block shared memory at
    both kernels' 64 rows per block and the splits the wrapper may
    choose."""
    from kubeai_tpu_torch.ops import _build
    from kubeai_tpu_torch.ops import paged_attention as pa
    from kubeai_tpu_torch.ops import paged_decode_attention as pd

    for code in (_build.POOL_SAME, _build.POOL_INT8, _build.POOL_FP8):
        for R in (16, 32, 64):
            for h in (32, 64, 128):
                lib = _build.load(pa.library("paged_decode_attention", h, code), pd._SIG)
                assert 0 < lib.paged_decode_smem_bytes(R, h, 64, 1, code) <= pa.MAX_SMEM
                lib = _build.load(pa.library("paged_attention", h, code), pa._SIG)
                assert 0 < lib.paged_attention_split_smem_bytes(R, h, 64, code) <= pa.MAX_SMEM


def _greedy(engine, prompt, n):
    """(tokens, top-2 logprob gaps) of a greedy completion."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    req = engine.submit(prompt, SamplingParams(temperature=0.0, max_tokens=n, logprobs=True))
    toks, gaps = [], []
    while True:
        ev = req.out.get(timeout=300)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append(ev[1])
            gaps.append(ev[4][0][1] - ev[4][1][1])
        elif ev[0] == "done":
            return toks, gaps
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


@pytest.mark.gpu
@pytest.mark.parametrize("decode_kernel", ["ragged", "dedicated"])
def test_tiny_engine_on_the_card_matches_cpu(cuda, decode_kernel):
    """The float32 test engine through all three kernels on the card gives
    the CPU engine's greedy tokens (plain versions, same weights), up to
    the first step whose top-2 logprobs are within 1e-4 (summation order
    may then pick either)."""
    from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine

    ec = dict(max_slots=4, max_seq_len=1024, prefill_buckets=(16, 32, 64, 128, 256),
              decode_kernel=decode_kernel)
    cpu = build_test_engine(EngineConfig(**ec), seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    card = build_test_engine(EngineConfig(**ec), device=cuda, params=to(cpu.params))
    kernels = (flash_attention, paged_attention_ragged, paged_decode_attention)
    for fn in kernels:
        fn.launches = 0
    cpu.start()
    card.start()
    try:
        prompts = [
            [256] + list(b"short prompt"),  # bucket 16: ragged prefill
            [256] + [(i * 7) % 250 + 1 for i in range(200)],  # bucket 256: flash
            [256] + [(i * 11) % 250 + 1 for i in range(300)],  # chunked: 256 + 64
        ]
        for prompt in prompts:
            want, gaps = _greedy(cpu, prompt, 12)
            got, _ = _greedy(card, prompt, 12)
            upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(want))
            assert got[:upto] == want[:upto]
    finally:
        cpu.stop()
        card.stop()
    used = {fn.__name__: fn.launches for fn in kernels}
    assert used["flash_attention"] > 0 and used["paged_attention_ragged"] > 0
    assert (used["paged_decode_attention"] > 0) == (decode_kernel == "dedicated")


@pytest.mark.gpu
@pytest.mark.parametrize("decode_kernel", ["ragged", "dedicated"])
def test_tiny_speculative_engine_on_the_card_matches_cpu(cuda, decode_kernel):
    """test:tiny at --speculate-tokens 3 through the server's command line:
    the card's greedy tokens (verify steps of 4 tokens through the paged
    kernels) equal the CPU engine's at G = 3 and at G = 0 on the same
    weights, up to the first near-tie, and the card accepts drafts."""
    import dataclasses

    from kubeai_tpu_torch.engine.core import Engine
    from kubeai_tpu_torch.engine.server import build_engine_from_args, make_arg_parser

    args = make_arg_parser().parse_args([
        "--model", "test:tiny", "--speculate-tokens", "3", "--decode-kernel", decode_kernel,
        "--max-slots", "4", "--max-seq-len", "512"])
    card, _ = build_engine_from_args(args)
    assert card.cfg.speculate_tokens == 3

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    params = to_cpu(card.params)
    cpus = [Engine(card.model_config, params, card.tokenizer, card.cfg, device="cpu"),
            Engine(card.model_config, params, card.tokenizer,
                   dataclasses.replace(card.cfg, speculate_tokens=0), device="cpu")]
    for fn in (paged_attention_ragged, paged_decode_attention):
        fn.launches = 0
    for e in (card, *cpus):
        e.start()
    try:
        for prompt in ([256] + [1, 2, 3, 4] * 10, [256] + list(b"short prompt"),
                       [256] + [(i * 7) % 250 + 1 for i in range(100)]):
            got, _ = _greedy(card, prompt, 24)
            for cpu in cpus:
                want, gaps = _greedy(cpu, prompt, 24)
                upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(want))
                assert got[:upto] == want[:upto]
    finally:
        for e in (card, *cpus):
            e.stop()
    assert card.spec_accepted > 0 and card.spec_drafted > card.spec_accepted
    used = paged_decode_attention if decode_kernel == "dedicated" else paged_attention_ragged
    assert used.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("decode_kernel", ["ragged", "dedicated"])
def test_tiny_int8_fp8_engine_on_the_card_matches_cpu(cuda, decode_kernel):
    """test:tiny with int8 weights over an fp8 pool, as the server's
    command line builds it (--quantization int8 --kv-cache-dtype fp8): the
    W8A16 kernels' float32 instance and the paged kernels' head-dim-32
    one-byte instances on the card give the CPU engine's greedy tokens on
    the same int8 weights, up to the first near-tie."""
    from kubeai_tpu_torch.engine.core import Engine
    from kubeai_tpu_torch.engine.server import build_engine_from_args, make_arg_parser

    args = make_arg_parser().parse_args([
        "--model", "test:tiny", "--quantization", "int8", "--kv-cache-dtype", "fp8",
        "--decode-kernel", decode_kernel, "--max-slots", "4", "--max-seq-len", "512"])
    card, _ = build_engine_from_args(args)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    cpu = Engine(card.model_config, to_cpu(card.params), card.tokenizer, card.cfg,
                 device="cpu")
    assert card.cache["kv"].dtype == torch.float8_e4m3fn and card.cache["kv"].shape[-1] == 32
    for fn in (qdot, paged_attention_ragged, paged_decode_attention):
        fn.launches = 0
    cpu.start()
    card.start()
    try:
        for prompt in ([256] + list(b"short prompt"),
                       [256] + [(i * 7) % 250 + 1 for i in range(100)]):
            want, gaps = _greedy(cpu, prompt, 12)
            got, _ = _greedy(card, prompt, 12)
            upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(want))
            assert got[:upto] == want[:upto]
    finally:
        cpu.stop()
        card.stop()
    assert qdot.launches > 0 and paged_attention_ragged.launches > 0
    assert (paged_decode_attention.launches > 0) == (decode_kernel == "dedicated")


def _w8a16_case(cuda, M, K, N, layout, seed=5, lead=(), dtype=torch.bfloat16):
    """x [M, K] (bf16 unless *dtype*) and an int8 weight quantized from
    N(0, 1/K) draws: [K, N] per output column (layout 0, qdot) or [N, K]
    per row (layout 1, qmatT)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    if layout == 0:
        w = quantize(torch.randn(lead + (K, N), generator=g, device=cuda) * K**-0.5)
    else:
        w = quantize_rows(torch.randn(lead + (N, K), generator=g, device=cuda) * K**-0.5)
    return x, w


def _w8a16_want(x, q, s, layout):
    qf = q.float() if layout == 0 else q.float().T
    return (x.float() @ qf) * s.reshape(1, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [0, 1], ids=["qdot", "qmatT"])
@pytest.mark.parametrize("M", [1, 7, 8, 16, 17, 32, 64, 65, 128, 1024])
@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 4096), (4104, 1000)])
def test_w8a16_kernel_matches_plain(cuda, layout, M, K, N):
    """Both weight layouts in both regimes: decode (M <= 16, mma.sync,
    split-K) and verify / prefill (the wgmma tile: 64 rows with split-K
    up to M = 64, 128 rows above). K = 4104 and N = 1000 are off the 64 /
    128 tiles and, for layout 0, off TMA's 16-byte grid (the mma.sync
    kernel's 4-byte copy path at every M)."""
    x, w = _w8a16_case(cuda, M, K, N, layout)
    before = qdot.launches
    got = (qdot if layout == 0 else qmatT)(x, w)
    torch.cuda.synchronize()
    assert qdot.launches == before + 1 and got.shape == (M, N) and got.dtype == torch.bfloat16
    _assert_close(got, _w8a16_want(x, w["int8_q"], w["int8_s"], layout), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 1024])
def test_w8a16_stacked_layer_slice(cuda, M):
    """The model's per-layer slice q[li] of a stacked [L, K, N] weight
    reaches the kernel as a view (no copy), with its own scales."""
    x, w = _w8a16_case(cuda, M, 4096, 1024, 0, lead=(3,))
    for li in range(3):
        wl = {k: v[li] for k, v in w.items()}
        assert wl["int8_q"].data_ptr() == w["int8_q"].data_ptr() + li * 4096 * 1024
        got = qdot(x.reshape(2, M // 2, 4096), wl)  # leading dims kept
        torch.cuda.synchronize()
        assert got.shape == (2, M // 2, 1024)
        _assert_close(got.reshape(M, 1024), _w8a16_want(x, wl["int8_q"], wl["int8_s"], 0),
                      torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 64, 1024])
@pytest.mark.parametrize("shapes", [((4096, 4096), (4096, 1024), (4096, 1024)),
                                    ((4096, 14336), (4096, 14336)),
                                    ((4104, 1000), (4104, 1000))], ids=["qkv", "gate_up", "ragged"])
def test_w8a16_grouped_launch_is_bit_identical(cuda, M, shapes):
    """qdot_many: one launch for the weights that share x, each output
    equal byte for byte to its own qdot (same tiles, same split order),
    and within the tolerance of float32 math."""
    x, _ = _w8a16_case(cuda, M, shapes[0][0], 8, 0)
    g = torch.Generator(device=cuda).manual_seed(9)
    ws = [quantize(torch.randn((K, N), generator=g, device=cuda) * K**-0.5) for K, N in shapes]
    before = qdot.launches
    got = qdot_many(x, ws)
    torch.cuda.synchronize()
    assert qdot.launches == before + 1
    for y, w in zip(got, ws):
        assert torch.equal(y, qdot(x, w))
        _assert_close(y, _w8a16_want(x, w["int8_q"], w["int8_s"], 0), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [0, 1], ids=["qdot", "qmatT"])
@pytest.mark.parametrize("M", [8, 64, 1024])
def test_w8a16_is_deterministic(cuda, layout, M):
    """Two launches on the same inputs give equal bytes: the split-K sum
    runs in split order whichever block arrives last."""
    x, w = _w8a16_case(cuda, M, 4096, 1024, layout)
    fn = qdot if layout == 0 else qmatT
    first = fn(x, w)
    for _ in range(3):
        assert torch.equal(fn(x, w), first)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [0, 1], ids=["qdot", "qmatT"])
@pytest.mark.parametrize("M", [1, 8, 65, 1024])
@pytest.mark.parametrize("K,N", [(4096, 1024), (4104, 1000), (128, 272)])
def test_w8a16_float32_activations(cuda, layout, M, K, N):
    """The float32 instance (the JAX package's float32 test configuration:
    qdot in x's dtype): float32 x and y, FFMA sums, against float32 math
    on the same int8 values within the float32 kernels' tolerance (1e-4;
    summation order alone, ~1e-6 relative at these sizes)."""
    x, w = _w8a16_case(cuda, M, K, N, layout, dtype=torch.float32)
    before = qdot.launches
    got = (qdot if layout == 0 else qmatT)(x, w)
    torch.cuda.synchronize()
    assert qdot.launches == before + 1 and got.dtype == torch.float32
    _assert_close(got, _w8a16_want(x, w["int8_q"], w["int8_s"], layout), torch.float32)


@pytest.mark.gpu
def test_w8a16_refuses_bad_inputs(cuda):
    x, w = _w8a16_case(cuda, 8, 256, 128, 0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        qdot(x.half(), w)
    buf = torch.zeros(256 * 128 + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        qdot(x, {"int8_q": buf[1:].view(256, 128), "int8_s": w["int8_s"]})
    with pytest.raises(ValueError, match="contiguous"):
        qdot(x, {"int8_q": w["int8_q"].T.contiguous().T, "int8_s": w["int8_s"]})
    with pytest.raises(ValueError, match="do not match"):
        qdot(x[:, :128].contiguous(), w)


@pytest.mark.gpu
def test_quantize_on_the_card_is_bit_identical_to_the_cpu(cuda):
    """quantize on the card gives the host's (and so the JAX package's)
    int8 values and scales exactly: the card quantizes preset weights,
    the loader quantizes checkpoints on the host."""
    g = torch.Generator().manual_seed(6)
    w = (torch.randn((3, 512, 384), generator=g) * 0.02).to(torch.bfloat16)
    for fn in (quantize, quantize_rows):
        want, got = fn(w), fn(w.to(cuda))
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (fn.__name__, k)


# -- The graphed, pipelined engine -------------------------------------------


@pytest.fixture(scope="module")
def wide():
    """A 2-layer model at Llama-3.1-8B's widths: (config, bf16 params,
    int8 params), random weights from seed 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import llama_3_1_8b

    mc = llama_3_1_8b(num_layers=2)
    params = llama.init_params(mc, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    yield mc, params, quantize_model_params(params, mc)
    torch.cuda.empty_cache()


def _staggered_greedy(engine, prompts, n):
    """Greedy tokens of *prompts*, each submitted once the one before it
    has its first token (single admissions: each prefills alone, so its
    numbers do not depend on timing)."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    reqs = []
    for p in prompts:
        reqs.append(engine.submit(p, SamplingParams(temperature=0.0, max_tokens=n)))
        first = reqs[-1].out.get(timeout=300)
        assert first[0] == "token", first
        reqs[-1].first = first[1]
    out = []
    for r in reqs:
        ids = [r.first]
        while True:
            ev = r.out.get(timeout=300)
            if ev[0] == "token" and ev[1] >= 0:
                ids.append(ev[1])
            elif ev[0] == "done":
                break
            elif ev[0] == "error":
                raise RuntimeError(ev[1])
        out.append(ids)
    return out


GRAPH_PROMPTS = [list(b"The quick brown fox jumps over the lazy dog. The quick brown fox"),
                 list(b"one two three four one two three four one two three four one"),
                 [(i * 11) % 250 + 1 for i in range(1100)]]  # chunked: 1024 + 128


GRAPH_CASES = {
    "bf16_ragged": dict(decode_kernel="ragged"),
    "bf16_dedicated": dict(decode_kernel="dedicated"),
    "int8_weights": dict(decode_kernel="ragged", int8=True),
    "fp8_pool": dict(decode_kernel="ragged", kv_cache_dtype="fp8"),
    "int8_pool": dict(decode_kernel="dedicated", kv_cache_dtype="int8", int8=True),
    "spec7_ragged": dict(decode_kernel="ragged", speculate_tokens=7),
    "spec7_dedicated": dict(decode_kernel="dedicated", speculate_tokens=7),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_engine_matches_eager(wide, case):
    """Each decode chunk one CUDA graph replay: the greedy tokens equal an
    eager engine's (cuda_graphs=False) on the same weights, token for
    token (the same kernels on the same inputs), under staggered
    arrivals; every chunk of the graphed engine was a replay."""
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    mc, params, qparams = wide
    kw = dict(GRAPH_CASES[case])
    p = qparams if kw.pop("int8", False) else params
    ec = EngineConfig(max_slots=4, max_seq_len=2048, page_size=64, **kw)
    got = {}
    for graphs in (True, False):
        eng = Engine(mc, p, ByteTokenizer(), ec, device="cuda", cuda_graphs=graphs)
        eng.start()
        try:
            got[graphs] = _staggered_greedy(eng, GRAPH_PROMPTS, 40)
        finally:
            eng.stop()
        chunks = list(eng.chunk_log)
        assert chunks and all(c["graph"] == graphs for c in chunks), case
        assert bool(eng.graph_capture_seconds) == graphs
    assert got[True] == got[False], case


@pytest.mark.gpu
def test_tiny_graphed_engine_matches_eager(cuda):
    """test:tiny (float32, head dim 32): graphed and eager engines on the
    same weights give the same greedy tokens."""
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig, build_test_engine

    ec = EngineConfig(max_slots=4, max_seq_len=512, prefill_buckets=(16, 32, 64, 128),
                      speculate_tokens=3)
    graphed = build_test_engine(ec, seed=0, device=cuda)
    eager = Engine(graphed.model_config, graphed.params, graphed.tokenizer, ec, device=cuda,
                   cuda_graphs=False)
    got = {}
    for eng in (graphed, eager):
        eng.start()
        try:
            got[eng is graphed] = _staggered_greedy(
                eng, [[256] + list(b"short"), [256] + [1, 2, 3, 4] * 10,
                      [256] + [(i * 7) % 250 + 1 for i in range(200)]], 40)
        finally:
            eng.stop()
    assert got[True] == got[False]
    assert all(c["graph"] for c in graphed.chunk_log)


@pytest.mark.gpu
def test_graph_replays_count_whole_32_layer_steps(cuda):
    """A 32-layer model (narrow widths), int8 weights, dedicated decode
    kernel: with the counts zeroed before serving, the dedicated kernel's
    launches are whole steps of 32 layers, exactly K steps per replay
    plus the capture's one eager chunk, and the W8A16 counts whole steps
    of 4 launches a layer + 1."""
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.engine.weights import quantize_model_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import ModelConfig

    mc = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=32,
                     num_heads=4, num_kv_heads=2, dtype="bfloat16", max_position=4096)
    params = quantize_model_params(
        llama.init_params(mc, torch.Generator(device=cuda).manual_seed(0), device=cuda), mc)
    ec = EngineConfig(max_slots=4, max_seq_len=512, page_size=64, decode_kernel="dedicated")
    eng = Engine(mc, params, ByteTokenizer(), ec, device=cuda)
    for fn in (paged_decode_attention, qdot, qdot_many):
        fn.launches = 0
    eng.start()
    try:
        _staggered_greedy(eng, [list(b"count the launches"), list(b"of every replay")], 30)
    finally:
        eng.stop()
    replays = len(eng.chunk_log)
    assert replays > 0 and all(c["graph"] for c in eng.chunk_log)
    L, K = mc.num_layers, ec.decode_chunk
    assert paged_decode_attention.launches == (replays + 1) * K * L
    assert qdot.launches % (4 * L + 1) == 0 and qdot.launches > (replays + 1) * K * (4 * L + 1)
    assert qdot_many.launches % (2 * L) == 0


@pytest.mark.gpu
def test_scratch_growth_after_capture_raises(wide):
    """Once a graph holds its capture stream's scratch, a split-KV launch
    (or a W8A16 reservation) there that needs more raises instead of
    freeing memory the graph writes; stop() releases the hold."""
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.ops.paged_attention import _split_kv_setup
    from kubeai_tpu_torch.ops.quant import reserve_workspace

    mc, params, _ = wide
    eng = Engine(mc, params, ByteTokenizer(), EngineConfig(max_slots=4, max_seq_len=1024),
                 device="cuda")
    eng.warmup()
    assert eng.graph_capture_seconds
    q = torch.zeros((64, 1, 32, 128), dtype=torch.bfloat16, device="cuda")
    with torch.cuda.stream(eng._capture_stream):
        _split_kv_setup(q[:4], 8, 16, 64, 4)  # what the graph reserved: fine
        with pytest.raises(RuntimeError, match="CUDA graph holds"):
            _split_kv_setup(q, 8, 32, 64, 64)
        with pytest.raises(RuntimeError, match="CUDA graph holds"):
            reserve_workspace(q.device, 1 << 28, 1 << 20)
    eng.stop()
    with torch.cuda.stream(eng._capture_stream):
        assert _split_kv_setup(q, 8, 32, 64, 64)[0] >= 1


@pytest.mark.gpu
def test_live_engines_never_share_a_stream(cuda):
    """torch's pooled streams repeat after 32 draws: an engine built 30
    draws after another still gets streams of its own (sharing one would
    share its kernel scratch between their graphs)."""
    from kubeai_tpu_torch.engine.core import build_test_engine

    a = build_test_engine(device=cuda)
    fillers = [torch.cuda.Stream(cuda) for _ in range(30)]
    b = build_test_engine(device=cuda)
    own = [{e._stream.cuda_stream, e._capture_stream.cuda_stream} for e in (a, b)]
    assert len(own[0]) == len(own[1]) == 2 and not own[0] & own[1], (own, len(fillers))


# ---------------------------------------------------------------------------
# Head dim 256 (Gemma's; the "_d256" libraries) and query groups that do not
# divide 64 (Qwen2.5's G = 7): -k h256, -k g7.


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,S,H,Kv,causal",
    [(1, 1024, 8, 1, True), (2, 300, 8, 1, True), (1, 256, 8, 4, True), (2, 64, 8, 1, False)],
)
def test_h256_flash_matches_plain(cuda, B, S, H, Kv, causal):
    """Flash at head dim 256 on the tensor-core tile (4 swizzle chunks,
    O += P V as two N = 128 products): Gemma-2B's 8 heads over 1, and
    Gemma2's over 4."""
    from kubeai_tpu_torch.ops.flash_attention import flash_regime

    g = torch.Generator(device=cuda).manual_seed(21)
    q, k, v = (torch.randn((B, S, n, 256), generator=g, device=cuda).to(torch.bfloat16)
               for n in (H, Kv, Kv))
    assert flash_regime(q, k) == "tensor_core"
    before = flash_attention.launches_by_regime["tensor_core"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_regime["tensor_core"] == before + 1
    _assert_close(got, flash_attention_plain(q.float(), k.float(), v.float(), causal),
                  torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, "fp8", "int8"], ids=["bf16", "fp8", "int8"])
@pytest.mark.parametrize(
    "B,S,H,Kv,page,lens,regime",
    [
        (8, 1, 8, 1, 64, [1, 63, 64, 65, 300, 511, 700, 2048], "split_kv"),  # decode, 8 rows
        (8, 4, 8, 1, 64, [4, 40, 129, 511, 512, 1024, 1999, 2048], "split_kv"),  # 32 rows
        (4, 8, 8, 1, 64, [8, 70, 300, 2048], "prefill_tile"),  # verify S=8: 64 rows
        (1, 1024, 8, 1, 64, [2048], "prefill_tile"),  # a 1024 chunk at 1024
        (2, 64, 8, 4, 16, [300, 77], "prefill_tile"),  # Gemma2's G = 2, page-16 boxes
        (2, 3, 8, 4, 16, [19, 45], "split_kv"),
    ],
)
def test_h256_paged_kernels_match_plain(cuda, kv, B, S, H, Kv, page, lens, regime):
    """Both paged kernels at head dim 256 in every regime, over bf16, fp8
    and int8 pools: split-KV decode (Q fragments in shared memory), the
    prefill tile, and the dedicated kernel up to S = 8."""
    from kubeai_tpu_torch.ops.paged_attention import ragged_regime

    q, pool, table, kv_lens, ks, vs, want = _verify_case(
        cuda, torch.bfloat16, kv, B, S, H, Kv, 256, page, lens, seed=S + Kv)
    assert ragged_regime(q, pool) == regime
    fns = [paged_attention_ragged] + ([paged_decode_attention] if S <= MAX_DECODE_QUERY_LEN else [])
    for fn in fns:
        for _ in range(2):  # the second launch finds the counters the first left
            got = fn(q, pool, table, kv_lens, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            _assert_close(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_h256_float32_is_refused(cuda):
    q = torch.zeros((1, 256, 8, 256), device=cuda)
    k = torch.zeros((1, 256, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="ROADMAP queue 3"):
        flash_attention(q, k, k)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Kv", [(28, 4), (20, 4)], ids=["g7", "g5"])
@pytest.mark.parametrize("S", [1024, 300, 9])
def test_g7_flash_runs_the_tensor_core_tile(cuda, H, Kv, S):
    """G = 7 (Qwen2.5-7B) and G = 5: 63- and 60-row tiles of whole
    positions on the tensor cores, not the CUDA-core tile."""
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v = (torch.randn((1, S, n, 128), generator=g, device=cuda).to(torch.bfloat16)
               for n in (H, Kv, Kv))
    before = dict(flash_attention.launches_by_regime)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_regime["tensor_core"] == before.get("tensor_core", 0) + 1
    assert flash_attention.launches_by_regime["cuda_core"] == before.get("cuda_core", 0)
    _assert_close(got, flash_attention_plain(q.float(), k.float(), v.float()), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Kv", [(28, 4), (20, 4)], ids=["g7", "g5"])
@pytest.mark.parametrize("kv", [None, "fp8"], ids=["bf16", "fp8"])
@pytest.mark.parametrize(
    "B,S,page,lens",
    [(1, 1024, 64, [2048]), (2, 10, 64, [10, 700]), (2, 64, 16, [300, 77]), (8, 8, 64, [8] * 8)],
)
def test_g7_ragged_prefill_tile_matches_plain(cuda, H, Kv, kv, B, S, page, lens):
    """The ragged kernel at G = 7 and G = 5: from 64 rows (S = 10 at G = 7:
    70 rows) the prefill tile on the tensor cores, below them (S = 8: 56
    and 40 rows) split KV; never the CUDA-core tile."""
    from kubeai_tpu_torch.ops.paged_attention import ragged_regime

    q, pool, table, kv_lens, ks, vs, want = _verify_case(
        cuda, torch.bfloat16, kv, B, S, H, Kv, 128, page, lens, seed=S + H)
    regime = ragged_regime(q, pool)
    assert regime == ("prefill_tile" if S * H // Kv >= 64 else "split_kv")
    before = paged_attention_ragged.launches_by_regime[regime]
    got = paged_attention_ragged(q, pool, table, kv_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_attention_ragged.launches_by_regime[regime] == before + 1
    _assert_close(got, want, torch.bfloat16)
