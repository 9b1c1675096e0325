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


def _staggered_greedy(engine, prompts, n, adapters=None, bias=()):
    """Greedy tokens of *prompts* (each with its LoRA adapter from
    *adapters*, or none; logit *bias*), each submitted once the one before
    it has its first token (single admissions: each prefills alone, so its
    numbers do not depend on timing)."""
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    reqs = []
    for p, a in zip(prompts, adapters or [None] * len(prompts)):
        reqs.append(engine.submit(p, SamplingParams(temperature=0.0, max_tokens=n,
                                                    logit_bias=bias), adapter=a))
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


# ---------------------------------------------------------------------------
# LoRA adapters in the graphed decode chunk: -k lora.

LORA_CASES = {k: GRAPH_CASES[k] for k in ("bf16_ragged", "bf16_dedicated", "int8_weights",
                                            "spec7_ragged")}


def _write_adapters(tmp_path, mc, n=2):
    """n PEFT adapters of rank 16 on all seven targets (the port's writer),
    scaled so each delta is a fraction of its projection."""
    from kubeai_tpu_torch.engine.lora import write_peft_checkpoint

    paths = [str(tmp_path / f"adapter{i}") for i in range(n)]
    for i, p in enumerate(paths):
        write_peft_checkpoint(p, mc, rank=16, alpha=32, seed=i + 1, std=0.02)
    return paths


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(LORA_CASES))
def test_lora_graphed_engine_matches_eager(wide, case, tmp_path):
    """Two adapters and base requests decoding together: a graphed engine
    (the chunk captured again with the deltas after the first load) gives
    an eager engine's greedy tokens, token for token; the base requests
    give an engine's with no bank; adapter requests differ from base."""
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    mc, params, qparams = wide
    kw = dict(LORA_CASES[case])
    p = qparams if kw.pop("int8", False) else params
    ec = EngineConfig(max_slots=4, max_seq_len=2048, page_size=64, **kw)
    paths = _write_adapters(tmp_path, mc)
    prompts = GRAPH_PROMPTS + [GRAPH_PROMPTS[0]]
    adapters = ["a", "b", None, None]
    got = {}
    for mode in ("graphed", "eager", "no_bank"):
        eng = Engine(mc, p, ByteTokenizer(), ec, device="cuda", cuda_graphs=mode != "eager")
        eng.start()
        try:
            if mode != "no_bank":
                _staggered_greedy(eng, prompts[:1], 8, bias=NO_EOS)  # a graph before the bank
                eng.load_adapter("a", paths[0])
                eng.load_adapter("b", paths[1])
            got[mode] = _staggered_greedy(eng, prompts, 40,
                                          adapters if mode != "no_bank" else None, NO_EOS)
        finally:
            eng.stop()
        assert all(c["graph"] == (mode != "eager") for c in eng.chunk_log), case
    assert got["graphed"] == got["eager"], case
    assert got["graphed"][2:] == got["no_bank"][2:], case
    assert got["graphed"][0] != got["graphed"][3] and got["graphed"][1] != got["no_bank"][1]


@pytest.mark.gpu
def test_lora_load_after_capture_reaches_the_next_chunk(cuda, tmp_path):
    """An adapter reloaded while its request decodes, after the chunk was
    captured with the bank: the bank's tensors stay where the graph reads
    them, and the new weights take effect at a chunk boundary k. The
    tokens equal those of a plain greedy loop over the model's step
    functions that decodes with the old rows before token k and the new
    ones from it (float32 test config; up to a near-tie)."""
    from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine
    from kubeai_tpu_torch.engine.lora import AdapterRuntime
    from kubeai_tpu_torch.engine.sampling import SamplingParams

    ec = EngineConfig(max_slots=2, max_seq_len=512, prefill_buckets=(16, 32, 64, 128))
    eng = build_test_engine(ec, seed=0, device=cuda)
    old, new = _write_adapters(tmp_path, eng.model_config)
    banks = []
    for path in (old, new):
        rt = AdapterRuntime(eng.model_config, ec.max_adapters, ec.max_lora_rank, device=cuda)
        rt.load("x", path)  # row 1, as in the engine
        banks.append(rt.bank)
    prompt = [256] + list(b"switch the adapter while it decodes")
    n, K = 200, ec.decode_chunk
    eng.start()
    try:
        eng.load_adapter("x", old)
        ptrs = {k: t.data_ptr() for k, t in eng._adapters.bank.items()}
        req = eng.submit(prompt, SamplingParams(temperature=0.0, max_tokens=n,
                                                logit_bias=NO_EOS), adapter="x")
        toks = [req.out.get(timeout=300)[1]]
        eng.load_adapter("x", new)  # installed between two dispatches
        while True:
            ev = req.out.get(timeout=300)
            if ev[0] == "done":
                break
            assert ev[0] == "token", ev
            if ev[1] >= 0:
                toks.append(ev[1])
    finally:
        eng.stop()
    assert len(toks) == n
    assert {k: t.data_ptr() for k, t in eng._adapters.bank.items()} == ptrs
    want_old, _ = _greedy_switching(eng, prompt, n, n, banks)
    d = next(i for i, (a, b) in enumerate(zip(toks, want_old)) if a != b)
    # The boundary is at or before the first token that differs.
    for k in reversed(range(1 + K, d + 1, K)):
        want, gaps = _greedy_switching(eng, prompt, n, k, banks)
        upto = next((i for i, g in enumerate(gaps) if g < 1e-4), n)
        if toks[:upto] == want[:upto]:
            break
    else:
        raise AssertionError(f"no chunk boundary before token {d} explains the switch")


def _greedy_switching(eng, prompt, n, k, banks):
    """(tokens, top-2 gaps) of greedy decoding with the engine's model and
    shapes (bucketed cold prefill, one slot), EOS banned, LoRA row 1 of
    banks[0] for tokens before *k* and of banks[1] from it."""
    from kubeai_tpu_torch.models import llama

    mc, dev = eng.model_config, eng.device
    mp, page = eng._max_pages, eng.cfg.page_size
    pool = llama.init_paged_cache(mc, 1 + mp, page, dev)
    table = torch.arange(1, 1 + mp, dtype=torch.int32, device=dev)[None]
    rows = torch.ones((1,), dtype=torch.int64, device=dev)
    padded = torch.zeros((1, eng._bucket(len(prompt))), dtype=torch.int64, device=dev)
    padded[0, : len(prompt)] = torch.tensor(prompt, device=dev)
    logits, _ = llama.prefill_paged_cold(eng.params, mc, padded, pool, table,
                                         torch.tensor([len(prompt)], device=dev),
                                         lora=banks[0], lora_rows=rows)
    toks, gaps = [], []
    for i in range(n):
        if i:
            step = torch.tensor([[toks[-1]]], device=dev)
            pos = torch.tensor([len(prompt) + i - 1], device=dev)
            logits, _ = llama.decode_step_paged(eng.params, mc, step, pool, table, pos,
                                                decode_kernel=eng.decode_kernel,
                                                lora=banks[int(i >= k)], lora_rows=rows)
        lg = logits[0, -1, : eng.n_valid_vocab].double()
        lg[NO_EOS[0][0]] += NO_EOS[0][1]
        top = torch.topk(lg, 2)
        toks.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
    return toks, gaps


NO_EOS = ((257, -100.0),)  # the byte tokenizer's EOS, banned: runs of full length


# KV park and restore on the card: -k park.


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["", "fp8"], ids=["bf16", "fp8"])
@pytest.mark.parametrize("h", [128, 256])
def test_kv_park_import_round_trip_on_the_card(cuda, kv, h):
    """Pages gathered from a CUDA pool, through the KVPG blob, and
    imported into other pages come back bit-identical, and the import
    writes the pool in place (its address, which captured graphs hold,
    does not move)."""
    import numpy as np

    from kubeai_tpu_torch.engine import kvstate
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.models.base import ModelConfig

    mc = ModelConfig(vocab_size=272, hidden_size=512, intermediate_size=512, num_layers=3,
                     num_heads=4, num_kv_heads=2, head_dim=h, max_position=2048)
    params = llama.init_params(mc, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    eng = Engine(mc, params, ByteTokenizer(), EngineConfig(max_slots=4, max_seq_len=1024,
                                                           kv_cache_dtype=kv), device=cuda)
    pool = eng.cache["kv"]
    g = torch.Generator(device=cuda).manual_seed(1)
    with torch.cuda.stream(eng._stream):
        pool.view(torch.uint8).copy_(torch.randint(0, 256, pool.view(torch.uint8).shape,
                                                   generator=g, device=cuda,
                                                   dtype=torch.uint8))
        src, dst = [3, 7, 8, 20, 2], [11, 5, 30, 31, 9]
        payload = eng._gather_pages(src)
        blob = kvstate.encode_state(
            model_fp=eng._kv_fp, request_fp="r", history=[1], pending=2, prompt_len=1,
            generated=1, committed_text="", delivered_chars=0,
            key_data=np.array([5], np.uint32), events=[("token", 2, "", 0.0)],
            adapter=None, payload=payload)
        st = kvstate.decode_state(blob, expect_model_fp=eng._kv_fp)
        ptr = pool.data_ptr()
        eng._import_pages(dst, st.payload)
        eng._stream.synchronize()
    assert pool.data_ptr() == ptr and eng.cache["kv"] is pool
    P, L = eng._pool.num_pages, mc.num_layers
    raw = pool.view(torch.uint8).view(L, P, *pool.view(torch.uint8).shape[1:])
    assert torch.equal(raw[:, dst], raw[:, src])
    assert payload.dtype == pool.dtype and tuple(payload.shape[:2]) == (len(src), L)


@pytest.mark.gpu
def test_graphed_chunk_decodes_a_restored_slot_as_eager(wide):
    """A stream parked at a 16-token handoff and restored, by unpark on
    the same engine and by upload into a fresh one, decodes in the
    captured chunk (the slot enters through the admission merge) to the
    eager engine's tokens and to the unbroken stream's."""
    from kubeai_tpu_torch.engine import kvstate
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig
    from kubeai_tpu_torch.engine.sampling import SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    mc, params, _ = wide
    ids = list(b"The quick brown fox jumps over the lazy dog. " * 3)
    full = SamplingParams(temperature=0.0, max_tokens=48)

    def drain(req):
        out, fin = [], None
        while fin is None:
            ev = req.out.get(timeout=300)
            if ev[0] == "token" and ev[1] >= 0:
                out.append(ev[1])
            elif ev[0] == "done":
                fin = ev[1]
            elif ev[0] == "error":
                raise RuntimeError(ev[1])
        return out, fin

    got = {}
    for graphs in (True, False):
        engines = [Engine(mc, params, ByteTokenizer(), EngineConfig(max_slots=4,
                                                                    max_seq_len=2048),
                          device="cuda", cuda_graphs=graphs) for _ in range(2)]
        for e in engines:
            e.start()
        try:
            a, b = engines
            unbroken, _ = drain(a.submit(ids, full))
            runs = []
            for target in (a, b):
                head, fin = drain(a.submit(ids, SamplingParams(temperature=0.0, max_tokens=16),
                                           park_kv="handoff"))
                assert fin.reason == "length" and fin.kv, fin
                st = kvstate.decode_state(
                    a.kv_park.get(fin.kv["key"]).blob, expect_model_fp=target._kv_fp,
                    expect_request_fp=kvstate.request_fingerprint(ids, full, None))
                key = fin.kv["key"] if target is a else ""
                resumed, _ = drain(target.submit(ids, full, restore=st, restore_key=key))
                assert resumed[:16] == head
                how = [e for e in target.kv_log if e["event"] == "import"][-1]["how"]
                assert how == ("unparked" if target is a else "uploaded")
                runs.append(resumed)
            assert runs == [unbroken, unbroken], graphs
            got[graphs] = unbroken
            assert all(c["graph"] == graphs for e in engines for c in e.chunk_log)
        finally:
            for e in engines:
                e.stop()
    assert got[True] == got[False]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiny_f32", "wide_bf16", "wide_int8"])
def test_serving_ops_embed_on_the_card_matches_cpu(cuda, wide, case):
    """Engine.embed on the card (plain attention, no pool: the JAX gate;
    projections in cuBLAS, or the W8A16 kernel with int8 weights) against
    the same engine's on the CPU: test:tiny in float32, and the 2-layer
    model at Llama-3.1-8B's widths in bf16 and int8, within one bf16
    rounding (2^-8 relative + 1e-3), each vector of unit norm."""
    from kubeai_tpu_torch.engine.core import Engine, EngineConfig, build_test_engine
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    if case == "tiny_f32":
        cpu = build_test_engine(device="cpu")
        card = build_test_engine(device=cuda, params=to(cpu.params, cuda))
        lengths = [1, 9, 16, 17, 40, 64, 100, 128, 3]
    else:
        mc, params, qparams = wide
        p = qparams if case == "wide_int8" else params
        ec = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32))
        card = Engine(mc, p, ByteTokenizer(), EngineConfig(**ec), device=cuda)
        cpu = Engine(mc, to(p, "cpu"), ByteTokenizer(), EngineConfig(**ec), device="cpu")
        lengths = [1, 7, 20, 32, 5]  # two groups of max_slots
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, 256, (n,), generator=g).tolist() for n in lengths]
    qdot.launches = 0  # every W8A16 launch, grouped ones included
    got = card.embed(prompts)
    launched = qdot.launches
    want = cpu.embed(prompts)
    got_t, want_t = torch.from_numpy(got), torch.from_numpy(want)
    _assert_close(got_t, want_t, torch.bfloat16)
    torch.testing.assert_close(got_t.norm(dim=1), torch.ones(len(lengths)), rtol=1e-5, atol=1e-5)
    assert (launched > 0) == (case == "wide_int8")
    card.stop()
    cpu.stop()


@pytest.mark.gpu
def test_warm_compile_builds_into_an_empty_directory_then_reads(cuda, tmp_path):
    """warm_compile into an empty library directory builds (nvcc) and
    loads exactly the config's libraries, every kernel of each loaded onto
    the card; a second warm reads them back and builds none."""
    from kubeai_tpu_torch.engine.coldstart import warm_compile
    from kubeai_tpu_torch.engine.core import EngineConfig
    from kubeai_tpu_torch.models.base import llama_3_1_8b
    from kubeai_tpu_torch.ops import _build

    mc = llama_3_1_8b(num_layers=2)
    ec = EngineConfig(decode_kernel="dedicated", kv_cache_dtype="fp8")
    prior = _build.library_dir()
    _build.set_library_dir(tmp_path)
    try:
        first = warm_compile(mc, ec, "int8", device=cuda)
        second = warm_compile(mc, ec, "int8", device=cuda)
    finally:
        _build.set_library_dir(prior)
    want = ["flash_attention", "paged_attention", "paged_decode_attention", "w8a16_matmul"]
    assert first["libraries"] == want and "errors" not in first, first
    assert sorted(first["built"]) == sorted(want) and all(s > 0 for s in first["built"].values())
    assert first["loaded"] == want and all(n > 0 for n in first["preloaded"].values()), first
    assert sorted(p.name.split("-")[0] for p in tmp_path.glob("*.so")) == sorted(want)
    assert second["built"] == {} and second["loaded"] == want and second["missing"] == []


@pytest.mark.gpu
def test_parked_engine_captured_on_zeros_then_loaded_in_place(cuda):
    """A parked test-size engine captures its decode graph over zero
    weights; load_params_ copies seed 2's weights into the same storage
    and the graphed engine gives a fresh seed-2 engine's greedy tokens.
    Rebinding the leaves instead (new tensors) leaves the graph reading
    the zeros: a silent wrong answer, which is why the copy is in place."""
    from kubeai_tpu_torch.engine.coldstart import zero_params
    from kubeai_tpu_torch.engine.core import (
        Engine,
        EngineConfig,
        build_test_engine,
        preset_params,
        test_model_config,
    )
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    mc = test_model_config()
    ec = EngineConfig(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64, 128))
    prompts = [[256] + list(b"Hello there"), [256] + [(i * 11) % 250 + 1 for i in range(90)]]

    def greedy(eng):
        from kubeai_tpu_torch.engine.sampling import SamplingParams

        eng.start()
        try:
            return [eng.generate(p, SamplingParams(temperature=0.0, max_tokens=24))[0]
                    for p in prompts]
        finally:
            eng.stop()

    fresh = build_test_engine(ec, seed=2, device=cuda)
    want = greedy(fresh)
    parked = Engine(mc, zero_params(mc, "", cuda), ByteTokenizer(), ec, device=cuda)
    parked.warmup()
    assert parked.graph_capture_seconds
    ptrs = {k: v.data_ptr() for k, v in parked.params["layers"].items()}
    parked.load_params_(preset_params(mc, cuda, 2))
    assert {k: v.data_ptr() for k, v in parked.params["layers"].items()} == ptrs
    captured = dict(parked.graph_capture_seconds)
    assert greedy(parked) == want
    assert all(c["graph"] for c in parked.chunk_log) and captured

    rebound = Engine(mc, zero_params(mc, "", cuda), ByteTokenizer(), ec, device=cuda)
    rebound.warmup()  # the decode graph, captured over the zeros
    zeros = dict(rebound.params)  # kept alive: the graph still reads them
    rebound.params.update(preset_params(mc, cuda, 2))  # new storage for every leaf
    got = greedy(rebound)
    # The eager prefill reads the new weights (its first token is right);
    # the replayed decode chunks read the zeros.
    assert [g[0] for g in got] == [w[0] for w in want] and got != want
    del zeros


def _tiny_f32():
    from kubeai_tpu_torch.models.base import ModelConfig

    return ModelConfig(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=2, dtype="float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_add_forms_equal_on_the_card(cuda, dtype):
    """The served form of _lora_add (out=, under no_grad) and the training
    form (allocated, under autograd) give the same values on the card."""
    from kubeai_tpu_torch.models import llama

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4, 64, 4096), generator=g, device=cuda).to(dtype)
    A = (torch.randn((3, 4096, 16), generator=g, device=cuda) * 0.02).to(dtype)
    B = (torch.randn((3, 16, 1024), generator=g, device=cuda) * 0.02).to(dtype)
    out = torch.randn((4, 64, 1024), generator=g, device=cuda).to(dtype)
    w = llama.lora_weights(torch.tensor([1, 0, 2, 1], device=cuda),
                           torch.tensor([0.0, 2.0, 0.5], device=cuda), dtype)
    with torch.no_grad():
        served = llama._lora_add(out, x, A, B, w)
    A.requires_grad_(True)
    trained = llama._lora_add(out, x, A, B, w)
    assert trained.requires_grad
    assert torch.equal(trained.detach(), served)


@pytest.mark.gpu
@pytest.mark.parametrize("step", ["train_step", "lora_step"])
def test_training_step_on_the_card_matches_cpu(cuda, step):
    """One trainer.train_step (full parameters, AdamW lr 1e-4) or one LoRA
    step (train_lora, a float32 bank on q and v) on a float32 tiny config,
    on the card and on the CPU from the same weights and batch: the loss
    within 1e-5 relative, every parameter after the step within 1e-5
    (TF32 off, torch's default)."""
    import numpy as np

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.train import finetune, trainer

    assert not torch.backends.cuda.matmul.allow_tf32
    mc = _tiny_f32()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 259, (4, 32)).astype(np.int32)
    host = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
            "mask": (rng.random((4, 32)) < 0.9).astype(np.int32)}
    rows = [(list(map(int, rng.integers(0, 259, 40))), [1] * 40) for _ in range(8)]
    base = llama.init_params(mc, torch.Generator().manual_seed(0))

    def run(dev):
        params = {k: ({n: w.to(dev, copy=True) for n, w in v.items()} if isinstance(v, dict)
                      else v.to(dev, copy=True)) for k, v in base.items()}
        if step == "train_step":
            for t in trainer.leaves(params):
                t.requires_grad_(True)
            opt = trainer.make_optimizer(params, 1e-4)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            loss = trainer.train_step(params, opt, batch, mc).item()
            return loss, [t.detach().cpu() for t in trainer.leaves(params)]
        bank = finetune.init_bank(mc, 8, 16.0, ("wq", "wv"), seed=1, device=dev)
        bank["wq_B"][:, 1] = 0.01  # a nonzero B: A takes a gradient in the first step
        stats = {}
        finetune.train_lora(params, mc, bank, rows, ("wq", "wv"), 1, 4, 32, 1e-4, stats=stats)
        return stats["losses"][0], [bank[k].cpu() for k in ("wq_A", "wq_B", "wv_A", "wv_B")]

    (lg, pg), (lc, pc) = run(cuda), run("cpu")
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    for a, b in zip(pg, pc):
        assert (a - b).abs().max().item() <= 1e-5


def _tp_config(dtype):
    from kubeai_tpu_torch.models.base import ModelConfig

    # Head dim 128 (the kernels' instances), H 8 / Kv 4: at tp = 2 each
    # rank runs G = 2 over 4 heads.
    return ModelConfig(vocab_size=512, hidden_size=1024, intermediate_size=2048, num_layers=2,
                       num_heads=8, num_kv_heads=4, dtype=dtype, max_position=2048)


@pytest.mark.gpu
@pytest.mark.parametrize("quantization", ["", "int8"])
def test_shard_params_on_the_card_are_slices(cuda, quantization):
    """shard_params of a CUDA tree keeps each rank's slice on the card:
    column weights by output columns, row weights by input rows (int8
    scales whole), the vocab by rows of the embedding."""
    from kubeai_tpu_torch.engine.core import preset_params
    from kubeai_tpu_torch.parallel.group import TPGroup
    from kubeai_tpu_torch.parallel.sharding import shard_params

    mc = _tp_config("bfloat16")
    full = preset_params(mc, cuda, seed=3, quantization=quantization)
    for rank in range(2):
        part = shard_params(full, mc, TPGroup(rank, 2, cuda, None, "gloo"))
        drawn = preset_params(mc, cuda, seed=3, quantization=quantization,
                              tp_group=TPGroup(rank, 2, cuda, None, "gloo"))
        for key, dim in (("wq", 2), ("wo", 1), ("wd", 1), ("wg", 2)):
            w, p, d = full["layers"][key], part["layers"][key], drawn["layers"][key]
            if quantization:
                n = w["int8_q"].shape[dim] // 2
                assert torch.equal(p["int8_q"], w["int8_q"].narrow(dim, rank * n, n))
                want_s = w["int8_s"] if key in ("wo", "wd") else w["int8_s"].narrow(dim, rank * n, n)
                assert torch.equal(p["int8_s"], want_s)
                assert torch.equal(d["int8_q"], p["int8_q"]) and torch.equal(d["int8_s"], p["int8_s"])
            else:
                n = w.shape[dim] // 2
                assert p.is_cuda and torch.equal(p, w.narrow(dim, rank * n, n))
                assert torch.equal(d, p)
        emb = full["embed"]["int8_q"] if quantization else full["embed"]
        got = part["embed"]["int8_q"] if quantization else part["embed"]
        assert torch.equal(got, emb[rank * 256:(rank + 1) * 256])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_thread_gloo_tp2_decode_step_matches_tp1(cuda, dtype):
    """One paged prefill and one decode step at tp = 2 (two threads on
    the card, gloo over host memory) against tp = 1 on the same weights:
    the paged kernels and the W8A16-free bf16 path at a rank's shapes.
    float32 within 1e-4; bf16 within the extra rounding of each
    row-parallel partial sum (2L of them, as chip_smoke derives)."""
    import math

    from kubeai_tpu_torch.engine.core import preset_params
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.parallel.group import run_local_ranks
    from kubeai_tpu_torch.parallel.sharding import shard_params

    mc = _tp_config(dtype).replace(use_paged_kernel=True, use_flash_prefill=True)
    full = preset_params(mc, cuda, seed=1)
    g = torch.Generator(device=cuda).manual_seed(2)
    B, S, P, page = 2, 256, 12, 64
    tok = torch.randint(0, 512, (B, S), generator=g, device=cuda)
    table = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([S, S], device=cuda)

    def go(group):
        params = shard_params(full, mc, group) if group is not None else full
        tp = group.world_size if group is not None else 1
        pool = llama.init_paged_cache(mc, P, page, cuda, tp=tp)
        before = paged_attention_ragged.launches, flash_attention.launches
        a, _ = llama.prefill_paged_cold(params, mc, tok, pool, table, lens, tp_group=group)
        b, _ = llama.decode_step_paged(params, mc, tok[:, :1], pool, table, lens,
                                       tp_group=group)
        torch.cuda.synchronize()
        return a, b, before

    want_a, want_b, _ = go(None)
    ranks = run_local_ranks(2, go, cuda, backend="gloo")
    assert paged_attention_ragged.launches >= 3 and flash_attention.launches >= 3
    tol = 1e-4 if dtype == "float32" else 4 * math.sqrt(2 * mc.num_layers) * 2.0**-8 * float(
        want_a.abs().max())
    for a, b, _ in ranks:
        assert (a - want_a).abs().max().item() <= tol
        assert (b - want_b).abs().max().item() <= tol
    assert torch.equal(ranks[0][0], ranks[1][0]) and torch.equal(ranks[0][1], ranks[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_thread_ranks_match_dense_on_the_card(cuda, sp):
    """Ring attention at sp thread ranks sharing the card (gloo staged
    through pinned host memory; the backward's collectives run on each
    rank's own thread, not the card's shared autograd thread) against the
    plain dense attention, output and q / k / v gradients within 2·S·u of
    max |ref| (kubeai_tpu_torch/tools/sharded_check.py at narrow widths)."""
    from kubeai_tpu_torch.tools.sharded_check import RING_SMALL, ring_check

    out = ring_check(**{**RING_SMALL, "sps": (sp,)}, device=cuda)
    run = out["sp"][str(sp)]
    assert max(run["rel_err"].values()) <= out["tol_rel"]
    assert run["ring_passes"] == 2 * (sp - 1)


@pytest.mark.gpu
def test_sharded_step_dp2_sp2_tp2_matches_one_rank_on_the_card(cuda):
    """The training step over a dp = sp = tp = 2 mesh of eight thread
    ranks on the card against one rank's step from the same seeded
    weights (narrow widths): the loss, every leaf's gradient and the
    updated final_norm within sharded_check's tolerances."""
    from kubeai_tpu_torch.tools.sharded_check import GRAD_TOL, small_config, step_check

    out = step_check(small_config(), 2, 256, device=cuda)
    assert out["grad_rel_err_max"] <= GRAD_TOL and out["loss_rel_err"] <= 1e-4
    assert out["collective_calls_by_kind"]["dp.reduce_scatter"] > 0


@pytest.mark.gpu
def test_moe_step_dp2_ep2_tp2_matches_one_rank_on_the_card(cuda):
    """A narrow Mixtral at capacity factor 0.5 over a dp = ep = tp = 2
    mesh of eight thread ranks on the card (experts split over ep,
    routing over the global tokens) against one rank's step from the same
    seeded weights: every layer's top-k ids and keep mask exactly, then
    the loss and every leaf's gradient within sharded_check's moe
    tolerances; pairs were dropped."""
    from kubeai_tpu_torch.tools.sharded_check import (
        MOE_GRAD_TOL,
        MOE_LOSS_RTOL,
        moe_check,
        small_moe_config,
    )

    out = moe_check(small_moe_config(), 2, 256, device=cuda)
    assert out["routes_equal"] and out["routing"]["dropped"] > 0
    assert out["grad_rel_err_max"] <= MOE_GRAD_TOL and out["loss_rel_err"] <= MOE_LOSS_RTOL
    assert out["collective_calls_by_kind"]["epxtp.all_reduce"] > 0
