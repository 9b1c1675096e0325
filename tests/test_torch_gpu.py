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
    [(300, 8, 2, 128, True), (64, 4, 4, 64, False), (256, 4, 2, 32, True), (1024, 32, 8, 128, True)],
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
def test_kernel_wrappers_refuse_bad_inputs(cuda):
    q = torch.zeros((1, 4, 4, 128), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 2, 128), device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k, k.clone())
    pool = torch.zeros((5, 16, 4, 128), device=cuda, dtype=torch.bfloat16)
    table = torch.ones((1, 4), device=cuda, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_ragged(q, pool, table, torch.tensor([4], device=cuda))
    with pytest.raises(ValueError, match="queries per slot"):
        paged_decode_attention(
            torch.zeros((1, 9, 4, 128), device=cuda, dtype=torch.bfloat16),
            pool, table.to(torch.int32), torch.tensor([9], device=cuda),
        )


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
