"""The port's three attention kernel modules against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version (the
tensor lies on the CPU); those plain versions are held here against the
Pallas kernels in interpret mode and against the library's reference,
with the cases of tests/test_flash_attention.py, test_paged_kernel.py
and test_decode_kernel.py. Tolerance 2e-5 where both sides run float32
attention (summation order only), as those files use.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
holds each against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops.flash_attention import flash_attention_tpu
from kubeai_tpu.ops.paged_decode_attention import paged_decode_attention as j_decode
from kubeai_tpu_torch.ops.flash_attention import flash_attention
from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    MAX_DECODE_QUERY_LEN,
    paged_decode_attention,
    resolve_decode_kernel,
)

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- #1 flash attention ------------------------------------------------------


@pytest.mark.parametrize(
    "B,S,H,Kv,h,causal,bq,bk",
    [
        (2, 128, 4, 4, 32, True, 32, 32),
        (2, 128, 4, 2, 32, True, 32, 32),
        (2, 128, 8, 1, 32, True, 32, 32),
        (1, 64, 2, 2, 16, False, 32, 32),
        (1, 256, 2, 2, 16, True, 64, 32),
    ],
)
def test_flash_plain_matches_pallas_interpret(B, S, H, Kv, h, causal, bq, bk):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, S, H, h)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, h)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, h)).astype(np.float32)
    want = flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True,
    )
    before = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert flash_attention.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # And against float64 math on the same inputs.
    q64, k64, v64 = (_t(x.astype(np.float64)) for x in (q, k, v))
    G = H // Kv
    logits = torch.einsum("bqkgh,bskh->bkgqs", q64.reshape(B, S, Kv, G, h), k64) * h**-0.5
    if causal:
        logits = logits.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    ref = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(logits, -1), v64).reshape(B, S, H, h)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def _paged_inputs(rng, B, S, H, Kv, h=128, P=13, ps=16, mp=4):
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    kv = rng.standard_normal((P, ps, 2 * Kv, h)).astype(np.float32)
    table = rng.choice(np.arange(1, P), size=(B, mp), replace=False).astype(np.int32)
    return q, kv, table


# -- #3 dedicated decode ------------------------------------------------------


@pytest.mark.parametrize(
    "B,S,H,Kv,lens,softcap",
    [
        (2, 1, 8, 2, [17, 42], 0.0),
        (2, 4, 8, 2, [19, 45], 0.0),
        (3, 1, 16, 2, [1, 33, 64], 30.0),
        (2, 1, 4, 2, [17, 42], 25.0),
        (2, 8, 8, 2, [19, 45], 0.0),  # S=8 at G=4: speculative verify, 32 rows
        (2, 8, 16, 2, [23, 50], 30.0),  # S=8 at G=8: 64 rows, softcap
        (2, 9, 8, 2, [19, 45], 0.0),  # S=9: past auto's 8, which the Pallas kernel takes
        (1, 17, 8, 2, [40], 0.0),  # S=17 at G=4: 68 rows (two row groups on the card)
    ],
)
def test_decode_plain_matches_pallas_interpret(B, S, H, Kv, lens, softcap):
    rng = np.random.default_rng(1)
    q, kv, table = _paged_inputs(rng, B, S, H, Kv)
    want = j_decode(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table), jnp.asarray(lens, jnp.int32),
        softcap=softcap, interpret=True,
    )
    before = paged_decode_attention.launches
    got = paged_decode_attention(
        _t(q), _t(kv), _t(table), torch.tensor(lens, dtype=torch.int32), softcap=softcap
    )
    assert paged_decode_attention.launches == before
    # Interpret mode runs the kernel's own online softmax: the repo's
    # decode tests hold it to 2e-4 against the gathered twin.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_decode_finished_slot_length_clamp():
    """kv_lengths past the table span clamp to it (a finished slot's
    decode overrun), on the port exactly as in the Pallas kernel."""
    rng = np.random.default_rng(2)
    q, kv, table = _paged_inputs(rng, 1, 1, 4, 2)
    over = np.asarray([4 * 16 + 7], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table), jnp.asarray(over), interpret=True)
    got = paged_decode_attention(_t(q), _t(kv), _t(table), _t(over))
    full = paged_decode_attention(_t(q), _t(kv), _t(table), torch.tensor([4 * 16], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-6)


def test_resolve_decode_kernel_keys_on_query_length():
    from kubeai_tpu.ops.paged_decode_attention import resolve_decode_kernel as j_resolve

    for mode in ("ragged", "dedicated", "auto"):
        for n in (1, MAX_DECODE_QUERY_LEN, MAX_DECODE_QUERY_LEN + 1, 512):
            assert resolve_decode_kernel(mode, n) == j_resolve(mode, n)


def test_quantized_pools_raise():
    """The kernels take a pool in q's dtype or in one byte per element,
    int8 or float8_e4m3fn (element codes 0, 1, 2); the wrappers' checks
    refuse every other pool dtype before a pointer reaches the kernel."""
    from kubeai_tpu_torch.ops._build import POOL_FP8, POOL_INT8, POOL_SAME
    from kubeai_tpu_torch.ops.paged_attention import check_paged_inputs

    rng = np.random.default_rng(0)
    q, kv, table = _paged_inputs(rng, 1, 1, 4, 2)
    lens = torch.tensor([5], dtype=torch.int32)
    for qdt in (torch.float32, torch.bfloat16):
        tq = _t(q).to(qdt)
        for pdt, code in ((qdt, POOL_SAME), (torch.int8, POOL_INT8),
                          (torch.float8_e4m3fn, POOL_FP8)):
            assert check_paged_inputs("t", tq, _t(kv).to(pdt), _t(table), lens)[1:] == (
                int(qdt == torch.bfloat16), code)
        other = torch.float32 if qdt == torch.bfloat16 else torch.bfloat16
        for pdt in (other, torch.float16, torch.uint8, torch.float8_e5m2):
            with pytest.raises(ValueError, match="kv_pages must be"):
                check_paged_inputs("t", tq, _t(kv).to(pdt), _t(table), lens)
