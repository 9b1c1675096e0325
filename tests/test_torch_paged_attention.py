"""Kernel #2's plain version (kubeai_tpu_torch.ops.paged_attention) against
the library's reference ``ref_ragged_paged_attention`` and the JAX
package's ``paged_attention_ragged``, with the cases of
tests/test_paged_kernel.py. Tolerance 2e-5: float32 attention on both
sides, summation order only. The CUDA kernel itself is held against this
plain version on the card (tests/test_torch_kernels.py, marker gpu)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops.paged_attention import paged_attention_ragged as j_ragged
from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _paged_inputs(rng, B, S, H, Kv, h=128, P=13, ps=16, mp=4):
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    kv = rng.standard_normal((P, ps, 2 * Kv, h)).astype(np.float32)
    table = rng.choice(np.arange(1, P), size=(B, mp), replace=False).astype(np.int32)
    return q, kv, table

PAGED_CASES = [
    (2, 1, 8, 2, [17, 42], None),  # plain decode
    (2, 4, 8, 2, [19, 45], None),  # speculative (G=3)
    (1, 16, 4, 4, [16], None),  # prefill-sized query block
    (2, 2, 4, 2, [30, 61], 30.0),  # softcap
    (3, 1, 16, 2, [1, 33, 64], None),  # extreme lengths
]


@pytest.mark.parametrize("B,S,H,Kv,lens,softcap", PAGED_CASES)
def test_paged_plain_matches_library_reference(B, S, H, Kv, lens, softcap):
    from jax.experimental.pallas.ops.tpu.ragged_paged_attention.kernel import (
        ref_ragged_paged_attention,
    )

    rng = np.random.default_rng(0)
    q, kv, table = _paged_inputs(rng, B, S, H, Kv)
    h = q.shape[-1]
    want = ref_ragged_paged_attention(
        jnp.asarray(q.reshape(B * S, H, h)), jnp.asarray(kv), jnp.asarray(lens, jnp.int32),
        jnp.asarray(table), jnp.arange(B + 1, dtype=jnp.int32) * S,
        jnp.asarray([B], jnp.int32), sm_scale=h**-0.5, soft_cap=softcap,
    )
    got = paged_attention_ragged(
        _t(q), _t(kv), _t(table), torch.tensor(lens, dtype=torch.int32), softcap=softcap or 0.0
    )
    np.testing.assert_allclose(got.numpy().reshape(B * S, H, h), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,S,H,Kv,lens,softcap", PAGED_CASES)
def test_paged_plain_matches_jax_wrapper(B, S, H, Kv, lens, softcap):
    rng = np.random.default_rng(3)
    q, kv, table = _paged_inputs(rng, B, S, H, Kv)
    want = j_ragged(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table), jnp.asarray(lens, jnp.int32),
        softcap=softcap or 0.0,
    )
    before = paged_attention_ragged.launches
    got = paged_attention_ragged(
        _t(q), _t(kv), _t(table), torch.tensor(lens, dtype=torch.int32), softcap=softcap or 0.0
    )
    assert paged_attention_ragged.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


