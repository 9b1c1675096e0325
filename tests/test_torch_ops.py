"""The port's plain ops (kubeai_tpu_torch.ops) against the JAX package's
(kubeai_tpu.ops) on the same float32 inputs made from a seed.

Tolerance 1e-5 (abs and rel): both sides compute in float32; only the
summation order of the reductions and einsums differs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops import attention as j_attn
from kubeai_tpu.ops import norms as j_norms
from kubeai_tpu.ops import rope as j_rope
from kubeai_tpu_torch.ops import attention as t_attn
from kubeai_tpu_torch.ops import norms as t_norms
from kubeai_tpu_torch.ops import rope as t_rope

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


TOL = dict(rtol=1e-5, atol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "scaling",
    [
        None,
        # Llama-3.1's published scaling.
        dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0, original_max_position=8192),
        # Linear scaling, expressed as the JAX config loader expresses it.
        dict(factor=4.0, low_freq_factor=1e9, high_freq_factor=2e9, original_max_position=4096),
    ],
)
def test_rope_matches_jax(scaling):
    h, theta = 128, 500000.0
    j_sc = None if scaling is None else j_rope.RopeScaling(**scaling)
    from kubeai_tpu_torch.models.base import RopeScaling

    t_sc = None if scaling is None else RopeScaling(**scaling)
    np.testing.assert_array_equal(
        t_rope.rope_frequencies(h, theta, t_sc), j_rope.rope_frequencies(h, theta, j_sc)
    )
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 7, 4, h)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, h)).astype(np.float32)
    pos = rng.integers(0, 20000, (2, 7)).astype(np.int32)
    inv = j_rope.rope_frequencies(h, theta, j_sc)
    jq, jk = j_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), jnp.asarray(inv))
    tq, tk = t_rope.apply_rope(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos), torch.from_numpy(inv)
    )
    # Angles reach ~2e4 rad: float32 cos/sin of large arguments differ in
    # the last bits between libraries, scaled by |x| ~ 4.
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)


def test_config_fields_match_jax():
    """The port's ModelConfig mirrors the JAX one field for field, so a
    config converts by name (the tests rely on it)."""
    from kubeai_tpu.models.base import ModelConfig as JMC
    from kubeai_tpu_torch.models.base import ModelConfig as TMC

    j = {f.name: f.default for f in dataclasses.fields(JMC)}
    t = {f.name: f.default for f in dataclasses.fields(TMC)}
    assert j == t


@pytest.mark.parametrize(
    "H,Kv,softcap,masked",
    [(4, 4, 0.0, True), (8, 2, 0.0, True), (8, 2, 30.0, True), (4, 1, 0.0, False)],
)
def test_attention_matches_jax(H, Kv, softcap, masked):
    rng = np.random.default_rng(2)
    B, Sq, Sk, h = 2, 5, 9, 32
    q = rng.standard_normal((B, Sq, H, h)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Kv, h)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Kv, h)).astype(np.float32)
    mask = rng.random((B, Sq, Sk)) > 0.3 if masked else None
    want = j_attn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), softcap=softcap,
    )
    got = t_attn.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), softcap=softcap,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_mask_matches_jax():
    for sq, sk, off in ((4, 4, 0), (3, 9, 6)):
        np.testing.assert_array_equal(
            t_attn.causal_mask(sq, sk, off).numpy(), np.asarray(j_attn.causal_mask(sq, sk, off))
        )
