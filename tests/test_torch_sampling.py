"""The port's sampler (kubeai_tpu_torch.engine.sampling) against the JAX
package's (kubeai_tpu.engine.sampling).

Greedy, penalties and logit bias are deterministic and compared exactly
(float32, tolerance 1e-6). Random draws cannot match bit for bit (the
port hashes (seed, position) where JAX uses threefry keys), so top-k /
top-p are compared as distributions over 4000 draws each: both samplers
must keep to the same candidate set, and their empirical distributions
must be within 0.05 total variation (the sampling noise of 4000 draws
over ~10 candidates is ~0.02)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import sampling as js
from kubeai_tpu_torch.engine import sampling as ts

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


def _jax_sample(logits, temp, top_p, top_k, n, seed=0):
    keys = jax.random.split(jax.random.key(seed), n)
    return np.asarray(js.sample(
        jnp.asarray(np.broadcast_to(logits, (n, logits.shape[-1]))), keys,
        jnp.full((n,), temp, jnp.float32), jnp.full((n,), top_p, jnp.float32),
        jnp.full((n,), top_k, jnp.int32),
    ))


def _torch_sample(logits, temp, top_p, top_k, n):
    return ts.sample(
        torch.from_numpy(np.broadcast_to(logits, (n, logits.shape[-1])).copy()),
        torch.arange(n), torch.full((n,), 7), torch.full((n,), temp),
        torch.full((n,), top_p), torch.full((n,), top_k),
    ).numpy()


def test_greedy_matches_jax_including_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    logits[1, [5, 9, 200]] = 10.0  # a tie: both take the first maximum
    logits[2, :] = 0.0
    zeros = np.zeros(6, np.float32)
    want = js.sample(
        jnp.asarray(logits), jax.random.split(jax.random.key(0), 6), jnp.asarray(zeros),
        jnp.ones(6), jnp.zeros(6, jnp.int32),
    )
    got = ts.sample(
        torch.from_numpy(logits), torch.arange(6), torch.arange(6), torch.from_numpy(zeros),
        torch.ones(6), torch.zeros(6, dtype=torch.int64),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == 5 and got[2] == 0


@pytest.mark.parametrize("temp,top_p,top_k", [(1.0, 1.0, 5), (0.7, 0.6, 0), (1.3, 0.9, 8)])
def test_topk_topp_distribution_matches_jax(temp, top_p, top_k):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(64) * 2).astype(np.float32)
    n = 4000
    want = _jax_sample(logits, temp, top_p, top_k, n)
    got = _torch_sample(logits, temp, top_p, top_k, n)
    # The candidate set, from the sampler's definition: both keep to it.
    order = np.argsort(-logits, kind="stable")
    k = top_k if top_k > 0 else len(logits)
    z = logits[order[:k]] / temp
    p = np.exp(z - z.max())
    p /= p.sum()
    allowed = set(order[:k][(np.cumsum(p) - p) < top_p])
    assert set(got) <= allowed and set(want) <= allowed
    hj = np.bincount(want, minlength=64) / n
    ht = np.bincount(got, minlength=64) / n
    assert 0.5 * np.abs(hj - ht).sum() < 0.05


def test_penalties_and_bias_match_jax():
    rng = np.random.default_rng(2)
    B, V, W = 3, 50, 12
    logits = rng.standard_normal((B, V)).astype(np.float32)
    hist = rng.integers(0, V, (B, W)).astype(np.int32)
    valid = rng.random((B, W)) > 0.4
    pres = np.array([0.0, 0.5, 1.5], np.float32)
    freq = np.array([0.3, 0.0, -0.2], np.float32)
    want = js.apply_penalties(*(jnp.asarray(a) for a in (logits, hist, valid, pres, freq)))
    got = ts.apply_penalties(*(torch.from_numpy(a) for a in (logits, hist, valid, pres, freq)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    ids = np.array([[3, 3, 0], [7, 0, 0], [49, 1, 2]], np.int32)  # duplicates accumulate
    vals = np.array([[5.0, -1.0, 0.0], [-100.0, 0.0, 0.0], [2.5, 1.0, -3.0]], np.float32)
    want = js.apply_logit_bias(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(vals))
    got = ts.apply_logit_bias(torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_seeded_stream_is_independent_of_batch_placement():
    """A seeded request draws the same tokens whatever row it occupies and
    whatever else is in the batch (the proxy replays seeded requests)."""
    rng = np.random.default_rng(3)
    row = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    streams = []
    for slot, B in ((0, 1), (3, 5), (6, 8)):
        out = []
        for pos in range(40, 60):
            logits = torch.from_numpy(rng.standard_normal((B, 100)).astype(np.float32))
            logits[slot] = row
            seeds = torch.from_numpy(rng.integers(0, 2**32, B))
            seeds[slot] = 1234
            got = ts.sample(
                logits, seeds, torch.full((B,), pos), torch.full((B,), 0.9),
                torch.full((B,), 0.95), torch.zeros(B, dtype=torch.int64),
            )
            out.append(int(got[slot]))
        streams.append(out)
    assert streams[0] == streams[1] == streams[2]
    assert len(set(streams[0])) > 3  # the positions really draw fresh noise


def test_gumbel_noise_is_gumbel():
    g = ts.gumbel_noise(torch.arange(2000), torch.full((2000,), 5), 64).double()
    assert abs(g.mean().item() - 0.5772) < 0.01  # Euler–Mascheroni
    assert abs(g.var().item() - np.pi**2 / 6) < 0.05
