"""The port's ring attention (kubeai_tpu_torch.parallel.ring_attention)
against the JAX package's on the CPU: each sp rank a thread with its own
gloo group (parallel/group.py run_local_ranks), the JAX function over a
mesh of conftest's virtual CPU devices, on the same seeded inputs.

- forward at tests/test_ring_attention.py's three (sp, seq, heads, kv)
  cases within rtol / atol 2e-5, as that file holds JAX to dense
  attention;
- the gradients of the output's sum (its gradient case) within 1e-4;
- the online-softmax block alone, where the first query row has no key
  in the first block: l and o stay exactly 0 for it, and (o, l, m) after
  each block equal the JAX _block_attend's;
- a rank that skips a block after its queries still runs every pass's
  backward, and the ring counts its passes."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.parallel.mesh import make_mesh
from kubeai_tpu_torch.parallel.group import run_local_ranks

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

# The modules themselves (the JAX package's parallel/__init__ is free to
# export a function under the module's name).
jring = importlib.import_module("kubeai_tpu.parallel.ring_attention")
tring = importlib.import_module("kubeai_tpu_torch.parallel.ring_attention")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(4, 32, 4, 4), (8, 64, 4, 2), (2, 16, 8, 8)]


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def _port_ring(q, k, v, sp, grad=False):
    """The port at *sp* thread ranks: (output, and with *grad* the
    gradients of its sum), each rank's blocks concatenated."""
    blk = q.shape[1] // sp

    def rank(group):
        part = slice(group.rank * blk, (group.rank + 1) * blk)
        qb, kb, vb = (torch.from_numpy(a[:, part]).requires_grad_(grad) for a in (q, k, v))
        o = tring.ring_attention(qb, kb, vb, group)
        if grad:
            o.sum().backward()
            return o.detach(), qb.grad, kb.grad, vb.grad, group.stats["ring_pass"][0]
        return (o, group.stats["ring_pass"][0])

    ranks = run_local_ranks(sp, rank, "cpu")
    return [torch.cat([r[i] for r in ranks], dim=1).numpy() for i in range(len(ranks[0]) - 1)], \
        [r[-1] for r in ranks]


@pytest.mark.parametrize("sp,seq,heads,kv", CASES)
def test_forward_matches_jax(cpu_mesh_devices, sp, seq, heads, kv):
    h = 16
    q, k, v = _inputs((2, seq, heads, h), (2, seq, kv, h), seed=0)
    mesh = make_mesh(sp=sp)
    with mesh:
        want = jax.jit(lambda a, b, c: jring.ring_attention(a, b, c, mesh))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    (got,), passes = _port_ring(q, k, v, sp)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    assert passes == [sp - 1] * sp  # one pass a step, none after the last


def test_gradients_match_jax(cpu_mesh_devices):
    """tests/test_ring_attention.py's gradient case: sp 4, S 32, H = Kv 2."""
    q, k, v = _inputs((1, 32, 2, 8), (1, 32, 2, 8), seed=1)
    mesh = make_mesh(sp=4)

    def loss(a, b, c):
        with mesh:
            return jring.ring_attention(a, b, c, mesh).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    (out, *grads), passes = _port_ring(q, k, v, 4, grad=True)
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL, err_msg=name)
    assert np.isfinite(out).all()
    # Forward passes plus the backward's, the same count on every rank
    # (rank 0 attends to no block but its own).
    assert passes == [2 * 3] * 4


def test_block_attend_fully_masked_first_row():
    """Row 0 (position 0) sees no key of the first block (positions
    1..4): it keeps l = o = 0 and m at the finite -inf; the second block
    (positions 0..3) gives it its key. Each step equals JAX's."""
    rng = np.random.default_rng(7)
    B, Sq, H, Kv, h = 2, 4, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, h)).astype(np.float32)
    blocks = [(rng.normal(size=(B, Sq, Kv, h)).astype(np.float32),
               rng.normal(size=(B, Sq, Kv, h)).astype(np.float32), np.arange(1, 5)),
              (rng.normal(size=(B, Sq, Kv, h)).astype(np.float32),
               rng.normal(size=(B, Sq, Kv, h)).astype(np.float32), np.arange(0, 4))]
    q_pos = np.arange(Sq)
    scale = h**-0.5
    t_state = (torch.zeros((B, Sq, H, h)), torch.zeros((B, Sq, H)),
               torch.full((B, Sq, H), tring._NEG_INF))
    j_state = (jnp.zeros((B, Sq, H, h)), jnp.zeros((B, Sq, H)),
               jnp.full((B, Sq, H), jring._NEG_INF))
    for i, (k, v, k_pos) in enumerate(blocks):
        t_state = tring._block_attend(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(q_pos),
                                      torch.from_numpy(k_pos), scale, *t_state)
        j_state = jring._block_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(q_pos), jnp.asarray(k_pos), scale, *j_state)
        for got, want, name in zip(t_state, j_state, "olm"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL,
                                       err_msg=f"block {i} {name}")
        if i == 0:
            o, l, m = (t.numpy() for t in t_state)
            assert (o[:, 0] == 0).all() and (l[:, 0] == 0).all()
            assert (m[:, 0] == tring._NEG_INF).all() and (l[:, 1:] > 0).all()
    assert (t_state[1].numpy() > 0).all()
