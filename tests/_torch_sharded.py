"""Shared by the port's sharded-training parity tests
(test_torch_sharded_trainer.py, test_torch_moe_mesh.py): the JAX
package's ``init_sharded_training`` at a mesh of conftest's 8 virtual CPU
devices against the port's (kubeai_tpu_torch.train.trainer over a
parallel/mesh.py Mesh of gloo thread ranks, run_local_mesh), both from
the JAX package's initial parameters (carried to every rank's block by
params_from_jax and shard_mesh_params: a torch.Generator cannot draw what
jax.random.key draws).

Tolerances: float32 on both sides, the port's CPU dense attention in
float64 and its sums over other rank splits. The loss within 1e-5
relative; gradients within 1e-4 relative and 1e-4 of the leaf's max |g|;
the parameters after the AdamW step as tests/test_torch_trainer.py holds
them: 0.1 of a step per element, and 1e-3 of the norm of the update of
the elements whose gradient is at least 1e-6 (Adam moves an element
whose gradient sums to ~0 by anything in [-lr, lr], and a small leaf
such as Qwen2's bk has a few)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from kubeai_tpu.parallel.mesh import make_mesh as jmake_mesh
from kubeai_tpu.train import trainer as jtrainer
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel.mesh import run_local_mesh
from kubeai_tpu_torch.parallel.sharding import gather_params, key_paths
from kubeai_tpu_torch.train import trainer as ttrainer

LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_TOL = dict(rtol=1e-5, atol=0.1 * LR)
UPDATE_RTOL = 1e-3
# Adam's first step is lr * g / (|g| + 1e-8): below 100 eps its size
# follows the gradient's last bits (the two packages' gradients differ by
# ~1e-8 absolute), so the update's norm is taken over the other elements.
DETERMINED = 1e-6
B, S = 4, 32


def batch(V, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
            "mask": (rng.random((B, S)) < 0.8).astype(np.int32)}


def configs(flags):
    from kubeai_tpu.models.base import ModelConfig as JMC
    from kubeai_tpu_torch.models.base import ModelConfig as TMC

    base = dict(vocab_size=272, hidden_size=64, intermediate_size=128, num_layers=2,
                dtype="float32", max_position=2048)
    return JMC(**{**base, **flags}), TMC(**{**base, **flags})


def jax_run(jc, shape, ring, batch):
    """JAX's init_sharded_training at *shape*: (initial params, loss,
    grads, params after one step), all numpy."""
    mesh = jmake_mesh(**shape)
    params, opt_state, _, step, data_sharding = jtrainer.init_sharded_training(
        jc, mesh, seed=0, lr=LR, ring_attention=ring)
    init = jax.tree.map(np.asarray, params)
    ring_mesh = mesh if ttrainer.ring_rule(jc, mesh, ring) else None
    b = {k: jax.device_put(jnp.asarray(v), data_sharding) for k, v in batch.items()}
    with mesh:
        loss, grads = jax.jit(functools.partial(
            jax.value_and_grad(jtrainer.loss_fn), config=jc, ring_mesh=ring_mesh))(
                params, tokens=b["tokens"], targets=b["targets"], mask=b["mask"])
        grads = jax.tree.map(np.asarray, grads)
        step_loss, params, _ = step(params, opt_state, b)
    np.testing.assert_allclose(float(step_loss), float(loss), rtol=1e-6)
    return init, float(loss), grads, jax.tree.map(np.asarray, params)


def jax_cache(runs):
    """``get(name)``: the JAX reference of ``runs[name]`` = (family flags,
    mesh, ring_attention as passed), computed once: (JAX config, port
    config, batch, jax_run's result)."""
    cache = {}

    def get(name):
        if name not in cache:
            flags, shape, ring = runs[name]
            jc, tc = configs(flags)
            b = batch(jc.vocab_size)
            cache[name] = (jc, tc, b, jax_run(jc, shape, ring, b))
        return cache[name]

    return get


def port_run(tc, shape, ring, batch, init):
    """The port at *shape*, one (loss, gathered grads, gathered params
    after the step, the step's MoE routes) per rank, in rank order."""

    def rank(mesh):
        full = params_from_jax(init, tc, "cpu")
        params, _, step = ttrainer.init_sharded_training(
            tc, mesh, lr=LR, ring_attention=ring, device="cpu", params=full)
        loss = float(step(batch))
        grads = {k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict) else v.grad)
                 for k, v in params.items()}
        return (loss, gather_params(grads, tc, mesh),
                gather_params({k: v for k, v in params.items()}, tc, mesh), step.routes)

    return run_local_mesh(shape, rank, "cpu", timeout=300)


def _tree_np(tree):
    return {p: t.detach().numpy() for p, t in key_paths(tree)}


def _jax_leaves(tree):
    return {p: np.asarray(v) for p, v in key_paths(tree)}


def check(want, ranks):
    """Hold port_run's *ranks* to jax_run's *want*: the loss (the same on
    every rank), every gradient and every updated parameter. Returns
    (loss, the gathered gradients as numpy)."""
    init, want_loss, want_grads, want_params = want
    loss, grads, params, _ = ranks[0]
    losses = [r[0] for r in ranks]
    assert len(set(losses)) == 1, losses  # the global loss on every rank
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    got_g, want_g = _tree_np(grads), _jax_leaves(want_grads)
    got_p, want_p, start = _tree_np(params), _jax_leaves(want_params), _jax_leaves(init)
    assert set(got_g) == set(want_g) == set(got_p)
    for path in want_g:
        what = "/".join(path)
        scale = np.abs(want_g[path]).max()
        np.testing.assert_allclose(got_g[path], want_g[path], rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=f"grad {what}")
        np.testing.assert_allclose(got_p[path], want_p[path], **STEP_TOL,
                                   err_msg=f"param {what}")
        sure = np.abs(want_g[path]) >= DETERMINED
        step = np.linalg.norm((want_p[path] - start[path])[sure])
        err = np.linalg.norm((got_p[path] - want_p[path])[sure]) / step
        assert err <= UPDATE_RTOL, (what, err)
    return loss, got_g
