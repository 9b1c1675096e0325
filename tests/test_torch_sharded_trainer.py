"""The port's sharded training step (kubeai_tpu_torch.train.trainer over a
parallel/mesh.py Mesh) against the JAX package's
``init_sharded_training`` at the same mesh, on the CPU: the port's ranks
are threads with gloo groups (run_local_mesh), the JAX step runs over
conftest's 8 virtual CPU devices, and both start from the JAX package's
initial parameters (carried to every rank's block by params_from_jax and
shard_mesh_params: a torch.Generator cannot draw what jax.random.key draws).

- Llama at (dp 2, sp 2, tp 2) and (dp 2, sp 4), ring attention by the
  auto rule: the loss, every gradient (JAX's ``jax.value_and_grad(
  trainer.loss_fn)`` under the mesh against the port's summed gradients,
  gathered) and the updated parameters (JAX's jitted step against the
  port's step, gathered);
- ring against dense attention in the port at sp = 4, as
  tests/test_ring_attention.py's trainer case holds JAX;
- Qwen2 (q/k/v biases) at (sp 2, ep 2, tp 2), Gemma (a tied head, one KV
  head) at (dp 2, sp 2), Gemma2 (window and softcaps, so the dense arm
  by the auto rule) at (dp 2, sp 2, tp 2) and Mixtral at tp 2 (its
  router's gradient summed over tp, the experts' columns split), against
  JAX the same way;
- a MoE config on a mesh that splits tokens or experts raises, naming
  ROADMAP item 12c.

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
import pytest
import torch

from kubeai_tpu.parallel.mesh import make_mesh as jmake_mesh
from kubeai_tpu.train import trainer as jtrainer
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel.mesh import run_local_mesh
from kubeai_tpu_torch.parallel.sharding import gather_params, key_paths
from kubeai_tpu_torch.train import trainer as ttrainer

from _torch_families import FAMILIES, configs
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

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

LLAMA = dict(num_heads=4, num_kv_heads=2)
# name -> (family flags, mesh, ring_attention as passed)
RUNS = {
    "llama_dp2_sp2_tp2": (LLAMA, dict(dp=2, sp=2, tp=2), None),
    "llama_dp2_sp4": (LLAMA, dict(dp=2, sp=4), None),
    "qwen2_sp2_ep2_tp2": (FAMILIES["qwen2"], dict(sp=2, ep=2, tp=2), None),
    "gemma_dp2_sp2": (FAMILIES["gemma"], dict(dp=2, sp=2), None),
    "gemma2_dp2_sp2_tp2": (FAMILIES["gemma2"], dict(dp=2, sp=2, tp=2), None),
    "mixtral_tp2": (FAMILIES["mixtral"], dict(tp=2), None),
}


def _batch(V, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
            "mask": (rng.random((B, S)) < 0.8).astype(np.int32)}


def _configs(flags):
    from kubeai_tpu.models.base import ModelConfig as JMC
    from kubeai_tpu_torch.models.base import ModelConfig as TMC

    base = dict(vocab_size=272, hidden_size=64, intermediate_size=128, num_layers=2,
                dtype="float32", max_position=2048)
    return JMC(**{**base, **flags}), TMC(**{**base, **flags})


def _jax_run(jc, shape, ring, batch):
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


def _port_run(tc, shape, ring, batch, init):
    """The port at *shape*: (loss, gathered grads, gathered params after
    the step) from rank 0, and every rank's loss."""

    def rank(mesh):
        full = params_from_jax(init, tc, "cpu")
        params, _, step = ttrainer.init_sharded_training(
            tc, mesh, lr=LR, ring_attention=ring, device="cpu", params=full)
        loss = float(step(batch))
        grads = {k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict) else v.grad)
                 for k, v in params.items()}
        return (loss, gather_params(grads, tc, mesh),
                gather_params({k: v for k, v in params.items()}, tc, mesh))

    out = run_local_mesh(shape, rank, "cpu", timeout=300)
    return out[0], [o[0] for o in out]


@pytest.fixture(scope="module")
def jax_runs(cpu_mesh_devices):
    """Each run's JAX reference, computed once (XLA's compiles stay off
    each test's clock)."""
    cache = {}

    def get(name):
        if name not in cache:
            flags, shape, ring = RUNS[name]
            jc, tc = _configs(flags)
            batch = _batch(jc.vocab_size)
            cache[name] = (jc, tc, batch, _jax_run(jc, shape, ring, batch))
        return cache[name]

    return get


def _tree_np(tree):
    return {p: t.detach().numpy() for p, t in key_paths(tree)}


def _jax_leaves(tree):
    return {p: np.asarray(v) for p, v in key_paths(tree)}


def _check(name, jax_runs):
    jc, tc, batch, (init, want_loss, want_grads, want_params) = jax_runs(name)
    _, shape, ring = RUNS[name]
    (loss, grads, params), losses = _port_run(tc, shape, ring, batch, init)
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


@pytest.mark.parametrize("name", ["llama_dp2_sp2_tp2", "llama_dp2_sp4"])
def test_llama_step_matches_jax(name, jax_runs):
    _check(name, jax_runs)


@pytest.mark.parametrize("name", ["qwen2_sp2_ep2_tp2", "gemma_dp2_sp2", "gemma2_dp2_sp2_tp2",
                                  "mixtral_tp2"])
def test_family_step_matches_jax(name, jax_runs):
    _check(name, jax_runs)


def test_ring_equals_dense_at_sp4(jax_runs):
    """tests/test_ring_attention.py's trainer case in the port: the same
    step with ring attention and with the dense arm gives the same loss
    and the same updated final_norm (rtol 1e-3, atol 1e-5 as there)."""
    jc, tc, batch, (init, *_) = jax_runs("llama_dp2_sp4")
    out = {}
    for ring in (True, False):
        (loss, _, params), _ = _port_run(tc, dict(dp=2, sp=4), ring, batch, init)
        out[ring] = (loss, params["final_norm"].detach().numpy())
    assert np.isfinite(out[True][0])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-3, atol=1e-5)


def test_moe_on_a_token_or_expert_mesh_names_item_12c():
    """MoE's capacity is taken over the global tokens in JAX; a rank would
    take it over its block (ROADMAP item 12c). tp alone trains."""
    _, tc = configs("mixtral")
    for shape in (dict(dp=2), dict(sp=2), dict(ep=2)):
        def rank(mesh):
            with pytest.raises(NotImplementedError, match="item 12c"):
                ttrainer.init_sharded_training(tc, mesh, device="cpu")
            return True
        assert all(run_local_mesh(shape, rank, "cpu"))

    def tp_only(mesh):
        _, _, step = ttrainer.init_sharded_training(tc, mesh, lr=LR, device="cpu")
        return float(step(_batch(tc.vocab_size)))

    losses = run_local_mesh(dict(tp=2), tp_only, "cpu")
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
