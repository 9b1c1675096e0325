"""The port's sharded training step (kubeai_tpu_torch.train.trainer over a
parallel/mesh.py Mesh) against the JAX package's
``init_sharded_training`` at the same mesh, on the CPU (the harness and
its tolerances: tests/_torch_sharded.py):

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
  JAX the same way. Mixtral on meshes that split its tokens or experts:
  tests/test_torch_moe_mesh.py."""

import numpy as np
import pytest

from _torch_families import FAMILIES
from _torch_sharded import check, jax_cache, port_run
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

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


@pytest.fixture(scope="module")
def jax_runs(cpu_mesh_devices):
    """Each run's JAX reference, computed once (XLA's compiles stay off
    each test's clock)."""
    return jax_cache(RUNS)


def _check(name, jax_runs):
    jc, tc, batch, want = jax_runs(name)
    _, shape, ring = RUNS[name]
    return check(want, port_run(tc, shape, ring, batch, want[0]))


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
        loss, _, params, _ = port_run(tc, dict(dp=2, sp=4), ring, batch, init)[0]
        out[ring] = (loss, params["final_norm"].detach().numpy())
    assert np.isfinite(out[True][0])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4)
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-3, atol=1e-5)
