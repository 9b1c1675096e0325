"""The port's one-card training step (kubeai_tpu_torch.train.trainer)
against the JAX package's kubeai_tpu.train.trainer on the CPU, at tiny
float32 widths: ``loss_fn`` and five ``train_step``s (optax.adamw(lr,
weight_decay=0.0) against torch AdamW) from one set of weights carried
across by ``params_from_jax``, for a Llama-style config and a
Gemma2-style one (sliding window, both softcaps, post-norms, 1 + w
norms, a tied head), so the gradients cross every family option of the
cache-less path. A mesh of two thread ranks and ring attention on one
device train; the refusals name their ROADMAP items (the sharded step
against JAX's: tests/test_torch_sharded_trainer.py).

Adam divides each gradient by its running norm plus eps (1e-8), so an
element whose gradient sums to within a few eps of zero moves by
anywhere in [-lr, lr] as its last bits change: the two packages' float32
gradients agree to ~1e-6 relative, and such elements differ by a few
hundredths of a step. Each parameter is therefore held to 0.1 of a
step per element, and the whole update (parameters after minus before)
to 1e-3 in relative L2 norm: a few such elements among ~16k give
~4e-4, a real disagreement of the bulk gives O(1). Torch AdamW alone, on the same gradients
as optax, agrees to float32 rounding (test_torch_finetune.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.train import trainer as jtrainer
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel.mesh import run_local_mesh
from kubeai_tpu_torch.train import trainer as ttrainer

from _torch_families import BASE, FAMILIES, jax_params
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

LR = 1e-3
STEPS = 5
# float32 on both sides; the CPU port attends in float64, JAX in float32.
TOL = dict(rtol=1e-5, atol=0.1 * LR)
UPDATE_RTOL = 1e-3

CONFIGS = {
    "llama": dict(num_heads=4, num_kv_heads=2),
    "gemma2": FAMILIES["gemma2"],
}


def _configs(family):
    jc = JMC(**{**BASE, **CONFIGS[family]})
    return jc, TMC(**{**BASE, **CONFIGS[family]})


def _batches(n, B=2, S=24, V=272, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, V, (B, S)).astype(np.int32)
        mask = (rng.random((B, S)) < 0.8).astype(np.int32)
        out.append({"tokens": tokens, "targets": np.roll(tokens, -1, axis=1), "mask": mask})
    return out


def _one_device_mesh():
    # The JAX loss pins positions to P("dp", "sp"), which needs a mesh.
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))


@pytest.mark.parametrize("family", list(CONFIGS))
def test_loss_and_adamw_steps_match_jax(family):
    jc, tc = _configs(family)
    jp = jax_params(jc, seed=3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    for t in ttrainer.leaves(tp):
        t.requires_grad_(True)
    batches = _batches(STEPS)

    opt = jtrainer.make_optimizer(LR)
    step = jax.jit(functools.partial(jtrainer.train_step, config=jc, optimizer=opt))
    state = opt.init(jp)
    toptim = ttrainer.make_optimizer(tp, LR)
    with jax.set_mesh(_one_device_mesh()):
        b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
        want0 = float(jtrainer.loss_fn(jp, jc, b0["tokens"], b0["targets"], b0["mask"]))
        for i, b in enumerate(batches):
            jloss, jp, state = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
            tloss = ttrainer.train_step(tp, toptim, {k: torch.from_numpy(v) for k, v in b.items()},
                                        tc)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    t0 = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    with torch.no_grad():
        got0 = ttrainer.loss_fn(params_from_jax(jax.tree.map(np.asarray, jax_params(jc, seed=3)),
                                                tc, "cpu"), tc, t0["tokens"], t0["targets"],
                                t0["mask"])
    np.testing.assert_allclose(float(got0), want0, rtol=1e-5)

    _assert_same_update(tp, jp, jax_params(jc, seed=3))


def _assert_same_update(tp, jp, start):
    """The port's parameters *tp* after the steps against the JAX
    package's *jp*, both from *start*."""
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(want) == len(ttrainer.leaves(tp))
    for (path, leaf), before in zip(want, jax.tree.leaves(start)):
        node = tp
        for key in path:
            node = node[key.key]
        got, leaf, before = node.detach().numpy(), np.asarray(leaf), np.asarray(before)
        what = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got, leaf, **TOL, err_msg=what)
        err = np.linalg.norm(got - leaf) / np.linalg.norm(leaf - before)
        assert err <= UPDATE_RTOL, (what, err)


def test_init_sharded_training_on_one_device_lowers_the_loss():
    _, tc = _configs("llama")
    params, optimizer, step = ttrainer.init_sharded_training(tc, seed=1, lr=1e-2, device="cpu")
    assert all(t.dtype == torch.float32 and t.requires_grad for t in ttrainer.leaves(params))
    assert isinstance(optimizer, torch.optim.AdamW)
    assert optimizer.defaults["weight_decay"] == 0.0 and optimizer.defaults["eps"] == 1e-8
    b = {k: torch.from_numpy(v) for k, v in _batches(1, seed=4)[0].items()}
    losses = [float(step(b)) for _ in range(4)]
    assert losses[-1] < losses[0], losses


def test_refusals_name_their_roadmap_items():
    """bf16 and a missing card are refused; a MoE config whose experts
    the ep axis does not divide is refused; a mesh of several devices
    must be a rank's Mesh (a shape alone has no process groups). A mesh
    and ring attention train (the two cases below)."""
    _, tc = _configs("llama")
    with pytest.raises(ValueError, match="float32"):
        ttrainer.init_sharded_training(tc.replace(dtype="bfloat16"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.init_sharded_training(tc)
    with pytest.raises(TypeError, match="Mesh"):
        ttrainer.init_sharded_training(tc, mesh=_MeshShape(dp=2, sp=1), device="cpu")
    moe = TMC(**{**BASE, "num_heads": 4, "num_kv_heads": 2, "num_experts": 4,
                 "num_experts_per_tok": 2})

    def rank(mesh):
        with pytest.raises(ValueError, match="ep=3 must divide the experts"):
            ttrainer.init_sharded_training(moe, mesh, device="cpu")
        return True

    # The ranks exchange nothing before the refusal, so they meet over the
    # in-process exchange: a gloo full mesh of three thread ranks over
    # loopback failed to connect ("Connection closed by peer") beside the
    # other test workers' groups.
    assert all(run_local_mesh(dict(ep=3), rank, "cpu", backend="threads"))
    params, _, _ = ttrainer.init_sharded_training(tc, mesh=_MeshShape(dp=1, sp=1), device="cpu")
    assert isinstance(params["embed"], torch.Tensor)


def test_a_mesh_of_two_ranks_trains():
    """dp = 2 over two thread ranks from the one-device weights: the same
    loss as one device, and the loss falls over four steps."""
    _, tc = _configs("llama")
    full = tl.init_params(tc, torch.Generator().manual_seed(1), device="cpu",
                          dtype=torch.float32)
    batch = _batches(1, seed=4)[0]
    _, _, one = ttrainer.init_sharded_training(tc, lr=1e-2, device="cpu", params=full)
    want = float(one({k: torch.from_numpy(v) for k, v in batch.items()}))

    def rank(mesh):
        _, _, step = ttrainer.init_sharded_training(tc, mesh, lr=1e-2, params=full)
        return [float(step(batch)) for _ in range(4)]

    for losses in run_local_mesh(dict(dp=2), rank, "cpu"):
        np.testing.assert_allclose(losses[0], want, rtol=1e-5)
        assert losses[-1] < losses[0], losses


def test_ring_attention_on_one_device_trains():
    """``ring_attention=True`` without a mesh: a mesh of one rank, ring
    attention over one block; its first step's loss equals the dense
    one-device step's."""
    _, tc = _configs("llama")
    b = {k: torch.from_numpy(v) for k, v in _batches(1, seed=4)[0].items()}
    params, optimizer, step = ttrainer.init_sharded_training(tc, seed=1, lr=1e-2,
                                                             ring_attention=True, device="cpu")
    assert isinstance(optimizer, torch.optim.AdamW)
    _, _, dense = ttrainer.init_sharded_training(tc, seed=1, lr=1e-2, device="cpu")
    losses = [float(step(b)) for _ in range(3)]
    np.testing.assert_allclose(losses[0], float(dense(b)), rtol=1e-5)
    assert losses[-1] < losses[0], losses


class _MeshShape:
    """A mesh as the JAX Mesh exposes its axes (``shape``: name -> size)."""

    def __init__(self, **axes):
        self.shape = axes
