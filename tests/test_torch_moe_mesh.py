"""Mixtral on a mesh that splits its tokens (dp, sp) or its experts (ep)
in the port (``llama.moe_mlp_mesh``, kubeai_tpu_torch.train.trainer over
a parallel/mesh.py Mesh) against the JAX package, on the CPU, at a
capacity factor of 0.5: pairs are dropped there, and which ones depends
on the capacity being taken over the global tokens in global order (at
the default 2.0 the tiny config's capacity is T and nothing drops).

- the training step at (dp 2, ep 2, tp 2), (sp 2, ep 2, tp 2; ring
  attention by the auto rule) and (dp 2, sp 2, ep 2) against JAX's
  ``init_sharded_training`` at the same mesh (tests/_torch_sharded.py's
  harness and tolerances; the router ``wr`` among the gradients);
- each layer's top-k expert ids and keep mask in that step against
  JAX's, exactly: a different routing is reported with JAX's logit
  margin between the k-th and the next expert, never hidden by a
  tolerance;
- the forward at (dp 2, ep 2, tp 2) against JAX's ``llama.apply`` under
  ``make_mesh(tp=2, ep=2, dp=2)``, logits within 1e-4, as
  tests/test_mixtral.py holds JAX;
- ``moe_mlp_mesh`` alone on every mesh against JAX's ``moe_mlp`` of the
  global batch within 1e-4, and the canary: ``moe_mlp`` on each rank's
  block alone (a per-rank capacity) differs from it beyond that."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.models import llama as jl
from kubeai_tpu.parallel.mesh import make_mesh as jmake_mesh
from kubeai_tpu.parallel.sharding import llama_param_specs, shard_tree
from kubeai_tpu.train import trainer as jtrainer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel.mesh import run_local_mesh
from kubeai_tpu_torch.parallel.sharding import shard_mesh_params
from kubeai_tpu_torch.train import trainer as ttrainer

from _torch_families import FAMILIES
from _torch_sharded import check, jax_cache, port_run
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

MIXTRAL = {**FAMILIES["mixtral"], "moe_capacity_factor": 0.5}
MESHES = {"dp2_ep2_tp2": dict(dp=2, ep=2, tp=2), "sp2_ep2_tp2": dict(sp=2, ep=2, tp=2),
          "dp2_sp2_ep2": dict(dp=2, sp=2, ep=2)}
RUNS = {name: (MIXTRAL, shape, None) for name, shape in MESHES.items()}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_runs(cpu_mesh_devices):
    return jax_cache(RUNS)


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """Each run's port ranks (port_run), computed once for the step and
    the routing cases."""
    cache = {}

    def get(name):
        if name not in cache:
            _, tc, batch, want = jax_runs(name)
            cache[name] = port_run(tc, MESHES[name], None, batch, want[0])
        return cache[name]

    return get


@contextlib.contextmanager
def _recording_routes(out: list):
    """JAX's moe_mlp, while the block runs, also hands each call's (wr,
    top-k ids, keep, router logits) of the global batch to *out*, by JAX's
    own formulas (kubeai_tpu/models/llama.py::moe_mlp); the layer is told
    by its wr (a debug callback inside the layer scan carries no index)."""
    orig = jl.moe_mlp

    def moe_mlp(x, wr, wg, wu, wd, k, capacity_factor=2.0):
        B, S, D = x.shape
        T, E = B * S, wr.shape[-1]
        C = max(int(np.ceil(k * T / E * capacity_factor)), 1)
        logits = (x.reshape(T, D) @ wr).astype(jnp.float32)
        _, top = jax.lax.top_k(logits, k)
        onehot = jax.nn.one_hot(top.reshape(T * k), E, dtype=jnp.float32)
        pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
        jax.debug.callback(lambda *a: out.append(tuple(np.asarray(v) for v in a)), wr,
                           top.reshape(B, S, k), (pos < C).reshape(B, S, k),
                           logits.reshape(B, S, E))
        return orig(x, wr, wg, wu, wd, k, capacity_factor)

    jl.moe_mlp = moe_mlp
    try:
        yield
    finally:
        jl.moe_mlp = orig


def _jax_routes(jc, shape, init, batch):
    """JAX's (top-k ids, keep, router logits) of each layer in the
    training forward (``trainer.loss_fn`` under the mesh, ring attention
    by the auto rule)."""
    mesh = jmake_mesh(**shape)
    params = shard_tree(jax.tree.map(jnp.asarray, init), llama_param_specs(jc, fsdp=True), mesh)
    ring_mesh = mesh if ttrainer.ring_rule(jc, mesh, None) else None
    calls: list = []
    with _recording_routes(calls), mesh:
        jax.jit(lambda p, t, g, m: jtrainer.loss_fn(p, jc, t, g, m, ring_mesh=ring_mesh))(
            params, *(jnp.asarray(batch[k]) for k in ("tokens", "targets", "mask"))
        ).block_until_ready()
    wr = np.asarray(init["layers"]["wr"])
    layers = [next(li for li in range(len(wr)) if np.array_equal(c[0], wr[li])) for c in calls]
    assert sorted(layers) == list(range(len(wr))), layers
    return [calls[layers.index(li)][1:] for li in range(len(wr))]


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_step_matches_jax(name, jax_runs, port_runs):
    check(jax_runs(name)[3], port_runs(name))


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_routing_matches_jax(name, jax_runs, port_runs):
    jc, _, batch, (init, *_) = jax_runs(name)
    want = _jax_routes(jc, MESHES[name], init, batch)
    ranks = port_runs(name)
    k = jc.num_experts_per_tok
    for r, rank in enumerate(ranks):
        for li, ((ids, keep), (want_ids, want_keep, logits)) in enumerate(zip(rank[3], want)):
            ids, keep = ids.numpy(), keep.numpy()
            top = np.sort(logits, axis=-1)[..., ::-1]
            margin = top[..., k - 1] - top[..., k]  # JAX's gap past the k-th expert
            differ = np.argwhere((ids != want_ids).any(-1))
            ties = [f"token (b {b}, s {s}): port {ids[b, s].tolist()}, JAX "
                    f"{want_ids[b, s].tolist()}, JAX's margin {margin[b, s]:.3g}"
                    for b, s in differ]
            assert not ties, f"rank {r} layer {li} routes differently: " + "; ".join(ties)
            assert np.array_equal(keep, want_keep), (r, li, np.argwhere(keep != want_keep))
    # Pairs drop at this factor, so the keep mask is a real check.
    assert all((~w[1]).sum() > 0 for w in want)


def test_moe_forward_matches_jax_on_an_expert_mesh(cpu_mesh_devices):
    """tests/test_mixtral.py's test_ep_sharded_matches in the port: the
    logits at (dp 2, ep 2, tp 2), each rank's block gathered, against
    JAX's sharded forward."""
    from _torch_families import configs, jax_params

    jc, tc = configs("mixtral", moe_capacity_factor=0.5)
    jp = jax_params(jc)
    mesh = jmake_mesh(tp=2, ep=2, dp=2)
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (4, 8)).astype(np.int32)
    pos = np.broadcast_to(np.arange(8)[None, :], (4, 8))
    with mesh:
        want, _ = jax.jit(lambda p, t, q: jl.apply(p, jc, t, q))(
            shard_tree(jp, llama_param_specs(jc), mesh), jnp.asarray(tokens), jnp.asarray(pos))
    full = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")

    def rank(m):
        t, q = (torch.from_numpy(np.ascontiguousarray(m.block(a))) for a in (tokens, pos))
        logits, _ = tl.apply(shard_mesh_params(full, tc, m), tc, t, q, mesh=m)
        return m.gather_blocks(logits.detach())

    for got in run_local_mesh(MESHES["dp2_ep2_tp2"], rank, "cpu"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _moe_layer(seed=0):
    """Layer 0's router and experts of the tiny Mixtral at factor 0.5 and a
    seeded MoE input [B, S, D] (numpy)."""
    from _torch_families import configs, jax_params

    jc, _ = configs("mixtral", moe_capacity_factor=0.5)
    lw = {k: np.array(v[0]) for k, v in jax_params(jc, seed)["layers"].items()}
    x = np.random.default_rng(seed + 7).normal(size=(4, 32, jc.hidden_size)).astype(np.float32)
    want = np.asarray(jl.moe_mlp(jnp.asarray(x), *(jnp.asarray(lw[k]) for k in
                                                   ("wr", "wg", "wu", "wd")),
                                 jc.num_experts_per_tok, jc.moe_capacity_factor))
    return jc, lw, x, want


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_mlp_mesh_matches_jax(name):
    """The mesh form alone: each rank gives its block's partial output
    from its experts' tp part; their sum over (ep, tp), its blocks placed
    by (dp, sp), is JAX's moe_mlp of the global batch."""
    jc, lw, x, want = _moe_layer()
    w = {k: torch.from_numpy(v) for k, v in lw.items()}

    def rank(m):
        El, Fl = jc.num_experts // m.shape["ep"], jc.intermediate_size // m.shape["tp"]
        e, t = slice(m.coords["ep"] * El, (m.coords["ep"] + 1) * El), \
            slice(m.coords["tp"] * Fl, (m.coords["tp"] + 1) * Fl)
        y = tl.moe_mlp_mesh(torch.from_numpy(np.ascontiguousarray(m.block(x))), w["wr"],
                            w["wg"][e, :, t], w["wu"][e, :, t], w["wd"][e, t],
                            jc.num_experts_per_tok, jc.moe_capacity_factor, m)
        return m.gather_blocks(m.expert.all_reduce(y))

    for got in run_local_mesh(MESHES[name], rank, "cpu"):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_a_per_rank_capacity_differs_from_jax():
    """The canary: moe_mlp on each dp x sp block alone takes the capacity
    over that block's tokens and keeps other pairs than JAX, beyond the
    tolerance the mesh form meets."""
    jc, lw, x, want = _moe_layer()
    w = [torch.from_numpy(lw[k]) for k in ("wr", "wg", "wu", "wd")]
    got = np.empty_like(want)
    for b in range(0, 4, 2):
        for s in range(0, 32, 16):
            got[b:b + 2, s:s + 16] = tl.moe_mlp(
                torch.from_numpy(np.ascontiguousarray(x[b:b + 2, s:s + 16])), *w,
                jc.num_experts_per_tok, jc.moe_capacity_factor).numpy()
    assert not np.allclose(got, want, **TOL)
    bad = ~np.isclose(got, want, **TOL).all(-1)
    assert bad.sum() >= 8, bad.sum()  # tokens whose output changed
