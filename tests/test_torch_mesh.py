"""The port's mesh (kubeai_tpu_torch.parallel.mesh), its autograd
collectives (parallel/group.py) and the fsdp split (parallel/sharding.py)
on the CPU, thread ranks over gloo:

- the rank layout and each axis's group against the JAX package's
  make_mesh device layout on conftest's 8 virtual devices;
- each rank's groups: an all-reduce over each sums its members, thread
  ranks over one in-process store and make_mesh's ranks over a
  TCPStore;
- every autograd collective's forward and gradient against the same
  function computed whole in one process;
- the fsdp, ep and tp dims of every leaf against JAX's
  ``llama_param_specs(fsdp=True)``, and each rank's block against the
  shard JAX's ``shard_tree`` puts on the device of the same index (a
  Mixtral's experts split over ep too); gather_params rebuilds the tree."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.parallel.mesh import make_mesh as jmake_mesh
from kubeai_tpu.parallel.sharding import llama_param_specs, shard_tree
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel import group as G
from kubeai_tpu_torch.parallel.mesh import (
    AXES,
    group_ranks,
    make_mesh,
    mesh_layout,
    mesh_shape,
    run_local_mesh,
)
from kubeai_tpu_torch.parallel.sharding import (
    gather_params,
    key_paths,
    llama_ep_rules,
    llama_fsdp_rules,
    llama_split_rules,
    shard_mesh_params,
)

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

SHAPES = [dict(dp=2, sp=2, tp=2), dict(dp=2, sp=4), dict(sp=2, ep=2, tp=2)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_layout_and_groups_match_jax_make_mesh(cpu_mesh_devices, shape):
    jm = jmake_mesh(**shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    full = {a: shape.get(a, 1) for a in AXES}
    np.testing.assert_array_equal(mesh_layout(full), ids)
    for axis_i, axis in enumerate(AXES):
        for rank in range(ids.size):
            coords = np.argwhere(ids == rank)[0]
            index = tuple(slice(None) if i == axis_i else c for i, c in enumerate(coords))
            assert group_ranks(full, rank, (axis,)) == list(ids[index].reshape(-1))

    def rank(mesh):
        out = {}
        for name, g in [*mesh.groups.items(), ("data", mesh.data), ("expert", mesh.expert)]:
            t = torch.tensor([float(mesh.rank)])
            g.all_reduce(t)
            out[name] = (g.members, g.rank, float(t))
        return mesh.coords, out

    for r, (coords, groups) in enumerate(run_local_mesh(shape, rank, "cpu")):
        assert coords == {a: int(c) for a, c in zip(AXES, np.argwhere(ids == r)[0])}
        for name, (members, me, total) in groups.items():
            axes = {"data": ("dp", "sp"), "expert": ("ep", "tp")}.get(name, (name,))
            assert members == group_ranks(full, r, axes) and members[me] == r
            assert total == sum(members)


def test_make_mesh_meets_over_a_tcp_store():
    """make_mesh, one call per rank as processes would make it (threads
    here), on the CPU: the ranks meet at rank 0's TCPStore and every
    group sums its members."""
    import socket
    import threading

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out: dict = {}

    def rank(r):
        mesh = make_mesh(dp=2, tp=2, rank=r, device="cpu", port=port, timeout=60)
        t = torch.tensor([float(r)])
        mesh.tp.all_reduce(t)
        out[r] = (mesh.backend, mesh.coords, float(t))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert sorted(out) == [0, 1, 2, 3]
    for r, (backend, coords, total) in out.items():
        assert backend == "gloo" and coords == {"dp": r // 2, "sp": 0, "ep": 0, "tp": r % 2}
        assert total == sum(group_ranks(mesh_shape(dp=2, tp=2), r, ("tp",)))


def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# name -> (function of (x, group) on a rank; the same computed whole from
# every rank's x, in rank order, returning rank r's output; how the
# ranks' losses add up). "sum": each rank's loss is its own part of the
# total (data parallel: fsdp's gather, the ring pass). "copy": x is the
# same on every rank and each rank's loss a partial of the total
# (Megatron's f). "replicated": every rank computes the same loss from
# the collective's output, which counts once (Megatron's g, the vocab
# gather).
W = 4


def _cases():
    def gather1(x, g):
        return G.all_gather_grad(x, g, 1)

    def fsdp(x, g):
        ws = [_seeded((3, 2), 100 + g.rank), _seeded((2, 5), 200 + g.rank)]
        out, full = G.fsdp_gather(x, [w.requires_grad_(True) for w in ws], [0, 1], g)
        return out * 2 + full[0].sum() + (full[1] ** 2).sum()

    def fsdp_whole(xs, r):
        ws0 = torch.cat([_seeded((3, 2), 100 + i) for i in range(W)], 0)
        ws1 = torch.cat([_seeded((2, 5), 200 + i) for i in range(W)], 1)
        return xs[r] * 2 + ws0.sum() + (ws1 ** 2).sum()

    return {
        "copy_to_group": (G.copy_to_group, lambda xs, r: xs[r], "copy"),
        "reduce_from_group": (G.reduce_from_group, lambda xs, r: sum(xs), "replicated"),
        "all_gather_grad": (gather1, lambda xs, r: torch.cat(xs, 1), "sum"),
        "gather_last_grad": (G.gather_last_grad, lambda xs, r: torch.cat(xs, -1), "replicated"),
        "ring_shift_grad": (G.ring_shift_grad, lambda xs, r: xs[(r - 1) % W], "sum"),
        "fsdp_gather": (fsdp, fsdp_whole, "sum"),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_autograd_collective_matches_the_whole_function(name):
    """Rank r's loss is sum(f(x_r) * c_r); the gradient each rank gets
    for its x_r must be the gradient of the total loss computed whole
    (see the cases above for how the ranks' losses add up)."""
    fn, whole, kind = _cases()[name]
    xs = [_seeded((2, 3, 4), 0 if kind == "copy" else r) for r in range(W)]
    outs = [whole(xs, r) for r in range(W)]
    cs = [_seeded(o.shape, 50 + (0 if kind == "replicated" else r)) for r, o in enumerate(outs)]

    def rank(group):
        x = xs[group.rank].clone().requires_grad_(True)
        y = fn(x, group)
        (y * cs[group.rank]).sum().backward()
        return y.detach(), x.grad

    got = G.run_local_ranks(W, rank, "cpu")
    if kind == "copy":  # one x, read by every rank
        x = xs[0].clone().requires_grad_(True)
        xw = [x] * W
    else:
        xw = [x.clone().requires_grad_(True) for x in xs]
    terms = range(1) if kind == "replicated" else range(W)
    sum((whole(xw, r) * cs[r]).sum() for r in terms).backward()
    for r, (y, gx) in enumerate(got):
        torch.testing.assert_close(y, outs[r], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(gx, xw[r].grad, rtol=1e-6, atol=1e-6)


VARIANTS = {
    "llama": dict(num_heads=4, num_kv_heads=2),
    "qwen2": dict(num_heads=4, num_kv_heads=2, qkv_bias=True),
    "gemma2": dict(num_heads=4, num_kv_heads=2, post_norms=True, rms_one_offset=True,
                   embed_scale=True, tie_word_embeddings=True, hidden_act="gelu_tanh"),
    "mixtral": dict(num_heads=4, num_kv_heads=2, num_experts=4, num_experts_per_tok=2),
}


def _spec_dims(spec, axis):
    return next((i for i, a in enumerate(spec) if a == axis), None)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fsdp_and_tp_dims_match_llama_param_specs(variant):
    jc = JMC(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
             dtype="float32", **VARIANTS[variant])
    tc = TMC(**dataclasses.asdict(jc))
    specs = dict(key_paths(llama_param_specs(jc, fsdp=True)))
    fsdp, tp = dict(key_paths(llama_fsdp_rules(tc))), dict(key_paths(llama_split_rules(tc)))
    ep = dict(key_paths(llama_ep_rules(tc)))
    assert set(specs) == set(fsdp) == set(tp) == set(ep)
    for path, spec in specs.items():
        assert isinstance(spec, P)
        assert fsdp[path] == _spec_dims(spec, "dp"), path
        assert tp[path] == _spec_dims(spec, "tp"), path
        assert ep[path] == _spec_dims(spec, "ep"), path


@pytest.mark.parametrize("variant,shape", [("llama", dict(dp=2, sp=2, tp=2)),
                                           ("llama", dict(dp=4, tp=2)),
                                           ("mixtral", dict(dp=2, ep=2, tp=2))],
                         ids=["dp2_sp2_tp2", "dp4_tp2", "mixtral_dp2_ep2_tp2"])
def test_rank_blocks_match_jax_shard_tree(cpu_mesh_devices, variant, shape):
    jc = JMC(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
             dtype="float32", **VARIANTS[variant])
    tc = TMC(**dataclasses.asdict(jc))
    jp = jl.init_params(jc, jax.random.key(0))
    sharded = shard_tree(jp, llama_param_specs(jc, fsdp=True), jmake_mesh(**shape))
    full = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")

    def rank(mesh):
        mine = shard_mesh_params(full, tc, mesh)
        return mesh.rank, mine, gather_params(mine, tc, mesh)

    for r, mine, whole in run_local_mesh(shape, rank, "cpu"):
        for path, arr in key_paths(sharded):
            block = next(s.data for s in arr.addressable_shards if s.device.id == r)
            got = dict(key_paths(mine))[path]
            np.testing.assert_array_equal(got.numpy(), np.asarray(block), err_msg=str(path))
            np.testing.assert_array_equal(dict(key_paths(whole))[path].numpy(),
                                          dict(key_paths(full))[path].numpy())
