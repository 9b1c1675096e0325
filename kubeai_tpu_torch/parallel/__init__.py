"""Parallelism, the port of kubeai_tpu/parallel: process groups and their
collectives (group.py), the (dp, sp, ep, tp) mesh (mesh.py), the split
rules (sharding.py) and ring attention (ring_attention.py)."""

from kubeai_tpu_torch.parallel.group import TPGroup, choose_backend, init_tp_group
from kubeai_tpu_torch.parallel.mesh import Mesh, make_mesh, run_local_mesh
from kubeai_tpu_torch.parallel.sharding import (
    check_divisible,
    gather_params,
    llama_ep_rules,
    llama_fsdp_rules,
    llama_split_rules,
    shard_mesh_params,
    shard_params,
)

__all__ = ["TPGroup", "choose_backend", "init_tp_group", "Mesh", "make_mesh",
           "run_local_mesh", "check_divisible", "gather_params",
           "llama_ep_rules", "llama_fsdp_rules", "llama_split_rules", "shard_mesh_params",
           "shard_params"]
