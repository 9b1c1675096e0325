"""Tensor parallelism: the process group (group.py) and the split rules
(sharding.py); the port of kubeai_tpu/parallel."""

from kubeai_tpu_torch.parallel.group import TPGroup, choose_backend, init_tp_group
from kubeai_tpu_torch.parallel.sharding import (
    check_divisible,
    llama_split_rules,
    shard_params,
)

__all__ = ["TPGroup", "choose_backend", "init_tp_group", "check_divisible",
           "llama_split_rules", "shard_params"]
