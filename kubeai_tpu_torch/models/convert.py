"""Parameter conversion from the JAX package's tree.

``params_from_jax`` takes the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
tensors with the same keys, the same [in, out] weight layout and the same
stacked [L, ...] layer axis; an int8 weight ``{"int8_q", "int8_s"}``
(kubeai_tpu/ops/quant.py) becomes the same dict of an int8 and a float32
tensor. The port imports neither jax nor ml_dtypes:
bfloat16 leaves arrive as ml_dtypes arrays and move through a uint16 view.

For training over a mesh, ``params_from_jax`` on the host followed by
parallel/sharding.py's ``shard_mesh_params(params, config, mesh)`` (which
``train/trainer.py::init_sharded_training(..., params=)`` calls) gives
every rank its block of the JAX package's initial parameters: a
``torch.Generator`` cannot draw what ``jax.random.key`` draws.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.models.llama import check_supported


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: dict[str, Any], config: ModelConfig, device) -> dict[str, Any]:
    """The port's parameter dict for a JAX parameter tree of numpy arrays."""
    check_supported(config)

    def conv(node):
        if isinstance(node, dict):  # int8 leaves {"int8_q", "int8_s"} convert key by key
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, device)

    return conv(tree)
