"""Parameter conversion from the JAX package's tree.

``params_from_jax`` takes the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
tensors with the same keys, the same [in, out] weight layout and the same
stacked [L, ...] layer axis. The port imports neither jax nor ml_dtypes:
bfloat16 leaves arrive as ml_dtypes arrays and move through a uint16 view.
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

    def conv(node, path):
        if isinstance(node, dict):
            if "int8_q" in node:
                raise NotImplementedError(
                    f"int8 weight {path} is not ported yet (ROADMAP queue 2: W8A16 qdot kernel)"
                )
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        return _leaf(node, device)

    return conv(tree, "")
