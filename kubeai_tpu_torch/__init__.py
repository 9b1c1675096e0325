"""kubeai_tpu_torch — the PyTorch/CUDA port of the kubeai_tpu serving engine.

The JAX package ``kubeai_tpu`` is the reference; this package keeps its
module names (``models/llama.py``, ``ops/paged_attention.py``,
``engine/core.py`` ...) so each counterpart is easy to find, and imports
nothing from it. Attention and the int8 weight products run through
hand-written CUDA kernels (``csrc/*.cu``) built at first use; the bf16
weight products are ``torch.matmul``.

Device rule: every entry point runs on ``cuda`` unless the caller asks for
the CPU explicitly (``device="cpu"``, ``--device cpu``). Nothing falls back
to the CPU silently.
"""

from __future__ import annotations

import os


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when *device* is None.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present.
    """
    # torch is imported here, not with the package: the operator's CLIs
    # (incident_report, the manifests) run without it.
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return dev


def env_float(name: str, default: float) -> float:
    """A float knob from the environment; unset, blank or junk values give
    *default* (a mistyped knob never stops a serving process)."""
    try:
        return float(os.environ.get(name, "") or default)
    except (TypeError, ValueError):
        return default
