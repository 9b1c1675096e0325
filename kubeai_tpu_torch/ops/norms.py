"""Normalization ops (port of kubeai_tpu/ops/norms.py).

RMSNorm in float32 whatever the input dtype (HF Llama semantics). A
bandwidth-bound elementwise op; plain PyTorch here.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)
