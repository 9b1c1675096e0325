"""Plain GQA attention (port of kubeai_tpu/ops/attention.py).

The reference every kernel in this package is held against, and the
portable gather path of ``models/llama.py``. Shapes follow the engine
convention: q [B, Sq, H, h], k/v [B, Sk, Kv, h], G = H // Kv query heads
share one KV head; the grouped einsum never repeats KV at H width.
"""

from __future__ import annotations

import torch

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    scale: float | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA, softmax in float32.

    *mask* is boolean, broadcastable to [B, Sq, Sk]; True = attend.
    *softcap* > 0 applies tanh capping to the logits before the mask."""
    B, Sq, H, h = q.shape
    Kv = k.shape[2]
    G = H // Kv
    if scale is None:
        scale = h**-0.5
    qg = q.reshape(B, Sq, Kv, G, h)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, _NEG_INF)
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskh->bqkgh", weights, v.float())
    return out.reshape(B, Sq, H, h).to(q.dtype)


def causal_mask(sq: int, sk: int, offset: int = 0, device=None) -> torch.Tensor:
    """[sq, sk] boolean causal mask; query i attends to keys <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    return ki <= qi
