"""Token sampling with per-slot parameters (port of kubeai_tpu/engine/sampling.py).

All slots sample in one batched call: temperature / top-k / top-p are
per-row tensors, greedy is temperature 0, and top-k works in a candidate
space capped at MAX_TOP_K (full-vocab sort when max_top_k <= 0).

Random bits: the JAX package draws Gumbel noise from threefry keys, which
PyTorch cannot reproduce. The port draws it from a counter-based hash of
(request seed, absolute position of the sampled token, candidate rank),
in exact integer arithmetic, so a seeded request gives the same stream
whatever slot it lands in, whatever else is in the batch, and on any
device — the proxy replays seeded requests on that promise. Greedy
decoding matches the JAX package exactly: both argmaxes take the first
maximum.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MAX_TOP_K = 128

_M32 = 0xFFFFFFFF


@dataclass
class SamplingParams:
    """Host-side request sampling options (OpenAI API surface)."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    max_tokens: int = 256
    stop: tuple[str, ...] = ()
    seed: int | None = None
    logprobs: bool = False
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # OpenAI logit_bias: ((token_id, bias), ...), bias in [-100, 100].
    logit_bias: tuple = ()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), with every intermediate
    below 2^49 (no signed overflow on any device)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] float32 Gumbel(0, 1) noise, a pure function of (seed [B],
    position [B], rank 0..n-1)."""
    s = seeds.to(torch.int64)[:, None] & _M32
    p = positions.to(torch.int64)[:, None] & _M32
    r = torch.arange(n, device=seeds.device, dtype=torch.int64)[None, :]
    h = _fmix32(s ^ _mul32(p + 1, 0x9E3779B1))
    h = _fmix32(h ^ _mul32(r + 1, 0x85EBCA77))
    u = (h.to(torch.float64) + 0.5) / 4294967296.0  # in (0, 1)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    hist: torch.Tensor,  # [B, W] token ids (engine token history)
    hist_valid: torch.Tensor,  # [B, W] bool — which history columns count
    presence: torch.Tensor,  # [B] float32
    frequency: torch.Tensor,  # [B] float32
) -> torch.Tensor:
    """OpenAI presence/frequency penalties from the token history: a flat
    subtraction for any token that appeared, plus frequency x count."""
    B, V = logits.shape
    idx = hist.long()
    v = hist_valid.to(torch.float32)
    zeros = torch.zeros((B, V), dtype=torch.float32, device=logits.device)
    occurred = zeros.scatter_reduce(1, idx, v, reduce="amax")
    counts = zeros.scatter_add(1, idx, v)
    return logits - presence[:, None] * occurred - frequency[:, None] * counts


def apply_logit_bias(
    logits: torch.Tensor,  # [B, V] float32
    bias_ids: torch.Tensor,  # [B, K] (pad rows: id 0 / bias 0.0)
    bias_vals: torch.Tensor,  # [B, K] float32
) -> torch.Tensor:
    """OpenAI logit_bias as a per-row scatter-add (padding adds 0.0 at
    token 0). Bias steers choice only; callers report logprobs on the
    raw logits."""
    return logits.scatter_add(1, bias_ids.long(), bias_vals.to(logits.dtype))


def sample(
    logits: torch.Tensor,  # [B, V] float32
    seeds: torch.Tensor,  # [B] request seeds (uint32 values)
    positions: torch.Tensor,  # [B] absolute position of the token being sampled
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]; 0 = disabled
    max_top_k: int = MAX_TOP_K,  # candidate-space cap; <= 0 = full vocab
) -> torch.Tensor:
    """Sample one token per row. Returns [B] int64."""
    B, V = logits.shape
    cap = V if max_top_k <= 0 else min(max_top_k, V)
    vals, idxs = torch.topk(logits, cap, dim=-1)  # sorted descending

    k = torch.where(top_k <= 0, cap, torch.clamp(top_k, max=cap))
    rank = torch.arange(cap, device=logits.device)[None, :]
    vals = torch.where(rank < k[:, None], vals, float("-inf"))

    safe_temp = torch.clamp(temperature, min=1e-6)[:, None]
    probs = torch.softmax(vals / safe_temp, dim=-1)
    cumprobs = torch.cumsum(probs, dim=-1)
    # Keep tokens whose preceding cumulative mass is < top_p (the first
    # token is always kept).
    keep = (cumprobs - probs) < top_p[:, None]
    vals = torch.where(keep, vals, float("-inf"))

    # Gumbel-max over the candidates (what jax.random.categorical does).
    scores = vals / safe_temp + gumbel_noise(seeds, positions, cap)
    sampled = torch.gather(idxs, 1, scores.argmax(dim=-1, keepdim=True))[:, 0]
    greedy = logits.argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
