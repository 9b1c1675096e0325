"""Llama-family decoder in PyTorch (port of kubeai_tpu/models/llama.py).

Parameters are a plain dict of tensors with the JAX package's layout:
every layer weight stacked on a leading L axis and stored [in, out], so
products stay ``x @ W`` and ``params_from_jax`` converts leaf by leaf.
The forward loops over layers in Python (the JAX package scans).

The paged KV pool is ONE flat tensor [L*P, page, 2*Kv, h] with K at even
and V at odd head indices; layer l owns rows l*P .. (l+1)*P-1 and page 0
of each layer is its trash page. The JAX package donated the pool through
every jitted step; here ``apply`` writes it IN PLACE and returns the same
dict. Attention takes one of three hand-written CUDA kernels behind the
same gates as the JAX package (``use_flash_prefill``, ``use_paged_kernel``,
``decode_kernel``) or the plain gather path; matrix products outside
attention are ``torch.matmul``.

Only dense Llama is ported. The variants the JAX package also serves
raise NotImplementedError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.ops.attention import attention
from kubeai_tpu_torch.ops.flash_attention import flash_attention
from kubeai_tpu_torch.ops.norms import rms_norm
from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    paged_decode_attention,
    resolve_decode_kernel,
)
from kubeai_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def check_supported(config: ModelConfig) -> None:
    """Raise for the model variants this slice has not ported."""
    unported = [
        (config.qkv_bias, "qkv bias (Qwen2)", "model variants"),
        (config.num_experts > 0, "MoE", "model variants"),
        (config.hidden_act != "silu" or config.embed_scale or config.rms_one_offset
         or config.post_norms or config.attn_softcap or config.logit_softcap,
         "Gemma features", "model variants"),
        (config.sliding_window > 0, "sliding-window attention", "model variants"),
        (config.kv_cache_dtype not in ("", "auto"), "quantized KV pool",
         "quantized KV pool"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1: {item})"
            )


# ---------------------------------------------------------------------------
# Parameters and KV pool


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> Params:
    """Random-normal parameters drawn from *generator* (tests, benches).
    Scales follow the JAX package: 1/sqrt(fan_in) for projections, 0.02
    for embed and lm_head, ones for norms. Drawn one layer at a time, so
    the float32 temporaries stay one layer wide."""
    check_supported(config)
    device = torch.device(device) if device is not None else generator.device
    dtype = dtype or torch_dtype(config.dtype)
    D, Fi, L = config.hidden_size, config.intermediate_size, config.num_layers
    H, Kv, h = config.num_heads, config.num_kv_heads, config.head_dim_
    V = config.vocab_size

    def w(*shape, scale=None, stacked=True):
        scale = scale or (1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1]))
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(part.shape, generator=generator, device=device) * scale)
        return out

    layers: Params = {
        "ln1": torch.ones((L, D), dtype=dtype, device=device),
        "ln2": torch.ones((L, D), dtype=dtype, device=device),
        "wq": w(L, D, H * h),
        "wk": w(L, D, Kv * h),
        "wv": w(L, D, Kv * h),
        "wo": w(L, H * h, D),
        "wg": w(L, D, Fi),
        "wu": w(L, D, Fi),
        "wd": w(L, Fi, D),
    }
    params: Params = {
        "embed": w(V, D, scale=0.02, stacked=False),
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "layers": layers,
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = w(D, V, scale=0.02, stacked=False)
    return params


def init_paged_cache(config: ModelConfig, num_pages: int, page_size: int,
                     device: torch.device | str, dtype: torch.dtype | None = None) -> Params:
    """Paged KV pool: one flat tensor [L*P, page, 2*Kv, h], K at even and V
    at odd head indices (the kernels' native layout). Layer l owns rows
    [l*P, (l+1)*P); logical page 0 of every layer is its trash page."""
    check_supported(config)
    dtype = dtype or torch_dtype(config.dtype)
    shape = (config.num_layers * num_pages, page_size, 2 * config.num_kv_heads, config.head_dim_)
    return {"kv": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Forward


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, scaling, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(head_dim, theta, scaling)).to(device)


def apply(
    params: Params,
    config: ModelConfig,
    tokens: torch.Tensor,  # [B, S] integer
    positions: torch.Tensor,  # [B, S] absolute positions
    cache: Params | None = None,  # paged pool from init_paged_cache (written in place)
    logits_idx: torch.Tensor | None = None,  # [B] one query index before lm_head
    left_aligned: bool = False,  # caller guarantees positions == arange(S)
    page_table: torch.Tensor | None = None,  # [B, max_pages] int32 pool page per seq page
    decode_kernel: str = "ragged",  # paged kernel: "ragged" | "dedicated" | "auto"
    lora: Params | None = None,
    ring_mesh=None,
):
    """Run the decoder. Returns (logits [B, S or 1, V] float32, cache).

    With the paged pool and *page_table*: position p of row b lives in
    pool page page_table[b, p // page] at offset p % page; writes past the
    table's span go to the trash page; attention either runs a paged
    kernel in place or gathers the rows' pages into a contiguous view.
    Without a cache: attention is causal over the S new tokens only."""
    check_supported(config)
    if lora is not None:
        raise NotImplementedError("LoRA is not ported yet (ROADMAP queue 1: LoRA, MoE and Gemma variants)")
    if ring_mesh is not None:
        raise NotImplementedError("ring attention is not ported yet (ROADMAP queue 1: training)")
    if cache is not None and page_table is None:
        raise NotImplementedError(
            "the dense slot cache is not ported; pass a paged pool and page_table"
        )
    B, S = tokens.shape
    H, Kv, h = config.num_heads, config.num_kv_heads, config.head_dim_
    dtype = torch_dtype(config.dtype)
    dev = tokens.device
    inv_freq = _inv_freq(h, config.rope_theta, config.rope_scaling, dev)
    positions = positions.to(torch.int64)

    x = params["embed"].to(dtype)[tokens.long()]
    use_flash = (
        config.use_flash_prefill
        and left_aligned
        and cache is not None
        and S >= 256
        and S % 256 == 0
    )
    use_paged_kernel = config.use_paged_kernel and page_table is not None and not use_flash
    use_dedicated = use_paged_kernel and resolve_decode_kernel(decode_kernel, S) == "dedicated"

    paged = page_table is not None
    if paged:
        pool = cache["kv"]
        page = pool.shape[1]
        pool_P = pool.shape[0] // config.num_layers
        max_pages = page_table.shape[1]
        skv = max_pages * page
        key_positions = torch.arange(skv, device=dev)[None, None, :]
        # Out-of-span positions (bucket padding past the table, decode
        # overrun after a finish) write to the layer's trash page.
        w_idx = torch.clamp(positions // page, 0, max_pages - 1)
        w_pages = torch.take_along_dim(page_table.long(), w_idx, dim=1)
        w_pages = torch.where(positions < skv, w_pages, 0)
        w_offs = positions % page
        kv_lengths = positions[:, -1] + 1  # keys 0..last position inclusive
    else:
        key_positions = positions[:, None, :]
    mask = key_positions <= positions[:, :, None]  # [B, S, Skv]

    for li in range(config.num_layers):
        w = {k: v[li] for k, v in params["layers"].items()}
        attn_in = rms_norm(x, w["ln1"], config.rms_norm_eps)
        q = (attn_in @ w["wq"]).reshape(B, S, H, h)
        k = (attn_in @ w["wk"]).reshape(B, S, Kv, h)
        v = (attn_in @ w["wv"]).reshape(B, S, Kv, h)
        q, k = apply_rope(q, k, positions, inv_freq)

        if paged:
            interleaved = torch.stack([k, v], dim=3).reshape(B, S, 2 * Kv, h)
            pool.index_put_((w_pages + li * pool_P, w_offs), interleaved.to(pool.dtype))
            table_l = page_table + li * pool_P
            if use_paged_kernel:
                paged_fn = paged_decode_attention if use_dedicated else paged_attention_ragged
                attn_out = paged_fn(
                    q, pool, table_l, kv_lengths, scale=config.query_scale,
                    softcap=config.attn_softcap,
                )
            elif use_flash:
                # Positions are arange(S): the pages just written hold
                # exactly k/v, so plain causal attention over the fresh
                # tensors equals the position mask over the pool.
                attn_out = flash_attention(q, k, v, causal=True, sm_scale=config.query_scale)
            else:
                gathered = pool[table_l.long()]  # [B, mp, page, 2Kv, h]
                k_att = gathered[..., 0::2, :].reshape(B, skv, Kv, h)
                v_att = gathered[..., 1::2, :].reshape(B, skv, Kv, h)
                attn_out = attention(q, k_att, v_att, mask, scale=config.query_scale)
        else:
            attn_out = attention(q, k, v, mask, scale=config.query_scale)
        x = x + attn_out.reshape(B, S, H * h) @ w["wo"]

        mlp_in = rms_norm(x, w["ln2"], config.rms_norm_eps)
        x = x + (F.silu(mlp_in @ w["wg"]) * (mlp_in @ w["wu"])) @ w["wd"]

    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if logits_idx is not None:
        x = x[torch.arange(B, device=dev)[:, None], logits_idx.long()[:, None]]  # [B, 1, D]
    if config.tie_word_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"]
    return logits.float(), cache


def _arange(S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device, dtype=torch.int64)


def prefill_paged_cold(params, config, tokens, pool, page_table, lengths):
    """Whole-prompt paged prefill (positions arange(S)); eligible for the
    flash kernel. Returns (logits [B, 1, V] at lengths-1, pool)."""
    B, S = tokens.shape
    pos = _arange(S, tokens.device)[None, :].expand(B, S)
    return apply(
        params, config, tokens, pos, pool,
        logits_idx=lengths.reshape(-1).long() - 1,
        page_table=page_table, left_aligned=True,
    )


def prefill_paged(params, config, tokens, pool, page_table, start, last_idx):
    """Prefill [B, S] chunks at absolute offsets *start* [B] (chunked
    continuation or a shared-prefix resume). Returns (logits [B, 1, V] at
    *last_idx* [B] within the chunk, pool)."""
    S = tokens.shape[1]
    pos = start.reshape(-1, 1).long() + _arange(S, tokens.device)[None, :]
    return apply(
        params, config, tokens, pos, pool,
        logits_idx=last_idx.reshape(-1).long(), page_table=page_table,
    )


def decode_step_paged(params, config, tokens, pool, page_table, lengths, decode_kernel="ragged"):
    """One paged decode step for [B, 1] tokens at positions *lengths* [B].
    Returns (logits [B, 1, V], pool)."""
    return apply(
        params, config, tokens, lengths.reshape(-1, 1).long(), pool,
        page_table=page_table, decode_kernel=decode_kernel,
    )


def decode_speculative_paged(params, config, tokens, pool, page_table, lengths, decode_kernel="ragged"):
    """[B, S] candidate tokens (next token + S-1 drafts) at positions
    lengths .. lengths+S-1; returns logits for all S positions
    ([B, S, V]) and the pool."""
    S = tokens.shape[1]
    pos = lengths.reshape(-1, 1).long() + _arange(S, tokens.device)[None, :]
    return apply(
        params, config, tokens, pos, pool,
        page_table=page_table, decode_kernel=decode_kernel,
    )
