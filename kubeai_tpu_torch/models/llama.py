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
``decode_kernel``) or the plain gather path. A pool in fp8 or int8
(``kv_cache_dtype``) is quantized on write with static scales and
dequantized by the kernels (or the gather path) on read. Projections
and the head go through ``ops/quant.py``: ``torch.matmul`` for bf16
weights, the W8A16 kernel for int8 ones (``{"int8_q", "int8_s"}``
leaves, made from the bf16 tree by
``engine/weights.py::quantize_model_params``).

The model families of the JAX package's catalog run through the same
forward: Qwen2 (q/k/v biases), Gemma (gelu with tanh, the embedding
scaled by sqrt(hidden), 1 + w norms, head dim 256), Gemma2 (post norms,
attention and final softcaps, a query scale, a sliding window on even
layers) and Mixtral (:func:`moe_mlp`). LoRA and ring attention raise
NotImplementedError naming their ROADMAP item.
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
from kubeai_tpu_torch.ops.paged_attention import QUANT_POOL_DTYPES, paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    paged_decode_attention,
    resolve_decode_kernel,
)
from kubeai_tpu_torch.ops.quant import qdot, qdot_many, qgather, qmatT
from kubeai_tpu_torch.ops.rope import apply_rope, rope_frequencies

Params = dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def check_supported(config: ModelConfig) -> None:
    """Raise for a configuration the forward does not compute (as the JAX
    package's, whose activation and window flags take these values)."""
    if config.hidden_act not in ("silu", "gelu_tanh"):
        raise ValueError(f"unsupported hidden_act {config.hidden_act!r} (silu or gelu_tanh)")
    if config.sliding_layers not in ("all", "even"):
        raise ValueError(f"unsupported sliding_layers {config.sliding_layers!r} (all or even)")


# ---------------------------------------------------------------------------
# Parameters and KV pool


def init_params(
    config: ModelConfig,
    generator: torch.Generator,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> Params:
    """Random-normal parameters drawn from *generator* (tests, benches).
    Scales follow the JAX package: 1/sqrt(fan_in) for projections, the
    router and the experts, 0.02 for embed and lm_head, ones for norms.
    q/k/v biases (zeros in the JAX package) are drawn at 0.02, so a
    random-weight run exercises them. Drawn one layer at a time, so the
    float32 temporaries stay one layer wide."""
    check_supported(config)
    device = torch.device(device) if device is not None else generator.device
    dtype = dtype or torch_dtype(config.dtype)
    D, Fi, L = config.hidden_size, config.intermediate_size, config.num_layers
    H, Kv, h = config.num_heads, config.num_kv_heads, config.head_dim_
    V, E = config.vocab_size, config.num_experts

    def w(*shape, scale=None, stacked=True):
        scale = scale or (1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1]))
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(part.shape, generator=generator, device=device) * scale)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers: Params = {
        "ln1": ones(L, D),
        "ln2": ones(L, D),
        "wq": w(L, D, H * h),
        "wk": w(L, D, Kv * h),
        "wv": w(L, D, Kv * h),
        "wo": w(L, H * h, D),
    }
    if config.qkv_bias:
        layers["bq"] = w(L, H * h, scale=0.02)
        layers["bk"] = w(L, Kv * h, scale=0.02)
        layers["bv"] = w(L, Kv * h, scale=0.02)
    if config.post_norms:
        layers["ln1b"] = ones(L, D)
        layers["ln2b"] = ones(L, D)
    if E > 0:
        layers["wr"] = w(L, D, E)
        layers["wg"] = w(L, E, D, Fi)
        layers["wu"] = w(L, E, D, Fi)
        layers["wd"] = w(L, E, Fi, D)
    else:
        layers["wg"] = w(L, D, Fi)
        layers["wu"] = w(L, D, Fi)
        layers["wd"] = w(L, Fi, D)
    params: Params = {
        "embed": w(V, D, scale=0.02, stacked=False),
        "final_norm": ones(D),
        "layers": layers,
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = w(D, V, scale=0.02, stacked=False)
    return params


def init_paged_cache(config: ModelConfig, num_pages: int, page_size: int,
                     device: torch.device | str, dtype: torch.dtype | None = None) -> Params:
    """Paged KV pool: one flat tensor [L*P, page, 2*Kv, h], K at even and V
    at odd head indices (the kernels' native layout). Layer l owns rows
    [l*P, (l+1)*P); logical page 0 of every layer is its trash page.

    config.kv_cache_dtype "fp8" / "int8" stores the pool in one byte per
    element (:func:`kv_pool_dtype`): ``apply`` quantizes on write and the
    attention paths dequantize on read (inside the paged kernels)."""
    check_supported(config)
    dtype = dtype or kv_pool_dtype(config)
    shape = (config.num_layers * num_pages, page_size, 2 * config.num_kv_heads, config.head_dim_)
    return {"kv": torch.zeros(shape, dtype=dtype, device=device)}


def kv_pool_dtype(config: ModelConfig) -> torch.dtype:
    """Storage dtype of the paged KV pool (quantization-aware)."""
    if config.kv_cache_dtype == "fp8":
        return torch.float8_e4m3fn
    if config.kv_cache_dtype == "int8":
        return torch.int8
    if config.kv_cache_dtype in ("", "auto"):
        return torch_dtype(config.dtype)
    return torch_dtype(config.kv_cache_dtype)


# ---------------------------------------------------------------------------
# Forward


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, scaling, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(head_dim, theta, scaling)).to(device)


@functools.lru_cache(maxsize=16)
def _kv_scale_vec(k_scale: float, v_scale: float, Kv: int, device: torch.device) -> torch.Tensor:
    """[2*Kv, 1] float32 quantize-on-write divisors, built once per
    (scales, heads, device): a copy from host memory inside a step would
    stop a CUDA graph's capture. K (even) and V (odd) heads interleave, so
    the scales do too. A tensor, not a Python scalar: CUDA divides by a
    scalar through its reciprocal, which is not the JAX package's IEEE
    division."""
    return torch.tensor([k_scale, v_scale] * Kv, dtype=torch.float32, device=device)[:, None]


def moe_route(xt, wr, k: int):
    """(router logits [T, E] float32, the top *k* experts [T, k]) of
    tokens xt [T, D]: a stable descending sort, so ties go to the lower
    expert index, as jax.lax.top_k breaks them (torch.topk on CUDA does
    not promise an order for ties)."""
    router = (xt @ wr).float()
    return router, torch.sort(router, dim=-1, descending=True, stable=True)[1][:, :k]


def moe_mlp(x, wr, wg, wu, wd, num_experts_per_tok: int, capacity_factor: float = 2.0):
    """Mixtral's sparse MoE FFN with the JAX package's GShard
    static-capacity dispatch (kubeai_tpu/models/llama.py::moe_mlp).

    x [B, S, D]; wr [D, E]; wg/wu [E, D, F]; wd [E, F, D]. Top-k routing
    (:func:`moe_route`) with softmax-over-top-k weights; the (token, choice)
    pairs, token-major, fill each expert's capacity C = ceil(k*T/E *
    factor) in order, and pairs past it are dropped (contribute zero).
    The JAX package dispatches and combines with one-hot einsums, each
    output a sum of exactly one term; here index scatters and gathers
    move the same values, and the expert products are batched matmuls
    over [E, C, D] (as in the JAX package, outside any kernel)."""
    B, S, D = x.shape
    E = wr.shape[-1]
    k = num_experts_per_tok
    T = B * S
    C = max(int(np.ceil(k * T / E * capacity_factor)), 1)
    dev = x.device

    xt = x.reshape(T, D)
    router, top_idx = moe_route(xt, wr, k)
    weights = torch.softmax(router.gather(1, top_idx), dim=-1)  # over the chosen experts

    expert = top_idx.reshape(T * k)  # (token, choice), token-major
    onehot = F.one_hot(expert, E)  # [T*k, E]
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, expert[:, None])[:, 0]
    keep = pos < C
    # Kept pairs have distinct (expert, position) rows; dropped ones go
    # to one spare row past the E*C real ones.
    row = torch.where(keep, expert * C + pos, E * C)
    src = torch.arange(T * k, device=dev) // k  # the token of each pair
    xe = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    xe[row] = xt[src]
    xe = xe[: E * C].reshape(E, C, D)
    hid = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(hid, wd).reshape(E * C, D)  # [E*C, D]

    w_flat = torch.where(keep, weights.reshape(T * k), 0.0)
    picked = ye[torch.clamp(row, max=E * C - 1)].float()
    y = torch.where(keep[:, None], picked, 0.0) * w_flat[:, None]
    return y.reshape(T, k, D).sum(dim=1).reshape(B, S, D).to(x.dtype)


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
        raise NotImplementedError("LoRA is not ported yet (ROADMAP queue 1: LoRA)")
    if ring_mesh is not None:
        raise NotImplementedError("ring attention is not ported yet (ROADMAP queue 1: training)")
    if cache is not None and page_table is None:
        raise NotImplementedError(
            "the dense slot cache is not ported; pass a paged pool and page_table"
        )
    B, S = tokens.shape
    H, Kv, h, L = config.num_heads, config.num_kv_heads, config.head_dim_, config.num_layers
    dtype = torch_dtype(config.dtype)
    dev = tokens.device
    inv_freq = _inv_freq(h, config.rope_theta, config.rope_scaling, dev)
    positions = positions.to(torch.int64)

    x = qgather(params["embed"], tokens, dtype)
    if config.embed_scale:
        # Gemma scales the embedding by sqrt(hidden) rounded to the
        # compute dtype (the JAX package's jnp.asarray(..., x.dtype)); a
        # Python float of that rounded value keeps the step capturable.
        x = x * float(torch.tensor(config.hidden_size**0.5, dtype=dtype))
    act = F.silu if config.hidden_act == "silu" else functools.partial(F.gelu, approximate="tanh")
    norm_offset = 1.0 if config.rms_one_offset else 0.0

    def norm(inp, weight):
        return rms_norm(inp, weight, config.rms_norm_eps, offset=norm_offset)

    # The kernel gates are the JAX package's: flash only without a softcap
    # or a window, the paged kernels only without a window. A sliding-window
    # model (Gemma2) therefore gathers its pages and runs plain attention
    # with the per-layer window mask, the JAX package's own XLA path for
    # it, not a fallback (ROADMAP: the window inside the paged kernels).
    windowed = config.sliding_window > 0
    use_flash = (
        config.use_flash_prefill
        and left_aligned
        and cache is not None
        and S >= 256
        and S % 256 == 0
        and config.attn_softcap == 0.0
        and not windowed
    )
    use_paged_kernel = (config.use_paged_kernel and page_table is not None
                        and not windowed and not use_flash)
    use_dedicated = use_paged_kernel and resolve_decode_kernel(decode_kernel, S) == "dedicated"

    paged = page_table is not None
    kv_quant = False
    if paged:
        pool = cache["kv"]
        page = pool.shape[1]
        pool_P = pool.shape[0] // L
        kv_quant = pool.dtype in QUANT_POOL_DTYPES
        if kv_quant:
            # Static per-tensor scales: the config's for int8; fp8 is
            # scale-free (its range covers K/V activations), as in JAX.
            kq_scale, vq_scale = ((float(config.kv_scale_k), float(config.kv_scale_v))
                                  if pool.dtype == torch.int8 else (1.0, 1.0))
            kv_scale_vec = _kv_scale_vec(kq_scale, vq_scale, Kv, dev)
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
    if windowed:
        # Gemma2's interleave: the window on every layer, or on the even
        # ones ("even"), the global causal mask elsewhere.
        window_mask = mask & (key_positions > positions[:, :, None] - config.sliding_window)

    for li in range(L):
        w = {k: _layer_slice(v, li) for k, v in params["layers"].items()}
        layer_mask = mask
        if windowed and (config.sliding_layers != "even" or li % 2 == 0):
            layer_mask = window_mask
        attn_in = norm(x, w["ln1"])
        q, k, v = qdot_many(attn_in, (w["wq"], w["wk"], w["wv"]))
        if config.qkv_bias:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q, k, v = q.reshape(B, S, H, h), k.reshape(B, S, Kv, h), v.reshape(B, S, Kv, h)
        q, k = apply_rope(q, k, positions, inv_freq)

        if paged:
            interleaved = torch.stack([k, v], dim=3).reshape(B, S, 2 * Kv, h)
            if kv_quant:
                y = interleaved.float() / kv_scale_vec
                if pool.dtype == torch.int8:
                    y = torch.clamp(torch.round(y), -127.0, 127.0)
                else:
                    # e4m3fn has no infinity: JAX converts an overflow to
                    # NaN, PyTorch saturates it. Clipping to the finite
                    # range first makes both give +-448.
                    y = torch.clamp(y, -448.0, 448.0)
                interleaved = y
            pool.index_put_((w_pages + li * pool_P, w_offs), interleaved.to(pool.dtype))
            table_l = page_table + li * pool_P
            if use_paged_kernel:
                paged_fn = paged_decode_attention if use_dedicated else paged_attention_ragged
                attn_out = paged_fn(
                    q, pool, table_l, kv_lengths, scale=config.query_scale,
                    softcap=config.attn_softcap,
                    k_scale=kq_scale if kv_quant else None,
                    v_scale=vq_scale if kv_quant else None,
                )
            elif use_flash:
                # Positions are arange(S): the pages just written hold
                # exactly k/v, so plain causal attention over the fresh
                # tensors equals the position mask over the pool (a
                # quantized pool is written here and never read).
                attn_out = flash_attention(q, k, v, causal=True, sm_scale=config.query_scale)
            else:
                gathered = pool[table_l.long()]  # [B, mp, page, 2Kv, h]
                if kv_quant:
                    gathered = (gathered.float() * kv_scale_vec).to(dtype)
                k_att = gathered[..., 0::2, :].reshape(B, skv, Kv, h)
                v_att = gathered[..., 1::2, :].reshape(B, skv, Kv, h)
                attn_out = attention(q, k_att, v_att, layer_mask, scale=config.query_scale,
                                     softcap=config.attn_softcap)
        else:
            attn_out = attention(q, k, v, layer_mask, scale=config.query_scale,
                                 softcap=config.attn_softcap)
        o = qdot(attn_out.reshape(B, S, H * h), w["wo"])
        if config.post_norms:
            o = norm(o, w["ln1b"])
        x = x + o

        mlp_in = norm(x, w["ln2"])
        if config.num_experts > 0:
            m = moe_mlp(mlp_in, w["wr"], w["wg"], w["wu"], w["wd"],
                        config.num_experts_per_tok, config.moe_capacity_factor)
        else:
            gate, up = qdot_many(mlp_in, (w["wg"], w["wu"]))
            m = qdot(act(gate) * up, w["wd"])
        if config.post_norms:
            m = norm(m, w["ln2b"])
        x = x + m

    x = norm(x, params["final_norm"])
    if logits_idx is not None:
        x = x[torch.arange(B, device=dev)[:, None], logits_idx.long()[:, None]]  # [B, 1, D]
    if config.tie_word_embeddings:
        logits = qmatT(x, params["embed"])
    else:
        logits = qdot(x, params["lm_head"])
    logits = logits.float()
    if config.logit_softcap > 0.0:
        logits = config.logit_softcap * torch.tanh(logits / config.logit_softcap)
    return logits, cache


def _layer_slice(leaf, li: int):
    """Layer *li* of a stacked leaf: a view, and for an int8 leaf the
    views of its values and scales (the kernel takes them without a
    copy)."""
    if isinstance(leaf, dict):
        return {k: v[li] for k, v in leaf.items()}
    return leaf[li]


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
