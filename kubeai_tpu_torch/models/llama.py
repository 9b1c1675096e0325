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
layers) and Mixtral (:func:`moe_mlp`).

Tensor parallelism (``apply(..., tp_group=)``, a parallel/group.py
TPGroup): *params* are this rank's shard (parallel/sharding.py) and the
pool holds this rank's KV heads. The embedding looks up this rank's
vocab range (zeros elsewhere) and all-reduces; each layer all-reduces
after ``wo`` and after ``wd`` (or the expert mix); the head gives this
rank's vocab slice of the logits and an all-gather rebuilds them (a tied
head reads the sharded embedding). A LoRA bank stays whole on every rank:
a column target uses its columns of B, a row target its rows of A, whose
partial delta joins the partial sum before the all-reduce.

Training over a mesh (``apply(..., mesh=)``, a parallel/mesh.py Mesh,
with ``ring=True`` for ring attention; the cache-less path only): *params* are this
rank's fsdp x tp block (parallel/sharding.py), tokens and positions its
[B/dp, S/sp] block with global positions. Each layer's dp-split weights
are all-gathered just before use and their gradients reduce-scattered
back (group.py ``fsdp_gather``); tp runs Megatron's autograd pair
(``copy_to_group`` before each column-parallel product,
``reduce_from_group`` after each row-parallel one, the logits' vocab
gather); attention is ring attention over the sp group
(parallel/ring_attention.py) or, on the dense arm, this rank's queries
against every rank's keys and values, all-gathered over sp. A MoE layer
(:func:`moe_mlp_mesh`) routes over the global tokens and runs this
rank's experts (split over ep) on its own tokens; its input takes
Megatron's pair over the (ep, tp) group instead of tp.

Batched multi-LoRA (``apply(..., lora=, lora_rows=)``): a bank from
:func:`init_lora_bank` holds every adapter's A and B per target, and each
batch row picks its adapter by index (row 0: none). Each target's delta
is added after its projection (after Qwen2's bias), as in the JAX
package; Mixtral's experts take none. A bank of another dtype than the
model's (the fine-tune's float32 bank over a bf16 base) computes at the
promoted dtype and adds its delta cast to the model's, as the JAX
package's _lora_delta; under autograd the delta is built without
``out=`` (train/finetune.py differentiates through it).
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
from kubeai_tpu_torch.parallel.group import (
    all_gather_grad,
    copy_to_group,
    fsdp_gather,
    gather_last_grad,
    reduce_from_group,
)
from kubeai_tpu_torch.parallel.ring_attention import ring_attention
from kubeai_tpu_torch.parallel.sharding import llama_fsdp_rules, shard_lora_bank

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
    keep=None,
) -> Params:
    """Random-normal parameters drawn from *generator* (tests, benches).
    Scales follow the JAX package: 1/sqrt(fan_in) for projections, the
    router and the experts, 0.02 for embed and lm_head, ones for norms.
    q/k/v biases (zeros in the JAX package) are drawn at 0.02, so a
    random-weight run exercises them. Drawn one layer at a time, so the
    float32 temporaries stay one layer wide. *keep*, when given, maps
    each group as soon as it is drawn, ``keep(key_path, tensor)`` with
    key_path ("embed",) or ("layers", "wq") ..., and the tree holds what
    it returns (a tp rank's slice, an int8 leaf): the draws, and so the
    values, are the same whatever it keeps."""
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

    if keep is None:
        def keep(_path, t):
            return t

    layers: Params = {}

    def put(key, t):
        layers[key] = keep(("layers", key), t)  # as soon as drawn: one group at a time

    put("ln1", ones(L, D))
    put("ln2", ones(L, D))
    put("wq", w(L, D, H * h))
    put("wk", w(L, D, Kv * h))
    put("wv", w(L, D, Kv * h))
    put("wo", w(L, H * h, D))
    if config.qkv_bias:
        put("bq", w(L, H * h, scale=0.02))
        put("bk", w(L, Kv * h, scale=0.02))
        put("bv", w(L, Kv * h, scale=0.02))
    if config.post_norms:
        put("ln1b", ones(L, D))
        put("ln2b", ones(L, D))
    if E > 0:
        put("wr", w(L, D, E))
        put("wg", w(L, E, D, Fi))
        put("wu", w(L, E, D, Fi))
        put("wd", w(L, E, Fi, D))
    else:
        put("wg", w(L, D, Fi))
        put("wu", w(L, D, Fi))
        put("wd", w(L, Fi, D))
    params: Params = {
        "embed": keep(("embed",), w(V, D, scale=0.02, stacked=False)),
        "final_norm": keep(("final_norm",), ones(D)),
        "layers": layers,
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = keep(("lm_head",), w(D, V, scale=0.02, stacked=False))
    return params


def init_paged_cache(config: ModelConfig, num_pages: int, page_size: int,
                     device: torch.device | str, dtype: torch.dtype | None = None,
                     tp: int = 1) -> Params:
    """Paged KV pool: one flat tensor [L*P, page, 2*Kv, h], K at even and V
    at odd head indices (the kernels' native layout). Layer l owns rows
    [l*P, (l+1)*P); logical page 0 of every layer is its trash page.

    config.kv_cache_dtype "fp8" / "int8" stores the pool in one byte per
    element (:func:`kv_pool_dtype`): ``apply`` quantizes on write and the
    attention paths dequantize on read (inside the paged kernels).
    Under tensor parallelism (*tp* ranks) each rank's pool holds its
    num_kv_heads / tp KV heads of every page."""
    check_supported(config)
    dtype = dtype or kv_pool_dtype(config)
    shape = (config.num_layers * num_pages, page_size, 2 * (config.num_kv_heads // tp),
             config.head_dim_)
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
# LoRA bank

LORA_TARGETS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def lora_dims(config: ModelConfig) -> dict[str, tuple[int, int]]:
    """(in, out) features of each LoRA target."""
    D, Fi = config.hidden_size, config.intermediate_size
    H, Kv, h = config.num_heads, config.num_kv_heads, config.head_dim_
    return {"wq": (D, H * h), "wk": (D, Kv * h), "wv": (D, Kv * h), "wo": (H * h, D),
            "wg": (D, Fi), "wu": (D, Fi), "wd": (Fi, D)}


def init_lora_bank(config: ModelConfig, n_adapters: int, rank: int,
                   dtype: torch.dtype | None = None,
                   device: torch.device | str = "cpu") -> Params:
    """Zeroed stacked adapter bank (the JAX package's init_lora_bank): per
    target, A [L, N, in, r] and B [L, N, r, out], and ``scale`` [N]
    float32. *n_adapters* is the TOTAL row count INCLUDING row 0, the
    identity (all-zero) adapter of requests without one. Installing an
    adapter writes its rows in place (engine/lora.py), so a captured CUDA
    graph that reads the bank sees every later load."""
    dtype = dtype or torch_dtype(config.dtype)
    L = config.num_layers
    bank: Params = {"scale": torch.zeros((n_adapters,), dtype=torch.float32, device=device)}
    for t, (din, dout) in lora_dims(config).items():
        bank[t + "_A"] = torch.zeros((L, n_adapters, din, rank), dtype=dtype, device=device)
        bank[t + "_B"] = torch.zeros((L, n_adapters, rank, dout), dtype=dtype, device=device)
    return bank


def _lora_delta(x, A_l, B_l, rows, scale):
    """Per-row LoRA delta (the JAX package's _lora_delta): x [B, S, din],
    A_l [N, din, r], B_l [N, r, dout], rows [B] adapter indices, scale [N]
    -> [B, S, dout] in x's dtype, computed at the promoted precision of x
    and the bank."""
    cdt = torch.promote_types(x.dtype, A_l.dtype)
    return _lora_add(None, x, A_l, B_l, lora_weights(rows, scale, cdt)).to(x.dtype)


def lora_weights(rows, scale, dtype) -> torch.Tensor:
    """[B, N] in *dtype*: row b's adapter scale in column rows[b], zeros
    elsewhere (what :func:`_lora_add` mixes the bank's rows with)."""
    N = scale.shape[0]
    pick = rows.reshape(-1, 1) == torch.arange(N, device=rows.device)[None, :]
    return pick.to(dtype) * scale.to(dtype)


def _lora_add(out, x, A_l, B_l, weights):
    """*out* [B, S, dout] plus each batch row's LoRA delta of x [B, S, din]
    (*out* None: the delta alone), in the dtype of *weights* [B, N] from
    :func:`lora_weights`, which *out* must have.

    The JAX package gathers each batch row's A and B, a copy of B rows of
    the bank per layer. Here x goes through every row's A in one batched
    product (N small [B*S, r] outputs), each batch row keeps its own
    (scaled) and zeroes the others, and one product over the rows' B
    stacked as [N*r, dout] (a view) adds the delta to *out*: the bank is
    read once per call and never copied, in four kernels (addmm first
    copies *out* into its result). The scale
    multiplies the rank-r product before B (the JAX package scales after
    it; the same up to rounding)."""
    cdt = weights.dtype
    Bn, S, din = x.shape
    N, _, r = A_l.shape
    low = torch.matmul(x.reshape(1, Bn * S, din).to(cdt), A_l.to(cdt))  # [N, B*S, r]
    low = low.reshape(N, Bn, S, r).permute(1, 2, 0, 3)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (out, x, A_l, B_l, weights)):
        # Autograd takes no out= argument: the same product, allocated by
        # the multiply (training; a served step runs under no_grad).
        picked = low * weights[:, None, :, None]
    else:
        picked = torch.empty((Bn, S, N, r), dtype=cdt, device=x.device)
        torch.mul(low, weights[:, None, :, None], out=picked)
    picked = picked.reshape(Bn * S, N * r)
    B_flat = B_l.to(cdt).reshape(N * r, -1)
    if out is None:
        return (picked @ B_flat).reshape(Bn, S, -1)
    return torch.addmm(out.reshape(Bn * S, -1), picked, B_flat).reshape(out.shape)


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


def moe_capacity(T: int, E: int, k: int, capacity_factor: float) -> int:
    """Each expert's capacity for T tokens: C = ceil(k*T/E * factor), at
    least 1 (the JAX package's)."""
    return max(int(np.ceil(k * T / E * capacity_factor)), 1)


def moe_slots(expert, E: int, valid=None):
    """Each pair's place in its expert's queue, pairs in order: expert
    [N] (the (token, choice) pairs, token-major) -> [N]; with *valid* [N]
    bool, only the valid pairs take places."""
    onehot = F.one_hot(expert, E)
    if valid is not None:
        onehot = onehot * valid[:, None]
    return (torch.cumsum(onehot, dim=0) - onehot).gather(1, expert[:, None])[:, 0]


def _moe_experts(xt, expert, slot, keep, weights, C: int, wg, wu, wd):
    """Σ over each token's kept pairs of its weight times the pair's
    expert FFN of the token: [T, D] float32. xt [T, D]; expert, slot,
    keep [T*k] per pair (token-major); weights [T, k]; wg/wu [E, D, F],
    wd [E, F, D]. A kept pair runs as row slot of its expert's [C, D]
    batch (kept pairs have distinct (expert, slot) rows); dropped ones go
    to one spare row past the E*C real ones and contribute zero. The JAX
    package dispatches and combines with one-hot einsums, each output a
    sum of exactly one term; index scatters and gathers move the same
    values, and the expert products are batched matmuls over [E, C, D]
    (as in the JAX package, outside any kernel)."""
    T, D = xt.shape
    E = wg.shape[0]
    n = expert.numel()
    row = torch.where(keep, expert * C + slot, E * C)
    src = torch.arange(n, device=xt.device) // (n // T)  # the token of each pair
    xe = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    xe[row] = xt[src]
    xe = xe[: E * C].reshape(E, C, D)
    hid = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(hid, wd).reshape(E * C, D)  # [E*C, D]

    w_flat = torch.where(keep, weights.reshape(n), 0.0)
    picked = ye[torch.clamp(row, max=E * C - 1)].float()
    y = torch.where(keep[:, None], picked, 0.0) * w_flat[:, None]
    return y.reshape(T, n // T, D).sum(dim=1)


def moe_mlp(x, wr, wg, wu, wd, num_experts_per_tok: int, capacity_factor: float = 2.0,
            routes: list | None = None):
    """Mixtral's sparse MoE FFN with the JAX package's GShard
    static-capacity dispatch (kubeai_tpu/models/llama.py::moe_mlp).

    x [B, S, D]; wr [D, E]; wg/wu [E, D, F]; wd [E, F, D]. Top-k routing
    (:func:`moe_route`) with softmax-over-top-k weights; the (token, choice)
    pairs, token-major, fill each expert's capacity C = ceil(k*T/E *
    factor) in order, and pairs past it are dropped (contribute zero).
    *routes*, if given, gets (top-k ids [B, S, k], keep [B, S, k])."""
    B, S, D = x.shape
    E = wr.shape[-1]
    k = num_experts_per_tok
    T = B * S
    C = moe_capacity(T, E, k, capacity_factor)

    xt = x.reshape(T, D)
    router, top_idx = moe_route(xt, wr, k)
    weights = torch.softmax(router.gather(1, top_idx), dim=-1)  # over the chosen experts
    expert = top_idx.reshape(T * k)
    pos = moe_slots(expert, E)
    keep = pos < C
    if routes is not None:
        routes.append((top_idx.reshape(B, S, k), keep.reshape(B, S, k)))
    y = _moe_experts(xt, expert, pos, keep, weights, C, wg, wu, wd)
    return y.reshape(B, S, D).to(x.dtype)


def moe_mlp_mesh(x, wr, wg, wu, wd, num_experts_per_tok: int, capacity_factor: float,
                 mesh, routes: list | None = None):
    """:func:`moe_mlp` on a parallel/mesh.py Mesh rank: this rank's
    partial output [B/dp, S/sp, D], which the caller sums over
    ``mesh.expert`` (ep x tp).

    x is this rank's P("dp", "sp") block of the global [B, S, D] (the same
    on every ep and tp rank of the block); wr [D, E] whole; wg/wu [E/ep,
    D, F/tp] and wd [E/ep, F/tp, D], this rank's experts' tp part. As in
    the JAX package, the capacity C is taken over the global T = B*S and
    filled in global token order: each rank routes its own tokens, the
    top-k ids are all-gathered over ``mesh.data`` into the global [B, S,
    k] (``Mesh.gather_blocks``: placed by (dp, sp), since a rank's tokens
    are not a contiguous run of b*S + s once sp > 1), every rank computes
    every pair's place from them, and keeps its own tokens' pairs that
    fall to its experts and inside C. Its capacity buffer holds only
    those (row order does not change a row's value; sizing it reads their
    count on the host). The softmax weights are over all k choices on
    every rank, so the router's gradient is a partial sum over ep x tp,
    as the products' are. *routes*, if given, gets the global (top-k ids,
    keep) [B, S, k], the same on every rank."""
    Bl, Sl, D = x.shape
    E, k = wr.shape[-1], num_experts_per_tok
    El = wg.shape[0]  # this rank's experts: El*e .. El*(e+1)-1 on ep rank e
    Tl = Bl * Sl

    xt = x.reshape(Tl, D)
    router, top_idx = moe_route(xt, wr, k)
    weights = torch.softmax(router.gather(1, top_idx), dim=-1)
    with torch.no_grad():
        ids = mesh.gather_blocks(top_idx.reshape(Bl, Sl, k))  # [B, S, k]
        B, S = ids.shape[:2]
        pos = moe_slots(ids.reshape(B * S * k), E)
        keep = (pos < moe_capacity(B * S, E, k, capacity_factor)).reshape(B, S, k)
        if routes is not None:
            routes.append((ids, keep))
        local = top_idx.reshape(Tl * k) - mesh.coords["ep"] * El
        mine = mesh.block(keep).reshape(Tl * k) & (local >= 0) & (local < El)
        local = torch.where(mine, local, 0)
        slot = moe_slots(local, El, mine)
        C = max(int(torch.bincount(local[mine], minlength=El).max()), 1)
    y = _moe_experts(xt, local, slot, mine, weights, C, wg, wu, wd)
    return y.reshape(Bl, Sl, D).to(x.dtype)


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
    lora: Params | None = None,  # adapter bank from init_lora_bank
    lora_rows: torch.Tensor | None = None,  # [B] adapter row per batch row
    return_hidden: bool = False,  # final-norm hidden states instead of logits
    tp_group=None,  # parallel/group.py TPGroup: params and pool are this rank's shard
    mesh=None,  # parallel/mesh.py Mesh: the training forward over a mesh
    ring: bool = False,  # on the mesh: ring attention over sp (else the dense arm)
    routes: list | None = None,  # MoE: each layer appends its (top-k ids, keep)
):
    """Run the decoder. Returns (logits [B, S or 1, V] float32, cache), or
    with *return_hidden* (hidden [B, S, D] float32, cache): the final-norm
    states, as the embeddings read them.

    With the paged pool and *page_table*: position p of row b lives in
    pool page page_table[b, p // page] at offset p % page; writes past the
    table's span go to the trash page; attention either runs a paged
    kernel in place or gathers the rows' pages into a contiguous view.
    Without a cache: attention is causal over the S new tokens only.

    With *mesh* (the training path over a mesh, no cache):
    *params* are this rank's block and tokens / positions its [B/dp, S/sp]
    block (global positions); the logits are this rank's rows over the
    whole vocab (see the module docstring).

    *routes*, a list: each MoE layer appends its (top-k expert ids, keep)
    [B, S, k] of the global batch (:func:`moe_mlp`)."""
    check_supported(config)
    if lora is not None and lora_rows is None:
        raise ValueError("lora needs lora_rows (one adapter row per batch row)")
    if ring:
        # The JAX package's asserts: ring attention derives its mask from
        # the blocks' positions and has no window or softcap arm.
        if cache is not None:
            raise ValueError("ring attention is the cache-less (training) path")
        if config.sliding_window != 0 or config.attn_softcap != 0.0:
            raise ValueError("ring attention does not support sliding windows or softcap")
        if mesh is None:
            raise ValueError("ring attention runs over a mesh (mesh=)")
    if mesh is not None:
        if cache is not None or tp_group is not None:
            raise ValueError("the mesh forward is the cache-less (training) path; "
                             "serving takes tp_group")
        tp_group = mesh.tp
    if cache is not None and page_table is None:
        raise NotImplementedError(
            "the dense slot cache is not ported; pass a paged pool and page_table"
        )
    B, S = tokens.shape
    tp = tp_group.world_size if tp_group is not None else 1
    # This rank's heads (all of them at tp = 1).
    H, Kv = config.num_heads // tp, config.num_kv_heads // tp
    h, L = config.head_dim_, config.num_layers
    dtype = torch_dtype(config.dtype)
    dev = tokens.device
    inv_freq = _inv_freq(h, config.rope_theta, config.rope_scaling, dev)
    positions = positions.to(torch.int64)

    def reduce(t):
        """The sum of the ranks' partial *t* (row-parallel outputs)."""
        if mesh is not None:
            return reduce_from_group(t, tp_group)
        return tp_group.all_reduce(t) if tp > 1 else t

    def enter(t):
        """The input of a column-parallel product (its gradient is summed
        over tp on the mesh; serving needs nothing)."""
        return copy_to_group(t, tp_group) if mesh is not None else t

    fsdp = llama_fsdp_rules(config) if mesh is not None else None
    embed = params["embed"]
    if fsdp is not None:
        embed = all_gather_grad(embed, mesh.dp, fsdp["embed"])
        if config.tie_word_embeddings:  # the head reads it too
            params = dict(params, embed=embed)
    if tp > 1:
        # This rank's vocab range [rank*Vl, (rank+1)*Vl): a masked lookup
        # (ids clamped as the gather clamps them at tp = 1), zeros for the
        # other ranks' ids, summed over the ranks.
        Vl = config.vocab_size // tp
        local = torch.clamp(tokens, 0, config.vocab_size - 1) - tp_group.rank * Vl
        mine = (local >= 0) & (local < Vl)
        x = qgather(embed, torch.where(mine, local, 0), dtype)
        x = reduce(x * mine[..., None].to(dtype))
        if lora is not None:
            lora = shard_lora_bank(lora, tp_group.rank, tp)
    else:
        x = qgather(embed, tokens, dtype)
    del embed  # the gathered table of an untied head is done with
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
    elif mesh is not None and mesh.shape["sp"] > 1 and not ring:
        # The dense arm: this rank's queries against every rank's keys.
        key_positions = mesh.sp.all_gather_dim(positions, 1)[:, None, :]
    else:
        key_positions = positions[:, None, :]
    mask = key_positions <= positions[:, :, None]  # [B, S, Skv]
    if windowed:
        # Gemma2's interleave: the window on every layer, or on the even
        # ones ("even"), the global causal mask elsewhere.
        window_mask = mask & (key_positions > positions[:, :, None] - config.sliding_window)

    if lora is not None:
        # The delta computes at the promoted precision of the model and the
        # bank; a bank of the model's dtype adds it inside one addmm, any
        # other (a float32 bank being trained over a bf16 base) casts it
        # to the model's dtype first, where the JAX package's _lora_delta
        # casts.
        lora_dtype = torch.promote_types(dtype, lora["wq_A"].dtype)
        lora_w = lora_weights(lora_rows.long(), lora["scale"], lora_dtype)

    for li in range(L):
        w = {k: _layer_slice(v, li) for k, v in params["layers"].items()}
        if fsdp is not None:
            split = [k for k in w if fsdp["layers"][k] is not None]
            x, full = fsdp_gather(x, [w[k] for k in split],
                                  [fsdp["layers"][k] - 1 for k in split], mesh.dp)
            w.update(zip(split, full))

        def delta(out, inp, name):
            """*out* (the projection of *inp*) plus its LoRA delta."""
            if lora is None:
                return out
            A_l, B_l = lora[name + "_A"][li], lora[name + "_B"][li]
            if lora_dtype == dtype:
                return _lora_add(out, inp, A_l, B_l, lora_w)
            return out + _lora_add(None, inp, A_l, B_l, lora_w).to(dtype)

        layer_mask = mask
        if windowed and (config.sliding_layers != "even" or li % 2 == 0):
            layer_mask = window_mask
        attn_in = enter(norm(x, w["ln1"]))
        q, k, v = qdot_many(attn_in, (w["wq"], w["wk"], w["wv"]))
        if config.qkv_bias:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q, k, v = delta(q, attn_in, "wq"), delta(k, attn_in, "wk"), delta(v, attn_in, "wv")
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
        elif ring:
            attn_out = ring_attention(q, k, v, mesh.sp, scale=config.query_scale)
        else:
            if mesh is not None:
                # Every rank's K and V (one gather, one reduce-scatter of
                # their gradient), at the global positions of the mask.
                kv = all_gather_grad(torch.stack([k, v]), mesh.sp, 2)
                k, v = kv[0], kv[1]
            attn_out = attention(q, k, v, layer_mask, scale=config.query_scale,
                                 softcap=config.attn_softcap)
        attn_flat = attn_out.reshape(B, S, H * h)
        o = reduce(delta(qdot(attn_flat, w["wo"]), attn_flat, "wo"))
        if config.post_norms:
            o = norm(o, w["ln1b"])
        x = x + o

        if config.num_experts > 0 and mesh is not None:
            # The experts' partial outputs are summed over ep and tp in
            # one collective, and so is their input's gradient.
            mlp_in = copy_to_group(norm(x, w["ln2"]), mesh.expert)
            m = reduce_from_group(
                moe_mlp_mesh(mlp_in, w["wr"], w["wg"], w["wu"], w["wd"],
                             config.num_experts_per_tok, config.moe_capacity_factor, mesh,
                             routes), mesh.expert)
        elif config.num_experts > 0:
            m = reduce(moe_mlp(norm(x, w["ln2"]), w["wr"], w["wg"], w["wu"], w["wd"],
                               config.num_experts_per_tok, config.moe_capacity_factor,
                               routes))
        else:
            mlp_in = enter(norm(x, w["ln2"]))
            gate, up = qdot_many(mlp_in, (w["wg"], w["wu"]))
            hid = act(delta(gate, mlp_in, "wg")) * delta(up, mlp_in, "wu")
            m = reduce(delta(qdot(hid, w["wd"]), hid, "wd"))
        if config.post_norms:
            m = norm(m, w["ln2b"])
        x = x + m

    if fsdp is not None and not config.tie_word_embeddings:
        x, (lm_head,) = fsdp_gather(x, [params["lm_head"]], [fsdp["lm_head"]], mesh.dp)
        params = dict(params, lm_head=lm_head)
    x = norm(x, params["final_norm"])
    if return_hidden:
        return x.float(), cache
    x = enter(x)
    if logits_idx is not None:
        x = x[torch.arange(B, device=dev)[:, None], logits_idx.long()[:, None]]  # [B, 1, D]
    if config.tie_word_embeddings:
        logits = qmatT(x, params["embed"])
    else:
        logits = qdot(x, params["lm_head"])
    logits = logits.float()
    if mesh is not None:
        logits = gather_last_grad(logits, tp_group)
    elif tp > 1:
        logits = tp_group.all_gather_last(logits)  # this rank's vocab slice -> all of it
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


def prefill_paged_cold(params, config, tokens, pool, page_table, lengths, lora=None,
                       lora_rows=None, tp_group=None):
    """Whole-prompt paged prefill (positions arange(S)); eligible for the
    flash kernel. Returns (logits [B, 1, V] at lengths-1, pool)."""
    B, S = tokens.shape
    pos = _arange(S, tokens.device)[None, :].expand(B, S)
    return apply(
        params, config, tokens, pos, pool,
        logits_idx=lengths.reshape(-1).long() - 1,
        page_table=page_table, left_aligned=True, lora=lora, lora_rows=lora_rows,
        tp_group=tp_group,
    )


def prefill_paged(params, config, tokens, pool, page_table, start, last_idx, lora=None,
                  lora_rows=None, tp_group=None):
    """Prefill [B, S] chunks at absolute offsets *start* [B] (chunked
    continuation or a shared-prefix resume). Returns (logits [B, 1, V] at
    *last_idx* [B] within the chunk, pool)."""
    S = tokens.shape[1]
    pos = start.reshape(-1, 1).long() + _arange(S, tokens.device)[None, :]
    return apply(
        params, config, tokens, pos, pool,
        logits_idx=last_idx.reshape(-1).long(), page_table=page_table,
        lora=lora, lora_rows=lora_rows, tp_group=tp_group,
    )


def decode_step_paged(params, config, tokens, pool, page_table, lengths, decode_kernel="ragged",
                      lora=None, lora_rows=None, tp_group=None):
    """One paged decode step for [B, 1] tokens at positions *lengths* [B].
    Returns (logits [B, 1, V], pool)."""
    return apply(
        params, config, tokens, lengths.reshape(-1, 1).long(), pool,
        page_table=page_table, decode_kernel=decode_kernel, lora=lora, lora_rows=lora_rows,
        tp_group=tp_group,
    )


def decode_speculative_paged(params, config, tokens, pool, page_table, lengths,
                             decode_kernel="ragged", lora=None, lora_rows=None, tp_group=None):
    """[B, S] candidate tokens (next token + S-1 drafts) at positions
    lengths .. lengths+S-1; returns logits for all S positions
    ([B, S, V]) and the pool."""
    S = tokens.shape[1]
    pos = lengths.reshape(-1, 1).long() + _arange(S, tokens.device)[None, :]
    return apply(
        params, config, tokens, pos, pool,
        page_table=page_table, decode_kernel=decode_kernel, lora=lora, lora_rows=lora_rows,
        tp_group=tp_group,
    )
