"""The split-KV decode regime of the ragged paged kernel
(kubeai_tpu_torch/csrc/paged_attention.cu: bf16, S*G < 64 rows per
slot and KV head: decode, and verify steps of up to 15 tokens at G = 4;
64 rows where the pages are off the prefill tile's TMA grid), mirrored in plain PyTorch: the CUDA kernel runs only
on the card (tests/test_torch_gpu.py), but its split choice lives in the
wrapper (``split_kv_plan``, ``split_chunk``) and its arithmetic is the
rescale rule below. The mirror takes the wrapper's own choice, forms one
partial (m, l, acc) per live split over keys [i*chunk, (i+1)*chunk) of
the slot's clamped kv_len, and merges them; it is held against the
port's plain version and the JAX package's ``_cpu_twin`` (with the JAX
wrapper's length clamp) on the same numpy inputs. float32, tolerance
1e-5: the paths differ in summation order only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops.paged_attention import _cpu_twin
from kubeai_tpu_torch.ops.paged_attention import (
    MAX_SPLITS,
    SPLIT_MAX_ROWS,
    paged_attention_plain,
    split_chunk,
    split_kv_plan,
)

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

NEG_INF = -1e30
TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132


def split_kv_mirror(q, kv_pages, page_table, kv_lengths, n_splits, scale, softcap=0.0):
    """[B, S, H, h] output of the kernel's decode regime, in float32."""
    B, S, H, h = q.shape
    page, Kv = kv_pages.shape[1], kv_pages.shape[2] // 2
    G, skv = H // Kv, page_table.shape[1] * page
    gathered = kv_pages[page_table.long()]  # [B, mp, page, 2Kv, h]
    k = gathered[..., 0::2, :].reshape(B, skv, Kv, h)
    v = gathered[..., 1::2, :].reshape(B, skv, Kv, h)
    out = torch.zeros(B, S, H, h)
    for b in range(B):
        kvl = min(int(kv_lengths[b]), skv)
        chunk = split_chunk(kvl, n_splits)
        live = max(1, -(-kvl // chunk))
        for kv in range(Kv):
            rows = q[b, :, kv * G:(kv + 1) * G].reshape(S * G, h) * scale  # row s*G + g
            qpos = kvl - S + torch.arange(S * G) // G
            parts = []
            for i in range(live):
                lo, hi = i * chunk, min((i + 1) * chunk, kvl)
                x = rows @ k[b, lo:hi, kv].T
                if softcap > 0.0:
                    x = softcap * torch.tanh(x / softcap)
                x = torch.where(torch.arange(lo, hi)[None, :] <= qpos[:, None], x, NEG_INF)
                m = x.max(-1).values if hi > lo else torch.full((S * G,), NEG_INF)
                p = torch.where(x > NEG_INF / 2, torch.exp(x - m[:, None]), 0.0)
                parts.append((m, p.sum(-1), p @ v[b, lo:hi, kv]))
            M = torch.stack([m for m, _, _ in parts]).max(0).values
            wts = [torch.exp(m - M) for m, _, _ in parts]
            L = sum(l * w for (_, l, _), w in zip(parts, wts))
            acc = sum(a * w[:, None] for (_, _, a), w in zip(parts, wts))
            out[b, :, kv * G:(kv + 1) * G] = (acc / L.clamp(min=1e-30)[:, None]).reshape(S, G, h)
    return out


# (B, S, H, Kv, page, table width, kv_lens, softcap, n_splits or None for
# the wrapper's own choice on an H100)
CASES = {
    "kv_len_1": (2, 1, 8, 2, 64, 4, [1, 1], 0.0, None),
    "page_edges": (3, 1, 8, 2, 64, 4, [63, 64, 65], 0.0, None),
    "splits_end_mid_page": (1, 1, 8, 2, 64, 8, [300], 0.0, 4),
    "rows_empty_in_last_split": (1, 4, 8, 2, 16, 4, [33], 0.0, 4),
    "more_splits_than_keys": (2, 1, 8, 2, 16, 4, [17, 5], 0.0, 8),
    "softcap_30": (2, 2, 4, 2, 16, 4, [30, 61], 30.0, None),
    "kv_len_past_table": (1, 3, 4, 2, 16, 4, [5000], 0.0, None),
    "main_path_b8_kv512": (8, 1, 32, 8, 64, 8, [512] * 8, 0.0, None),
    "uneven_slots": (4, 1, 32, 8, 64, 32, [1, 300, 777, 2048], 0.0, None),
    # Verify steps of S = G+1 tokens at Llama-3.1-8B's G = 4 (20, 32 and
    # 48 rows: two and four m16 tiles; 64 rows over pages of 4 keys).
    "verify_s5_20_rows": (2, 5, 8, 2, 16, 4, [5, 61], 0.0, None),
    "verify_s8_32_rows_softcap": (2, 8, 8, 2, 64, 8, [100, 300], 30.0, 4),
    "verify_s12_48_rows": (1, 12, 8, 2, 16, 8, [5000], 0.0, None),
    "verify_s16_64_rows_page4": (2, 16, 8, 2, 4, 32, [100, 128], 0.0, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_kv_mirror_matches_plain_and_jax(case):
    B, S, H, Kv, page, mp, lens, softcap, n_splits = CASES[case]
    h = 32
    assert S * (H // Kv) <= SPLIT_MAX_ROWS  # the decode regime
    if n_splits is None:
        n_splits = split_kv_plan(B, Kv, mp, page, H100_SMS)
    assert 1 <= n_splits <= MAX_SPLITS
    rng = np.random.default_rng(7)
    P = 1 + B * mp
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    kv = rng.standard_normal((P, page, 2 * Kv, h)).astype(np.float32)
    table = (rng.permutation(P - 1)[: B * mp] + 1).reshape(B, mp).astype(np.int32)
    kv_lens = np.asarray(lens, np.int32)
    scale = h**-0.5

    got = split_kv_mirror(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(table),
                          torch.from_numpy(kv_lens), n_splits, scale, softcap)
    plain = paged_attention_plain(torch.from_numpy(q), torch.from_numpy(kv),
                                  torch.from_numpy(table), torch.from_numpy(kv_lens), scale, softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    clamped = jnp.minimum(jnp.asarray(kv_lens), mp * page)  # the JAX wrapper's clamp
    twin = _cpu_twin(jnp.asarray(q.reshape(B * S, H, h)), jnp.asarray(kv), clamped,
                     jnp.asarray(table), jnp.arange(B + 1, dtype=jnp.int32) * S,
                     jnp.asarray([B], jnp.int32), sm_scale=scale, soft_cap=softcap or None)
    np.testing.assert_allclose(got.numpy().reshape(B * S, H, h), np.asarray(twin), **TOL)


@pytest.mark.parametrize("mp", [8, 32])
def test_split_choice_fills_the_h100_at_decode(mp):
    """B=8, Kv=8, kv_len 512 (chip_smoke's table of 8 pages, the serving
    engine's of 32): the live splits give at least one block per SM."""
    n = split_kv_plan(8, 8, mp, 64, H100_SMS)
    live = -(-512 // split_chunk(512, n))
    assert 8 * 8 * live >= H100_SMS
    assert split_chunk(300, 4) == 80  # a multiple of 16 that ends inside a 64-row page


def test_split_choice_fills_the_h100_with_one_kv_head():
    """Gemma-2B's one KV head at B=8, kv_len 512 over chip_smoke's table of
    8 pages: splits of 16 keys, not 64-key tiles, fill the card."""
    n = split_kv_plan(8, 1, 8, 64, H100_SMS)
    live = -(-512 // split_chunk(512, n))
    assert 8 * 1 * live >= H100_SMS and n <= MAX_SPLITS


@pytest.mark.parametrize(
    "S,G,page,dtype,want",
    [
        (1, 4, 64, torch.bfloat16, "split_kv"),
        (8, 4, 64, torch.bfloat16, "split_kv"),  # a G = 7 verify step: 32 rows
        (15, 4, 64, torch.bfloat16, "split_kv"),  # 60 rows
        (16, 4, 64, torch.bfloat16, "prefill_tile"),  # 64 rows: the faster tile there
        (16, 4, 4, torch.bfloat16, "split_kv"),  # 64 rows over pages off TMA's grid
        (12, 8, 64, torch.bfloat16, "prefill_tile"),  # 96 rows
        (3, 24, 64, torch.bfloat16, "prefill_tile"),  # 72 rows, G not dividing 64: 48-row tiles
        (10, 7, 64, torch.bfloat16, "prefill_tile"),  # Qwen2.5's G = 7: 70 rows, 63-row tiles
        (1, 72, 64, torch.bfloat16, "cuda_core"),  # 72 heads per KV head: past a 64-row tile
        (1, 4, 64, torch.float32, "cuda_core"),
    ],
)
def test_ragged_regime_by_rows(S, G, page, dtype, want):
    """The ragged kernel's tile by rows per (slot, KV head): split KV
    below 64 rows (the verify steps of --speculate-tokens up to 14), the
    prefill tile from 64 rows where its TMA takes the pages and a tile
    holds at least one position's G rows."""
    from kubeai_tpu_torch.ops.paged_attention import ragged_regime

    q = torch.zeros((1, S, 2 * G, 32), dtype=dtype)
    pool = torch.zeros((3, page, 4, 32), dtype=dtype)
    assert ragged_regime(q, pool) == want
