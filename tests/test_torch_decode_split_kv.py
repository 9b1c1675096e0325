"""The dedicated decode kernel's bf16 path (kubeai_tpu_torch/csrc/
paged_decode_attention.cu over csrc/split_kv_decode.cuh), mirrored in
plain PyTorch: the CUDA kernel runs only on the card
(tests/test_torch_gpu.py), but its arithmetic is the one below, and its
split choice is the wrapper's (``split_kv_plan``, ``split_chunk``).

Per (slot, KV head) the R = S*G query rows go in groups of at most 64
consecutive rows (``row_groups``: a verify step of S > 16 tokens at G =
4), each group its own blocks, and a group's rows sit in 1, 2 or 4 tiles
of 16 rows (padding rows are zero and see no key). A block takes one split of
the slot's clamped kv_len; its four warps form 4 / tiles key streams,
stream j walking 16-key slices j, j + streams, ... with an online
softmax (keys past the split's end are zero rows, masked); the streams'
(m, l, O) are combined, and the live splits merged with the rescale rule.
The mirror is held against the port's wrapper on the CPU (its plain
version) and the JAX package's ``paged_decode_attention._cpu_twin`` (with
the JAX wrapper's length clamp) on the same numpy inputs. float32,
tolerance 1e-5: the paths differ in summation order only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.ops.paged_decode_attention import _cpu_twin
from kubeai_tpu_torch.ops.paged_attention import MAX_SPLITS, split_chunk, split_kv_plan
from kubeai_tpu_torch.ops.paged_decode_attention import (
    MAX_ROWS,
    paged_decode_attention,
    row_groups,
)

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

NEG_INF = -1e30
TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
WARPS = 4  # warps per block (csrc/split_kv_decode.cuh, DEC_NW)
SLICE = 16  # keys per step of a key stream


def row_tiles(R):
    """m16 row tiles of the instance that takes R rows."""
    return 1 if R <= 16 else 2 if R <= 32 else 4


def _online(rows, qpos, k, v, lo, hi, slices, scale, softcap):
    """(m, l, O) of one key stream over its 16-key slices of [lo, hi)."""
    n = rows.shape[0]
    m, l, o = torch.full((n,), NEG_INF), torch.zeros(n), torch.zeros(n, rows.shape[1])
    for sl in slices:
        keys = torch.arange(lo + sl * SLICE, lo + (sl + 1) * SLICE)
        valid = keys < hi
        kk = k[keys.clamp(max=k.shape[0] - 1)] * valid[:, None]  # zero rows past the split
        vv = v[keys.clamp(max=v.shape[0] - 1)] * valid[:, None]
        x = (rows @ kk.T) * scale
        if softcap > 0.0:
            x = softcap * torch.tanh(x / softcap)
        x = torch.where(valid[None, :] & (keys[None, :] <= qpos[:, None]), x, NEG_INF)
        mn = torch.maximum(m, x.max(-1).values)
        p = torch.where(x > NEG_INF / 2, torch.exp(x - mn[:, None]), 0.0)
        al = torch.exp(m - mn)
        l = l * al + p.sum(-1)
        o = o * al[:, None] + p @ vv
        m = mn
    return m, l, o


def _rescale(parts):
    """(M, L, O) of (m, l, O) parts: per row the max M, the rescaled sums."""
    M = torch.stack([m for m, _, _ in parts]).max(0).values
    w = [torch.exp(m - M) for m, _, _ in parts]
    L = sum(l * wi for (_, l, _), wi in zip(parts, w))
    O = sum(o * wi[:, None] for (_, _, o), wi in zip(parts, w))
    return M, L, O


def dedicated_mirror(q, kv_pages, page_table, kv_lengths, n_splits, scale, softcap=0.0):
    """[B, S, H, h] output of the kernel's bf16 path, in float32."""
    B, S, H, h = q.shape
    page, Kv = kv_pages.shape[1], kv_pages.shape[2] // 2
    G, skv = H // Kv, page_table.shape[1] * page
    R = S * G
    groups, RG = row_groups(R)
    tiles = row_tiles(RG)
    streams = WARPS // tiles
    gathered = kv_pages[page_table.long()]  # [B, mp, page, 2Kv, h]
    k = gathered[..., 0::2, :].reshape(B, skv, Kv, h)
    v = gathered[..., 1::2, :].reshape(B, skv, Kv, h)
    out = torch.zeros(B, S, H, h)
    for b in range(B):
        kvl = min(int(kv_lengths[b]), skv)
        chunk = split_chunk(kvl, n_splits)
        live = max(1, -(-kvl // chunk))
        for kv, grp in ((kv, grp) for kv in range(Kv) for grp in range(groups)):
            r0 = grp * RG
            n = min(RG, R - r0)
            rows = torch.zeros(16 * tiles, h)
            rows[:n] = q[b, :, kv * G:(kv + 1) * G].reshape(R, h)[r0:r0 + n]  # row s*G + g
            qpos = torch.full((16 * tiles,), -1)  # padding rows see no key
            qpos[:n] = kvl - S + torch.arange(r0, r0 + n) // G
            splits = []
            for i in range(live):
                lo, hi = i * chunk, min((i + 1) * chunk, kvl)
                n_slices = max(0, -(-(hi - lo) // SLICE))
                splits.append(_rescale([
                    _online(rows, qpos, k[b, :, kv], v[b, :, kv], lo, hi,
                            range(j, n_slices, streams), scale, softcap)
                    for j in range(streams)
                ]))
            if live == 1:
                _, L, O = splits[0]
                res = O / L.clamp(min=1e-30)[:, None]
            else:
                M, L, _ = _rescale(splits)
                res = sum(o * (torch.exp(m - M) / L.clamp(min=1e-30))[:, None]
                          for m, _, o in splits)
            rr = torch.arange(r0, r0 + n)
            out[b, rr // G, kv * G + rr % G] = res[:n]
    return out


# (B, S, H, Kv, page, table width, kv_lens, softcap, n_splits or None for
# the wrapper's own choice on an H100)
CASES = {
    "kv_len_1": (2, 1, 8, 2, 64, 4, [1, 1], 0.0, None),
    "s8_g4_splits_end_mid_page": (1, 8, 8, 2, 64, 8, [300], 0.0, 4),
    "s8_g8_64_rows_softcap": (2, 8, 16, 2, 16, 8, [40, 128], 30.0, None),
    "s5_empty_splits": (2, 5, 8, 2, 16, 4, [17, 5], 0.0, 8),
    "s6_kv_len_past_table": (1, 6, 8, 2, 16, 4, [5000], 0.0, None),
    "s2_softcap": (2, 2, 4, 2, 16, 4, [30, 61], 30.0, None),
    "main_path_s8_kv512": (8, 8, 32, 8, 64, 8, [512] * 8, 0.0, None),
    "uneven_s4": (4, 4, 32, 8, 64, 32, [4, 300, 777, 2048], 0.0, None),
    # Verify steps past 8 tokens and 64 rows (the Pallas kernel takes any
    # S): S = 9 and 16 at G = 4 (36, 64 rows), S = 17 (68 rows: a group
    # of 64 and one of 4), S = 12 at G = 8 (96 rows), and S = 3 at G = 24
    # (72 rows: one token's heads across two groups).
    "s9_g4_36_rows": (2, 9, 8, 2, 16, 4, [9, 50], 0.0, None),
    "s16_g4_64_rows": (2, 16, 8, 2, 64, 4, [16, 200], 0.0, 3),
    "s17_g4_two_groups": (2, 17, 8, 2, 16, 8, [17, 100], 30.0, None),
    "s12_g8_two_groups_uneven": (3, 12, 16, 2, 16, 8, [12, 40, 5000], 0.0, 4),
    "s3_g24_heads_split_across_groups": (1, 3, 48, 2, 16, 4, [40], 0.0, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dedicated_mirror_matches_plain_and_jax(case):
    B, S, H, Kv, page, mp, lens, softcap, n_splits = CASES[case]
    h = 32
    groups, rows = row_groups(S * (H // Kv))
    assert rows <= MAX_ROWS and groups * rows >= S * (H // Kv)
    if n_splits is None:
        n_splits = split_kv_plan(B * groups, Kv, mp, page, H100_SMS)
    assert 1 <= n_splits <= MAX_SPLITS
    rng = np.random.default_rng(11)
    P = 1 + B * mp
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    kv = rng.standard_normal((P, page, 2 * Kv, h)).astype(np.float32)
    table = (rng.permutation(P - 1)[: B * mp] + 1).reshape(B, mp).astype(np.int32)
    kv_lens = np.asarray(lens, np.int32)
    scale = h**-0.5
    args = [torch.from_numpy(a) for a in (q, kv, table, kv_lens)]

    got = dedicated_mirror(*args, n_splits, scale, softcap)
    plain = paged_decode_attention(*args, scale=scale, softcap=softcap)  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    clamped = jnp.minimum(jnp.asarray(kv_lens), mp * page)  # the JAX wrapper's clamp
    twin = _cpu_twin(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(table), clamped,
                     sm_scale=scale, soft_cap=softcap or None)
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), **TOL)

