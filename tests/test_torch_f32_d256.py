"""Float32 attention at head dim 256 (a float32 Gemma) on the CPU: the
port against the JAX package, each case's inputs made from a numpy seed.

- Flash: ``flash_attention_tpu`` in Pallas interpret mode.
- Ragged: ``paged_attention_ragged`` (its CPU twin) over float32, int8
  and fp8 pools at decode, verify and prefill shapes.
- Dedicated decode: ``paged_decode_attention`` in Pallas interpret mode
  over the same pools, a 64-row verify group included (S = 8 at G = 8,
  which the card's float32 kernel takes as two groups of 32 rows).
- The model: a 2-layer Gemma at head dim 256 and narrow widths, its paged
  forward with the kernel gates on (the kernels' plain versions here)
  against the JAX forward, and the same weights written by the port's
  ``save_hf_checkpoint`` and loaded by each package's
  ``load_engine_from_path(dir, dtype="float32")``: greedy tokens
  identical, top logprobs within 1e-4.

Tolerance 1e-4 absolute and relative: float32 attention on both sides,
summation order alone. On the CPU every wrapper runs its plain version
(no launch is counted); tests/test_torch_gpu.py holds the CUDA kernels
(the "_f32d256" libraries) against those plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import weights as jw
from kubeai_tpu.engine.core import EngineConfig as JEC
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.ops.flash_attention import flash_attention_tpu
from kubeai_tpu.ops.paged_attention import paged_attention_ragged as j_ragged
from kubeai_tpu.ops.paged_decode_attention import paged_decode_attention as j_decode
from kubeai_tpu_torch.engine import weights as tw
from kubeai_tpu_torch.engine.core import EngineConfig as TEC
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.flash_attention import flash_attention
from kubeai_tpu_torch.ops.paged_attention import library, paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import (
    max_group_rows,
    paged_decode_attention,
    row_groups,
)

import _torch_families as fam
from _torch_parity import assert_same_greedy
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

H256 = 256
TOL = dict(rtol=1e-4, atol=1e-4)
# The pools: float32 (q's dtype), and one byte per element with the JAX
# package's test scales (int8: K 0.05, V 0.02; fp8 scale-free).
POOLS = {"float32": (None, None), "int8": (0.05, 0.02), "fp8": (1.0, 1.0)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize(
    "B,S,H,Kv,causal",
    [(1, 128, 4, 1, True), (2, 64, 4, 2, False)],
)
def test_flash_matches_pallas_interpret(B, S, H, Kv, causal):
    rng = np.random.default_rng(B * S + H)
    q = rng.normal(size=(B, S, H, H256)).astype(np.float32)
    k = rng.normal(size=(B, S, Kv, H256)).astype(np.float32)
    v = rng.normal(size=(B, S, Kv, H256)).astype(np.float32)
    want = flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               block_q=32, block_k=32, interpret=True)
    before = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert flash_attention.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pool(rng, kind, P, page, Kv):
    """A JAX pool (float32, or int8 / fp8 made by JAX's own converts) and
    the same bytes as a torch tensor."""
    x = rng.standard_normal((P, page, 2 * Kv, H256)).astype(np.float32)
    if kind == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    if kind == "int8":
        jpool = jnp.clip(jnp.round(jnp.asarray(x) / 0.05), -127, 127).astype(jnp.int8)
        return jpool, torch.from_numpy(np.asarray(jpool).copy())
    jpool = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    raw = np.asarray(jpool).view(np.uint8).copy()
    return jpool, torch.from_numpy(raw).view(torch.float8_e4m3fn)


def _paged_case(kind, B, S, H, Kv, lens, page=16, mp=8, seed=0):
    rng = np.random.default_rng(seed)
    P = 1 + B * mp
    jpool, tpool = _pool(rng, kind, P, page, Kv)
    q = rng.standard_normal((B, S, H, H256)).astype(np.float32)
    table = (rng.permutation(P - 1)[: B * mp] + 1).reshape(B, mp).astype(np.int32)
    ks, vs = POOLS[kind]
    return q, jpool, tpool, table, np.asarray(lens, np.int32), ks, vs


# (B, S, H, Kv, lens): decode at Gemma-2B's G = 8 (8 rows), a verify step
# of 8 tokens (64 rows), Gemma2's G = 2, and a prefill chunk at a start.
RAGGED_CASES = [
    (2, 1, 8, 1, [17, 100]),
    (2, 8, 8, 1, [19, 128]),
    (2, 3, 4, 2, [40, 77]),
    (1, 32, 4, 1, [96]),
]


@pytest.mark.parametrize("kind", list(POOLS))
@pytest.mark.parametrize("B,S,H,Kv,lens", RAGGED_CASES)
def test_ragged_matches_jax(kind, B, S, H, Kv, lens):
    q, jpool, tpool, table, lens, ks, vs = _paged_case(kind, B, S, H, Kv, lens, seed=S + H)
    want = j_ragged(jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(lens),
                    k_scale=ks, v_scale=vs)
    before = paged_attention_ragged.launches
    got = paged_attention_ragged(_t(q), tpool, _t(table), _t(lens), k_scale=ks, v_scale=vs)
    assert paged_attention_ragged.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, S, H, Kv, lens): decode (8 rows), verify S = 8 at G = 8 (64 rows:
# two groups of 32 on the card, where test_torch_gpu.py also runs 72).
DECODE_CASES = [
    (2, 1, 8, 1, [17, 100]),
    (2, 8, 8, 1, [23, 128]),
]


@pytest.mark.parametrize("kind", list(POOLS))
@pytest.mark.parametrize("B,S,H,Kv,lens", DECODE_CASES)
def test_dedicated_matches_pallas_interpret(kind, B, S, H, Kv, lens):
    q, jpool, tpool, table, lens, ks, vs = _paged_case(kind, B, S, H, Kv, lens, seed=S + 7)
    want = j_decode(jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(lens),
                    k_scale=ks, v_scale=vs, interpret=True)
    before = paged_decode_attention.launches
    got = paged_decode_attention(_t(q), tpool, _t(table), _t(lens), k_scale=ks, v_scale=vs)
    assert paged_decode_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_float32_at_256_takes_its_own_libraries_and_row_groups():
    """float32 at head dim 256 passes the wrappers' checks, loads the
    "_f32d256" libraries (bf16 keeps "_d256"), and the dedicated kernel
    takes its rows in groups of at most 32 (64 rows would need 280,064
    bytes of shared memory, past the card's 232,448)."""
    q = torch.zeros((1, 1, 8, H256))
    assert _build.check_cuda_inputs("t", H256, {"q": q}) == (0, _build.POOL_SAME)
    assert _build.check_cuda_inputs("t", H256, {"q": q.bfloat16()}) == (1, _build.POOL_SAME)
    for name in ("paged_attention", "paged_decode_attention"):
        for code in (_build.POOL_SAME, _build.POOL_INT8, _build.POOL_FP8):
            assert library(name, H256, code, True) == f"{name}_f32d256"
            assert library(name, H256, code) == f"{name}_d256"
            assert library(name, 128, code, True) == name
    assert _build.attention_library("flash_attention", H256, True) == "flash_attention_f32d256"
    assert set(_build.VARIANTS) >= {f"{n}_f32d256" for n in (
        "flash_attention", "paged_attention", "paged_decode_attention")}
    assert max_group_rows(torch.float32, H256) == 32
    assert max_group_rows(torch.bfloat16, H256) == max_group_rows(torch.float32, 128) == 64
    assert row_groups(64, 32) == (2, 32) and row_groups(72, 32) == (3, 32)
    assert row_groups(8, 32) == (1, 8) and row_groups(64) == (1, 64)


# A 2-layer Gemma at head dim 256 over narrow widths: 2 query heads over
# one KV head (Gemma-2B's single KV head).
GEMMA_256 = dict(head_dim=H256, num_heads=2, num_kv_heads=1)


def test_paged_forward_with_kernel_gates_matches_jax():
    fam.check_paged_forward("gemma", True, **GEMMA_256)


def test_serving_libraries_of_a_float32_gemma():
    from kubeai_tpu_torch.engine.core import preset_config

    mc = preset_config("gemma-2b").replace(dtype="float32")
    ec = TEC(kv_cache_dtype="fp8", decode_kernel="dedicated")
    assert _build.serving_libraries(mc, ec) == [
        "flash_attention_f32d256", "paged_attention_f32d256", "paged_decode_attention_f32d256"]
    assert _build.serving_libraries(mc.replace(dtype="bfloat16"), ec) == [
        "flash_attention_d256", "paged_attention_d256", "paged_decode_attention_d256"]


ENGINE = dict(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32, 64))


def _greedy(engine, sp_cls, prompt, n):
    req = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=n, logprobs=True))
    out = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            out.append((ev[1], ev[4]))
        elif ev[0] == "done":
            return out
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def test_checkpoint_engine_matches_jax_engine(tmp_path):
    """The float32 Gemma through each package's checkpoint loader, as a
    user serves one: greedy tokens identical (up to a near-tie) and the
    top logprobs of every compared step within 1e-4."""
    _, tc, _, tp = fam.model("gemma", **GEMMA_256)
    path = str(tmp_path / "gemma256")
    tw.save_hf_checkpoint(path, tc, tw.hf_state_dict(tp, tc))
    je = jw.load_engine_from_path(path, JEC(**ENGINE), dtype="float32")
    te = tw.load_engine_from_path(path, TEC(**ENGINE), dtype="float32", device="cpu")
    assert te.model_config.head_dim_ == H256 and te.model_config.dtype == "float32"
    assert te.params["embed"].dtype == torch.float32
    je.start()
    te.start()
    try:
        for prompt in ([256] + list(b"Hello there"),
                       [256] + [(i * 11) % 250 + 1 for i in range(100)]):
            ref = _greedy(je, JSP, prompt, 12)
            got = _greedy(te, TSP, prompt, 12)
            upto = assert_same_greedy(got, ref, "float32 gemma h256")
            assert upto > 0
            for (_, gtop), (_, rtop) in zip(got[:upto], ref[:upto]):
                assert [t for t, _ in gtop] == [t for t, _ in rtop]
                np.testing.assert_allclose([lp for _, lp in gtop], [lp for _, lp in rtop],
                                           **TOL)
    finally:
        je.stop()
        te.stop()
