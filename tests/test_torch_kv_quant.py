"""The port's quantized KV pool (``kv_cache_dtype`` "fp8" / "int8") against
the JAX package's, on the tiny float32 config (2 layers, hidden 128, 4
heads, 2 KV heads, page 16) with inputs from numpy and fixed seeds:

- the pool's bytes after a paged prefill and decode steps equal the JAX
  pool's exactly (quantize on write: x / scale, int8 rounded half to
  even and clipped to +-127, fp8 clipped to +-448 before the convert),
  with K/V values past the formats' ranges and exact rounding ties;
- the plain quantized-pool attention against the JAX ragged wrapper (its
  CPU twin) and the Pallas decode kernel in interpret mode, within 1e-5;
- model logits (cold, chunked prefill, decode) within 1e-4, and the fp8
  engine's greedy tokens equal to the JAX fp8 engine's.

int8 scales are tests/test_kv_quant.py's (k 0.05, v 0.02); fp8 is
scale-free. On the card the kernels are held to these plain versions
(tests/test_torch_gpu.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import core as jcore
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.ops.paged_attention import paged_attention_ragged as j_ragged
from kubeai_tpu.ops.paged_decode_attention import paged_decode_attention as j_decode
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.ops.paged_attention import paged_attention_plain, paged_attention_ragged
from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


SCALES = dict(kv_scale_k=0.05, kv_scale_v=0.02)
POOL = {"fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn), "int8": (jnp.int8, torch.int8)}


def _configs(kv, **kw):
    jc = JMC(
        vocab_size=272, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, dtype="float32", max_position=2048,
        rope_theta=500000.0, kv_cache_dtype=kv, **SCALES, **kw,
    )
    tc = TMC(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(JMC)})
    return jc, tc


def _torch_bytes(a) -> torch.Tensor:
    """A one-byte JAX/numpy array as a torch tensor of the same dtype."""
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.uint8).copy()).view(POOL[_kind(a.dtype)][1])


def _kind(dtype) -> str:
    return "int8" if np.dtype(dtype) == np.int8 else "fp8"


@pytest.mark.parametrize("kv", ["fp8", "int8"])
def test_pool_dtype_and_bytes(kv):
    _, tc = _configs(kv)
    pool = tl.init_paged_cache(tc, 8, 16, "cpu")["kv"]
    assert pool.dtype == POOL[kv][1] and tl.kv_pool_dtype(tc) == POOL[kv][1]
    bf16 = tl.init_paged_cache(tc.replace(kv_cache_dtype="", dtype="bfloat16"), 8, 16, "cpu")
    assert pool.nbytes * 2 == bf16["kv"].nbytes


# V values of the special token (layer 0, KV head 0, first columns) and
# the bytes they must become. fp8 (scale 1): ties 17 -> 16 and 19 -> 20,
# 2^-10 (half the smallest subnormal) -> 0, 3*2^-10 -> 2^-8 (even), and
# values past +-448, which JAX would turn into NaN without the clip.
# int8 (scale 0.02): y = x / 0.02 exactly 0.5, 1.5, -0.5, -1.5 (half to
# even: 0, 2, -0, -2) and values past +-127 * 0.02.
_S = float(np.float32(0.02))
TIES = {
    "fp8": ([17.0, 19.0, 2.0**-10, 3 * 2.0**-10, -17.0, 600.0, -1000.0, 464.0],
            [16.0, 20.0, 0.0, 2.0**-8, -16.0, 448.0, -448.0, 448.0]),
    "int8": ([0.5 * _S, 1.5 * _S, -0.5 * _S, -1.5 * _S, 600.0, -1000.0],
             [0.0, 2.0, 0.0, -2.0, 127.0, -127.0]),
}


@pytest.mark.parametrize("kv", ["fp8", "int8"])
def test_pool_bytes_equal_jax(kv):
    """After a paged prefill and 4 decode steps the two pools hold the
    same bytes. Token T's embedding row is +-1024 (RMSNorm then gives
    exactly +-1) and layer 0's wv maps its first entry alone to the
    columns of TIES, so its V row holds those values exactly in both
    frameworks (position 0 of slot 0; V takes no rope)."""
    jc, tc = _configs(kv)
    tree = jax.tree.map(np.asarray, jl.init_params(jc, jax.random.key(0)))
    tree = jax.tree.map(np.copy, tree)
    rng = np.random.default_rng(0)
    T = 258
    signs = rng.choice([-1.0, 1.0], size=128).astype(np.float32)
    signs[0] = 1.0
    tree["embed"][T] = 1024.0 * signs
    vals, want_vals = TIES[kv]
    for j, x in enumerate(vals):
        tree["layers"]["wv"][0, :, j] = 0.0
        tree["layers"]["wv"][0, 0, j] = x
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, tc, "cpu")

    B, ps, mp = 2, 16, 8
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    jpool = jl.init_paged_cache(jc, P, ps)
    tpool = tl.init_paged_cache(tc, P, ps, "cpu")
    toks = rng.integers(1, 258, (B, 32)).astype(np.int32)
    toks[0, 0] = T
    lens = np.array([20, 32], np.int32)
    _, jpool = jl.prefill_paged_cold(jp, jc, jnp.asarray(toks), jpool, jnp.asarray(table),
                                     jnp.asarray(lens))
    tl.prefill_paged_cold(tp, tc, torch.from_numpy(toks), tpool, torch.from_numpy(table),
                          torch.from_numpy(lens))
    for i in range(4):
        step = rng.integers(1, 258, (B, 1)).astype(np.int32)
        pos = lens + i
        _, jpool = jl.decode_step_paged(jp, jc, jnp.asarray(step), jpool, jnp.asarray(table),
                                        jnp.asarray(pos))
        tl.decode_step_paged(tp, tc, torch.from_numpy(step), tpool, torch.from_numpy(table),
                             torch.from_numpy(pos))
    jb = np.asarray(jpool["kv"])
    assert jb.dtype == np.dtype(POOL[kv][0]) and tpool["kv"].dtype == POOL[kv][1]
    np.testing.assert_array_equal(tpool["kv"].view(torch.uint8).numpy(), jb.view(np.uint8))
    # Slot 0's position 0 is pool page 1 of layer 0, offset 0; V of KV head 0.
    got = tpool["kv"][1, 0, 1, : len(vals)].float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want_vals, np.float32))


def _paged_inputs(rng, kv, B, S, H, Kv, h=128, P=13, ps=16, mp=4):
    """f32 q and a one-byte pool (int8 values round(N(0,1) / 0.05); fp8
    values N(0,1) in e4m3), made by JAX's own converts."""
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    x = rng.standard_normal((P, ps, 2 * Kv, h)).astype(np.float32)
    if kv == "int8":
        pool = jnp.clip(jnp.round(jnp.asarray(x) / 0.05), -127, 127).astype(jnp.int8)
    else:
        pool = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    table = rng.choice(np.arange(1, P), size=(B, mp), replace=False).astype(np.int32)
    return q, pool, table


QCASES = [
    (2, 1, 8, 2, [17, 42], 0.0),  # decode
    (2, 4, 8, 2, [19, 45], 30.0),  # speculative (G = 4), softcap
    (3, 1, 16, 2, [1, 33, 64], 0.0),  # extreme lengths
]


@pytest.mark.parametrize("kv", ["fp8", "int8"])
@pytest.mark.parametrize("B,S,H,Kv,lens,softcap", QCASES)
def test_quantized_plain_matches_jax(kv, B, S, H, Kv, lens, softcap):
    """paged_attention_plain on a one-byte pool (and both wrappers, which
    run it on the CPU) against the JAX ragged wrapper (its CPU twin) and
    the Pallas decode kernel in interpret mode, which dequantizes in f32
    inside the kernel. Tolerance 1e-5: float32 attention on every side."""
    ks, vs = (0.05, 0.02) if kv == "int8" else (1.0, 1.0)
    rng = np.random.default_rng(5)
    q, pool, table = _paged_inputs(rng, kv, B, S, H, Kv)
    jl_ = jnp.asarray(lens, jnp.int32)
    want = np.asarray(j_ragged(jnp.asarray(q), pool, jnp.asarray(table), jl_, softcap=softcap,
                               k_scale=ks, v_scale=vs))
    want_dec = np.asarray(j_decode(jnp.asarray(q), pool, jnp.asarray(table), jl_,
                                   softcap=softcap, k_scale=ks, v_scale=vs, interpret=True))
    tq, tpool, ttab = torch.from_numpy(q), _torch_bytes(pool), torch.from_numpy(table)
    tlens = torch.tensor(lens, dtype=torch.int32)
    got = paged_attention_plain(tq, tpool, ttab, tlens, 128**-0.5, softcap, ks, vs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_dec, rtol=1e-5, atol=1e-5)
    for fn in (paged_attention_ragged, paged_decode_attention):
        before = fn.launches
        out = fn(tq, tpool, ttab, tlens, softcap=softcap, k_scale=ks, v_scale=vs)
        assert fn.launches == before
        assert torch.equal(out, got)


@pytest.mark.parametrize("kv", ["fp8", "int8"])
@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernels"])
def test_quantized_forward_matches_jax(kv, kernels):
    """Logits over a quantized pool: cold prefill (a 256 bucket, so the
    flash gate opens with the kernels on), a chunked prefill at start > 0,
    a decode step (ragged) and a 3-token verify (dedicated), with the
    kernel flags off (gather path, dequantized in the model) and on (the
    paged wrappers' plain versions). Within 1e-4, as test_torch_llama.py
    holds the float32 pool."""
    flags = dict(use_flash_prefill=kernels, use_paged_kernel=kernels)
    jc, tc = _configs(kv, **flags)
    jp = jl.init_params(jc, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    B, ps, mp = 2, 16, 20
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    rng = np.random.default_rng(1)
    jpool = jl.init_paged_cache(jc, P, ps)
    tpool = tl.init_paged_cache(tc, P, ps, "cpu")

    def both(jfn, tfn, *args, **kw):
        nonlocal jpool
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(np.asarray(a)) for a in args]
        jlog, jpool = jfn(jp, jc, jargs[0], jpool, jnp.asarray(table), *jargs[1:], **kw)
        tlog, _ = tfn(tp, tc, targs[0], tpool, torch.from_numpy(table), *targs[1:], **kw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)

    toks = rng.integers(1, 259, (B, 256)).astype(np.int32)
    both(jl.prefill_paged_cold, tl.prefill_paged_cold, toks, np.array([200, 256], np.int32))
    chunk = rng.integers(1, 259, (B, 32)).astype(np.int32)
    both(jl.prefill_paged, tl.prefill_paged, chunk,
         np.array([256, 256], np.int32), np.array([31, 10], np.int32))
    step = rng.integers(1, 259, (B, 1)).astype(np.int32)
    both(jl.decode_step_paged, tl.decode_step_paged, step,
         np.array([288, 290], np.int32), decode_kernel="ragged")
    spec = rng.integers(1, 259, (B, 3)).astype(np.int32)
    both(jl.decode_speculative_paged, tl.decode_speculative_paged, spec,
         np.array([289, 291], np.int32), decode_kernel="auto")
    assert tpool["kv"].dtype == POOL[kv][1]


def _greedy(engine, prompt, params, n=16):
    req = engine.submit(prompt, params(temperature=0.0, max_tokens=n))
    toks = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append(ev[1])
        elif ev[0] == "done":
            return toks
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


@pytest.mark.parametrize("decode_kernel", ["ragged", "dedicated"])
def test_fp8_engine_greedy_matches_jax_engine(decode_kernel):
    """The tiny engine with kv_cache_dtype="fp8" (the EngineConfig field
    replaces the model config's, as in the JAX engine) serves the JAX fp8
    engine's greedy tokens on the same weights: a bucketed prompt and a
    chunked one (past the largest bucket)."""
    ec = dict(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32, 64),
              kv_cache_dtype="fp8", decode_kernel=decode_kernel)
    je = jcore.build_test_engine(engine_config=jcore.EngineConfig(**ec), seed=0)
    mc = TMC(**{f.name: getattr(je.model_config, f.name) for f in dataclasses.fields(TMC)})
    assert mc.kv_cache_dtype == "fp8"
    tp = params_from_jax(jax.tree.map(np.asarray, je.params), mc, "cpu")
    te = tcore.build_test_engine(tcore.EngineConfig(**ec), device="cpu", params=tp,
                                 model_config=mc.replace(kv_cache_dtype=""))
    assert te.cache["kv"].dtype == torch.float8_e4m3fn
    je.start()
    te.start()
    try:
        for prompt in ([256] + list(b"hello quantized world"),
                       [256] + [(i * 11) % 250 + 1 for i in range(100)]):
            assert _greedy(te, prompt, TSP) == _greedy(je, prompt, JSP)
    finally:
        je.stop()
        te.stop()
