"""The port's int8 weight-only quantization (kubeai_tpu_torch.ops.quant)
against the JAX package's (kubeai_tpu.ops.quant) on the same seeded
inputs, on the CPU (plain versions; the W8A16 kernel's card tests are in
test_torch_gpu.py):

- quantize / quantize_rows: int8 values and scales bit-identical, from
  numpy and from torch input, against the JAX function on numpy (its
  host path) and on jax arrays;
- qdot / qmatT / qgather: in float32 both packages within the float32
  accumulation bound of float64 truth (K·u·(|x|@|q|)·|s| plus one
  rounding of the scale's product) and the port's error at most 4x
  JAX's plus one ulp of the largest output; within one bf16 rounding of
  each other in bf16; stacked per-layer scales included;
- qdot_many (the grouped projections wq|wk|wv, wg|wu): each output of
  its plain version against the JAX qdot of that weight;
- the kernels' regime and split plan at the main path's shapes;
- the model: llama.apply on params_from_jax(quantize_model_params(...))
  within 1e-4 of the JAX apply on the same int8 tree, untied and tied
  (qmatT), cache-less and through the paged prefill and decode steps;
- test:tiny with int8 weights over an fp8 pool (the server's
  --quantization int8 --kv-cache-dtype fp8): greedy tokens equal to the
  JAX engine's on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeai_tpu.engine.weights import quantize_model_params as j_quantize_model_params
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.ops import quant as jq
from kubeai_tpu_torch.engine.weights import quantize_model_params as t_quantize_model_params
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.ops import quant as tq

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


def _weights(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape) * rng.uniform(0.05, 20.0, size=shape[:-2] + (1, 1) if len(shape) > 2 else ())
    if len(shape) >= 2:
        w[..., 0, 0] = 0.0  # a zero column entry
    return w.astype(dtype)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("rows", [False, True], ids=["quantize", "quantize_rows"])
@pytest.mark.parametrize(
    "shape,dtype",
    [((64, 48), np.float32), ((3, 40, 24), np.float32), ((48, 32), ml_dtypes.bfloat16),
     ((256, 64), np.float32)],
    ids=["2d", "stacked", "bf16", "embed"],
)
def test_quantize_bit_identical_to_jax(rows, shape, dtype):
    w = _weights(shape, seed=len(shape) * 7 + shape[-1], dtype=dtype)
    if dtype == np.float32:
        w[..., -1, -1] = 0.0
    jfn = jq.quantize_rows if rows else jq.quantize
    tfn = tq.quantize_rows if rows else tq.quantize
    want_np = jfn(w)
    want_jax = jfn(jnp.asarray(w))
    t_in = torch.from_numpy(np.ascontiguousarray(w).view(np.uint16)).view(torch.bfloat16) \
        if dtype == ml_dtypes.bfloat16 else torch.from_numpy(w)
    got_np = tfn(w)
    got_t = tfn(t_in)
    assert isinstance(got_np[tq.QKEY], np.ndarray) and isinstance(got_t[tq.QKEY], torch.Tensor)
    for key in (tq.QKEY, tq.SKEY):
        want = np.asarray(want_np[key])
        assert want.dtype == (np.int8 if key == tq.QKEY else np.float32)
        for got in (got_np[key], got_t[key], want_jax[key]):
            assert np.array_equal(_np(got), want), key
    assert got_t[tq.SKEY].shape == want_np[tq.SKEY].shape


def test_stacked_scales_are_per_layer():
    """tests/test_quant.py's stacked case: two layers 100x apart keep their
    own per-channel scales."""
    rng = np.random.default_rng(1)
    w = np.stack([rng.normal(size=(16, 8)), 100 * rng.normal(size=(16, 8))]).astype(np.float32)
    qw = tq.quantize(torch.from_numpy(w))
    assert tuple(qw[tq.SKEY].shape) == (2, 1, 8)
    np.testing.assert_allclose(tq.dequantize(qw).numpy(), w, rtol=2e-2, atol=2e-2 * 100)


def _inputs(M, K, N, seed, stacked=0):
    rng = np.random.default_rng(seed)
    lead = (stacked,) if stacked else ()
    x = rng.normal(size=lead + (M, K)).astype(np.float32)
    w = _weights(lead + (K, N), seed + 1)
    return x, w


def _as(x, dtype):
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


U32 = 2.0**-24  # float32 unit roundoff
PORT_VS_JAX = 4.0  # the port's max error against truth, at most this many times JAX's


def _truth(x, w, rows=False):
    """(float64 x @ W, the float32 bound on either package's error) for
    numpy *x* and a weight *w* of the test: plain [K, N], or int8 values
    and scales (per column, or per row of an [N, K] table with *rows*,
    as qmatT takes it). A float32 product of K terms is within
    K·u·(|x|@|q|)·|s| of the truth, and the scale's product adds one
    rounding of the output."""
    if isinstance(w, dict):
        q = np.asarray(w[tq.QKEY], np.float64)
        s = np.asarray(w[tq.SKEY], np.float64)
        s = s.squeeze(-1) if rows else s.squeeze(-2)
    else:
        q, s = np.asarray(w, np.float64), 1.0
    if rows:
        q = np.swapaxes(q, -1, -2)
    x = np.asarray(x, np.float64)
    truth = (x @ q) * s
    bound = q.shape[-2] * U32 * (np.abs(x) @ np.abs(q)) * np.abs(s) + U32 * np.abs(truth)
    return truth, bound


def _lookup_truth(w, idx):
    """(float64 rows *idx* of a plain or per-row-quantized table, one
    float32 rounding of them)."""
    if isinstance(w, dict):
        rows = np.asarray(w[tq.QKEY], np.float64)[idx] * np.asarray(w[tq.SKEY], np.float64)[idx]
    else:
        rows = np.asarray(w, np.float64)[idx]
    return rows, U32 * np.abs(rows)


def _close(got, want, dtype, truth=None):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        # Both against float64 truth: the two packages sum in different
        # orders, so they may differ by up to twice the bound.
        exact, bound = truth
        err_port, err_jax = np.abs(got - exact), np.abs(want - exact)
        assert (err_port <= bound).all(), (err_port - bound).max()
        assert (err_jax <= bound).all(), (err_jax - bound).max()
        ulp = U32 * np.abs(exact).max()
        assert err_port.max() <= PORT_VS_JAX * err_jax.max() + ulp, (err_port.max(),
                                                                     err_jax.max())
    else:
        # One bf16 rounding of either side (2^-8 relative) apart, after the
        # product and the scale are rounded to bf16 in both frameworks.
        err = np.abs(got - want) - (2.0**-7 * np.abs(want) + 1e-6)
        assert err.max() <= 0, err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,stacked", [(4, 32, 48, 0), (7, 96, 40, 0), (5, 64, 24, 3)])
def test_qdot_matches_jax(dtype, M, K, N, stacked):
    x, w = _inputs(M, K, N, seed=M * K + N, stacked=stacked)
    jw, tw = jq.quantize(w), tq.quantize(torch.from_numpy(w))
    jx, tx = _as(x, dtype)
    if stacked:  # per-layer slices of a stacked weight, as the model takes them
        for li in range(stacked):
            wl = {k: v[li] for k, v in jw.items()}
            _close(tq.qdot(tx[li], {k: v[li] for k, v in tw.items()}), jq.qdot(jx[li], wl),
                   dtype, _truth(x[li], wl))
    else:
        _close(tq.qdot(tx, tw), jq.qdot(jx, jw), dtype, _truth(x, jw))
    # Unquantized weights take the plain product.
    jwp, twp = _as(w, dtype)
    _close(tq.qdot(tx, twp), jq.qdot(jx, jwp), dtype, _truth(x, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qdot_many_matches_jax(dtype):
    """The grouped launch's plain version: one output per weight, each the
    JAX qdot of x with that weight (quantized, and plain weights)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    ws = [_weights((64, n), seed) for seed, n in ((22, 96), (23, 32), (24, 32))]
    jx, tx = _as(x, dtype)
    jws, tws = [jq.quantize(w) for w in ws], [tq.quantize(torch.from_numpy(w)) for w in ws]
    got = tq.qdot_many(tx, tws)
    assert len(got) == 3
    for g, jw in zip(got, jws):
        assert g.dtype == tx.dtype and g.shape == (2, 5, jw[jq.QKEY].shape[1])
        _close(g, jq.qdot(jx, jw), dtype, _truth(x, jw))
    plain = [_as(w, dtype) for w in ws]
    for g, (jw, tw), w in zip(tq.qdot_many(tx, [tw for _, tw in plain]), plain, ws):
        _close(g, jq.qdot(jx, jw), dtype, _truth(x, w))


# Llama-3.1-8B's weights (K, N): wq / wo, wk / wv, wg / wu, wd, the head.
MAIN_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))


def test_regime_and_split_plan_on_the_main_path():
    """The kernel each main-path launch takes on a 132-SM H100, and its
    split plan: decode (M = 8) streams on mma.sync with split-K filling
    two blocks per SM where K allows; verify (M = 64) takes the 64-row
    wgmma tile, split-K held to K / (16 M) pieces so the f32 partials
    stay within a quarter of the weight's bytes; prefill (M = 1024) the
    128-row wgmma tile, unsplit. Float32 x takes FFMA, and weights off
    TMA's grid the mma.sync kernel at every M."""
    assert tq.regime(1, True) == tq.regime(16, True) == (tq.MMA, 16, 128)
    assert tq.regime(17, True) == tq.regime(64, True) == (tq.WGMMA, 64, tq.WGMMA_SMALL_BN)
    # 128 x 256 tiles unless the narrowest weight would leave half the SMs idle.
    assert tq.regime(65, True) == tq.regime(1024, True) == (tq.WGMMA, 128, 256)
    assert tq.regime(1024, True, n_cols=4096) == (tq.WGMMA, 128, 256)
    assert tq.regime(1024, True, n_cols=1024) == (tq.WGMMA, 128, 128)
    assert tq.regime(32, False) == (tq.MMA, 32, 128) and tq.regime(40, False) == (tq.MMA, 64, 128)
    assert tq.regime(1024, False) == (tq.MMA, 64, 128)
    assert tq.regime(8, True, f32=True) == tq.regime(1024, True, f32=True) == (tq.FFMA, 64, 64)
    for K, N in MAIN_SHAPES:
        splits, k_split = tq._plan(8, N, K, True, False, 132)[3:]
        blocks = -(-N // 128) * splits
        assert blocks >= 132 or k_split == 4 * tq.BK or splits == 1
        splits64 = tq._plan(64, N, K, True, False, 132)[3]
        assert splits64 <= max(1, K // (16 * 64))
        assert tq._plan(1024, N, K, True, False, 132)[3] == 1
    # wk / wv at decode: 8 column blocks, 16 splits of 256; at 16 rows 8
    # (64 KB of partials per tile); at verify 4.
    assert tq._plan(8, 1024, 4096, True, False, 132) == (tq.MMA, 16, 128, 16, 256)
    assert tq._plan(16, 1024, 4096, True, False, 132)[3] == 8
    assert tq._plan(64, 1024, 4096, True, False, 132)[3:] == (4, 1024)
    # The qkv group at a prefill chunk takes wk's 128-column tile for all three.
    assert tq._plan(1024, 4096, 4096, True, False, 132, 1024)[:3] == (tq.WGMMA, 128, 128)
    # The head: 1002 column blocks fill the card unsplit.
    assert tq._plan(8, 128256, 4096, True, False, 132)[3] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatT_and_qgather_match_jax(dtype):
    rng = np.random.default_rng(2)
    emb = _weights((40, 16), 3)
    je, te = jq.quantize_rows(emb), tq.quantize_rows(torch.from_numpy(emb))
    idx = np.array([[1, 5, 39], [9, 0, 0]])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = tq.qgather(te, torch.from_numpy(idx), tdt)
    want = jq.qgather(je, jnp.asarray(idx), jdt)
    assert got.dtype == tdt
    _close(got, want, dtype, _lookup_truth(je, idx))
    x = rng.normal(size=(3, 16)).astype(np.float32)
    jx, tx = _as(x, dtype)
    _close(tq.qmatT(tx, te), jq.qmatT(jx, je), dtype, _truth(x, je, rows=True))
    jep, tep = _as(emb, dtype)
    _close(tq.qmatT(tx, tep), jq.qmatT(jx, jep), dtype, _truth(x, emb, rows=True))
    _close(tq.qgather(tep, torch.from_numpy(idx), tdt), jq.qgather(jep, jnp.asarray(idx), jdt), dtype,
           _lookup_truth(emb, idx))


@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
def test_qgather_clamps_ids_like_jax(quantized):
    """Ids past the table (a byte tokenizer's BOS 256 over a 256-row
    vocab) and negative ids read the rows JAX's gather reads: a negative
    id counts from the end, then ids clamp to the first or last row."""
    emb = _weights((4, 8), 11)
    if quantized:  # device arrays: numpy's own indexing would raise, not clamp
        jw = jax.tree.map(jnp.asarray, jq.quantize_rows(emb))
        tw = tq.quantize_rows(torch.from_numpy(emb))
    else:
        jw, tw = jnp.asarray(emb), torch.from_numpy(emb)
    idx = np.array([[4, 7, 256, 3], [-1, -4, -5, -9], [0, 1, 2, 2**31 - 1]], np.int32)
    got = tq.qgather(tw, torch.from_numpy(idx), torch.float32)
    want = np.asarray(jq.qgather(jw, jnp.asarray(idx), jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(want[0, 0], want[0, 3])  # the row JAX reads for an id past the end


def test_split_plan_covers_k():
    """The split-K plan of the decode shapes: pieces of whole 64-deep
    stages that cover K exactly once, enough blocks for two per SM where
    K allows, and no split for prefill rows."""
    for K, N in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256),
                 (4104, 1000)):
        for M in (1, 8, 64):
            splits, k_split = tq.split_plan(M, N, K, 132)
            assert k_split % tq.BK == 0 and (splits - 1) * k_split < K <= splits * k_split
            assert k_split >= min(K, 4 * tq.BK) or splits == 1
        assert tq.split_plan(65, N, K, 132)[0] == 1
    assert tq.split_plan(8, 1024, 4096, 132) == (16, 256)  # wk / wv: 8 column blocks


TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(tie):
    jc = JMC(
        vocab_size=272, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, dtype="float32", max_position=2048, rope_theta=500000.0,
        tie_word_embeddings=tie,
    )
    return jc, TMC(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(JMC)})


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_int8_model_matches_jax(tie):
    jc, tc = _configs(tie)
    jp = j_quantize_model_params(jl.init_params(jc, jax.random.key(0)), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    assert tq.is_quantized(tp["layers"]["wq"]) and tq.is_quantized(tp["embed"])
    assert ("lm_head" in tp) == (not tie)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 272, (2, 12))
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).copy()
    jlog, _ = jl.apply(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
    tlog, _ = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    # The serving path: paged cold prefill and a decode step, the port's
    # kernel gates on (the kernels' plain versions on the CPU) against the
    # JAX package's gather path (its kernel twins only cost compile time).
    tc = tc.replace(use_flash_prefill=True, use_paged_kernel=True)
    B, ps, mp = 2, 16, 4
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    jpool, tpool = jl.init_paged_cache(jc, P, ps), tl.init_paged_cache(tc, P, ps, "cpu")
    prompt = rng.integers(1, 259, (B, 32)).astype(np.int32)
    lens = np.array([20, 32], np.int32)
    jlog, jpool = jl.prefill_paged_cold(jp, jc, jnp.asarray(prompt), jpool, jnp.asarray(table),
                                        jnp.asarray(lens))
    tlog, _ = tl.prefill_paged_cold(tp, tc, torch.from_numpy(prompt), tpool,
                                    torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    step = rng.integers(1, 259, (B, 1)).astype(np.int32)
    jlog, _ = jl.decode_step_paged(jp, jc, jnp.asarray(step), jpool, jnp.asarray(table),
                                   jnp.asarray(lens))
    tlog, _ = tl.decode_step_paged(tp, tc, torch.from_numpy(step), tpool,
                                   torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_quantize_model_params_matches_jax():
    """The port's quantize_model_params on the port's tree equals the JAX
    one's on the JAX tree (same bf16 weights), leaf for leaf."""
    jc, tc = _configs(False)
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    jp = jl.init_params(jc, jax.random.key(1))
    want = jax.tree.map(np.asarray, j_quantize_model_params(jp, jc))
    got = t_quantize_model_params(params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu"), tc)
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        for key in (tq.QKEY, tq.SKEY):
            assert np.array_equal(got["layers"][name][key].numpy(), want["layers"][name][key])
    for name in ("embed", "lm_head"):
        for key in (tq.QKEY, tq.SKEY):
            assert np.array_equal(got[name][key].numpy(), want[name][key])
    assert got["layers"]["ln1"].dtype == torch.bfloat16  # norms stay full precision


def _greedy(engine, prompt, sp_cls, n=12):
    req = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=n))
    toks = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append(ev[1])
        elif ev[0] == "done":
            return toks
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


def test_tiny_int8_fp8_engine_matches_jax_engine():
    """test:tiny as `--quantization int8 --kv-cache-dtype fp8` builds it on
    the CPU (build_test_engine quantizes the JAX engine's float32 weights,
    handed over by params_from_jax) serves the greedy tokens of the JAX
    engine over the JAX-quantized weights and an fp8 pool (float32
    products: qdot in x's dtype)."""
    from kubeai_tpu.engine import core as jcore
    from kubeai_tpu.engine.tokenizer import ByteTokenizer as JTok
    from kubeai_tpu_torch.engine import core as tcore
    from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
    from kubeai_tpu_torch.engine.server import build_engine_from_args, make_arg_parser
    from kubeai_tpu.engine.sampling import SamplingParams as JSP

    ec = dict(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32, 64), kv_cache_dtype="fp8")
    jf = jcore.build_test_engine(engine_config=jcore.EngineConfig(**ec), seed=0)
    jmc = jf.model_config
    je = jcore.Engine(jmc, j_quantize_model_params(jf.params, jmc), JTok(),
                      jcore.EngineConfig(**ec))
    mc = TMC(**{f.name: getattr(jmc, f.name) for f in dataclasses.fields(TMC)})
    tp = params_from_jax(jax.tree.map(np.asarray, jf.params), mc, "cpu")
    te = tcore.build_test_engine(tcore.EngineConfig(**ec), device="cpu", params=tp,
                                 model_config=mc.replace(kv_cache_dtype=""),
                                 quantization="int8")
    assert tq.is_quantized(te.params["layers"]["wq"]) and te.cache["kv"].dtype == torch.float8_e4m3fn
    # The server's command line builds the same configuration.
    cli, _ = build_engine_from_args(make_arg_parser().parse_args(
        ["--model", "test:tiny", "--quantization", "int8", "--kv-cache-dtype", "fp8",
         "--device", "cpu"]))
    assert tq.is_quantized(cli.params["lm_head"]) and cli.cache["kv"].dtype == torch.float8_e4m3fn
    assert cli.model_config.replace(kv_cache_dtype="") == mc.replace(kv_cache_dtype="")
    je.start()
    te.start()
    try:
        for prompt in ([256] + list(b"hello int8 world"),
                       [256] + [(i * 11) % 250 + 1 for i in range(100)]):
            assert _greedy(te, prompt, TSP) == _greedy(je, prompt, JSP)
    finally:
        je.stop()
        te.stop()
