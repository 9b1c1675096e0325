"""Shared by the port's model-family parity tests (test_torch_qwen2.py,
test_torch_gemma.py, test_torch_mixtral.py): small float32 configs of
each family, one seeded set of weights in the JAX package's tree (its
zero biases and unit norms replaced by seeded numpy values, so every
leaf matters), and the checks each family runs:

- the paged forward (cold prefill of a 256 bucket, so the flash gate
  opens; a chunk at start > 0; decode under both decode kernels; a
  3-token verify step) against the JAX package's, logits and the pool
  within 1e-4, with the kernel gates off (gather path) and on (the
  kernels' plain versions on the CPU);
- an fp8 pool's bytes after a cold prefill and a decode step equal to
  the JAX pool's;
- the engine's greedy tokens identical to the JAX engine's on the same
  weights (tests/_torch_parity.py's near-tie rule)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubeai_tpu.engine import core as jcore
from kubeai_tpu.engine.sampling import SamplingParams as JSP
from kubeai_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer
from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.sampling import SamplingParams as TSP
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax

from _torch_parity import assert_same_greedy

TOL = dict(rtol=1e-4, atol=1e-4)

# Each family's flags as ModelConfig.from_hf sets them, at widths of 64.
BASE = dict(vocab_size=272, hidden_size=64, intermediate_size=128, num_layers=2,
            dtype="float32", max_position=2048)
FAMILIES = {
    # 14 query heads over 2 KV heads: groups of 7, which do not divide 64.
    "qwen2": dict(num_heads=14, num_kv_heads=2, head_dim=16, qkv_bias=True,
                  rope_theta=1e6, rms_norm_eps=1e-6),
    "gemma": dict(num_heads=4, num_kv_heads=1, head_dim=32, hidden_act="gelu_tanh",
                  embed_scale=True, rms_one_offset=True, tie_word_embeddings=True,
                  rms_norm_eps=1e-6),
    "gemma2": dict(num_heads=4, num_kv_heads=2, head_dim=16, hidden_act="gelu_tanh",
                   embed_scale=True, rms_one_offset=True, tie_word_embeddings=True,
                   post_norms=True, attn_softcap=50.0, logit_softcap=30.0,
                   query_scale=16**-0.5, sliding_window=8, sliding_layers="even",
                   rms_norm_eps=1e-6),
    "mixtral": dict(num_heads=4, num_kv_heads=2, num_experts=4, num_experts_per_tok=2,
                    rope_theta=1e6),
}


def configs(family: str, **kw) -> tuple[JMC, TMC]:
    jc = JMC(**{**BASE, **FAMILIES[family], **kw})
    return jc, TMC(**dataclasses.asdict(jc))


def jax_params(jc: JMC, seed: int = 0) -> dict:
    """The JAX package's init_params with its constant leaves (zero
    biases, unit norms) replaced by seeded values: norms 1 + N(0, 0.1)
    (N(0, 0.1) where Gemma adds the 1 itself), biases N(0, 0.1)."""
    params = jl.init_params(jc, jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    one = 0.0 if jc.rms_one_offset else 1.0

    def noisy(like, base):
        return jnp.asarray(base + 0.1 * rng.normal(size=like.shape), like.dtype)

    layers = dict(params["layers"])
    for k in ("ln1", "ln2", "ln1b", "ln2b"):
        if k in layers:
            layers[k] = noisy(layers[k], one)
    for k in ("bq", "bk", "bv"):
        if k in layers:
            layers[k] = noisy(layers[k], 0.0)
    return {**params, "layers": layers, "final_norm": noisy(params["final_norm"], one)}


def model(family: str, seed: int = 0, **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc, tc = configs(family, **kw)
    jp = jax_params(jc, seed)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


def check_paged_forward(family: str, kernels: bool) -> None:
    jc, tc, jp, tp = model(family)
    flags = dict(use_flash_prefill=kernels, use_paged_kernel=kernels)
    jc, tc = jc.replace(**flags), tc.replace(**flags)
    B, ps, mp = 2, 16, 20
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    rng = np.random.default_rng(0)
    jpool = jl.init_paged_cache(jc, P, ps)
    tpool = tl.init_paged_cache(tc, P, ps, "cpu")

    def both(jfn, tfn, *args, **kw):
        nonlocal jpool
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(np.asarray(a)) for a in args]
        jlog, jpool = jfn(jp, jc, jargs[0], jpool, jnp.asarray(table), *jargs[1:], **kw)
        tlog, _ = tfn(tp, tc, targs[0], tpool, torch.from_numpy(table), *targs[1:], **kw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    toks = rng.integers(1, 259, (B, 256)).astype(np.int32)
    both(jl.prefill_paged_cold, tl.prefill_paged_cold, toks, np.array([200, 256], np.int32))
    np.testing.assert_allclose(tpool["kv"].numpy(), np.asarray(jpool["kv"]), **TOL)
    chunk = rng.integers(1, 259, (B, 32)).astype(np.int32)
    both(jl.prefill_paged, tl.prefill_paged, chunk,
         np.array([256, 256], np.int32), np.array([31, 10], np.int32))
    for dk in ("ragged", "dedicated"):
        step = rng.integers(1, 259, (B, 1)).astype(np.int32)
        both(jl.decode_step_paged, tl.decode_step_paged, step,
             np.array([288, 290], np.int32), decode_kernel=dk)
    spec = rng.integers(1, 259, (B, 3)).astype(np.int32)
    both(jl.decode_speculative_paged, tl.decode_speculative_paged, spec,
         np.array([291, 293], np.int32), decode_kernel="auto")
    np.testing.assert_allclose(tpool["kv"].numpy(), np.asarray(jpool["kv"]), **TOL)


def check_fp8_pool_bytes(family: str) -> None:
    jc, tc, jp, tp = model(family, kv_cache_dtype="fp8")
    B, ps, mp = 2, 16, 4
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    rng = np.random.default_rng(1)
    jpool = jl.init_paged_cache(jc, P, ps)
    tpool = tl.init_paged_cache(tc, P, ps, "cpu")
    assert tpool["kv"].dtype == torch.float8_e4m3fn
    toks = rng.integers(1, 259, (B, 32)).astype(np.int32)
    lens = np.array([20, 32], np.int32)
    _, jpool = jl.prefill_paged_cold(jp, jc, jnp.asarray(toks), jpool, jnp.asarray(table),
                                     jnp.asarray(lens))
    tl.prefill_paged_cold(tp, tc, torch.from_numpy(toks), tpool, torch.from_numpy(table),
                          torch.from_numpy(lens))
    step = rng.integers(1, 259, (B, 1)).astype(np.int32)
    _, jpool = jl.decode_step_paged(jp, jc, jnp.asarray(step), jpool, jnp.asarray(table),
                                    jnp.asarray(lens))
    tl.decode_step_paged(tp, tc, torch.from_numpy(step), tpool, torch.from_numpy(table),
                         torch.from_numpy(lens))
    np.testing.assert_array_equal(tpool["kv"].view(torch.uint8).numpy(),
                                  np.asarray(jpool["kv"]).view(np.uint8))


ENGINE = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64))


def engines(family: str, seed: int = 0, **kw):
    """(JAX engine, port engine on the CPU) on one set of weights."""
    jc, tc, jp, tp = model(family, seed, **kw)
    je = jcore.Engine(jc, jp, JByteTokenizer(), jcore.EngineConfig(**ENGINE))
    te = tcore.Engine(tc, tp, ByteTokenizer(), tcore.EngineConfig(**ENGINE), device="cpu")
    return je, te


def _greedy(engine, sp_cls, prompt, n):
    req = engine.submit(prompt, sp_cls(temperature=0.0, max_tokens=n, logprobs=True))
    toks = []
    while True:
        ev = req.out.get(timeout=120)
        if ev[0] == "token" and ev[1] >= 0:
            toks.append((ev[1], ev[4]))
        elif ev[0] == "done":
            return toks
        elif ev[0] == "error":
            raise RuntimeError(ev[1])


# A prompt inside the largest bucket and one prefilled in chunks of it.
PROMPTS = {"short": [256] + list(b"Hello there"),
           "chunked": [256] + [(i * 11) % 250 + 1 for i in range(100)]}


def check_engine_greedy(family: str, n: int = 16, **kw) -> None:
    je, te = engines(family, **kw)
    je.start()
    te.start()
    try:
        for name, prompt in PROMPTS.items():
            ref = _greedy(je, JSP, prompt, n)
            got = _greedy(te, TSP, prompt, n)
            assert_same_greedy(got, ref, f"{family} {name}")
    finally:
        je.stop()
        te.stop()
