"""The port's Llama forward (kubeai_tpu_torch.models.llama) against the JAX
package's on the same weights (converted by params_from_jax) and the same
tokens: cold prefill (a 256 bucket, so the flash gate opens), a chunked
prefill at start > 0 and decode steps under both decode kernels, with the
kernel flags off (gather path) and on (the kernels' plain versions on the
CPU). float32 tiny config; logits within 1e-4 (float32 matmul summation
order over two layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(**kw):
    jc = JMC(
        vocab_size=272, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, dtype="float32", max_position=2048, **kw,
    )
    tc = TMC(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(JMC)})
    return jc, tc


@pytest.fixture(scope="module")
def model():
    jc, tc = _configs(rope_theta=500000.0)
    jp = jl.init_params(jc, jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernels"])
def test_paged_forward_matches_jax(model, kernels):
    jc, tc, jp, tp = model
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


def test_cacheless_forward_matches_jax(model):
    jc, tc, jp, tp = model
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 259, (2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jlog, _ = jl.apply(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
    tlog, _ = tl.apply(tp, tc, torch.from_numpy(toks), torch.from_numpy(np.array(pos)))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


def test_params_from_jax_moves_bf16_bits_exactly():
    jc, tc = _configs()
    jp = jl.init_params(jc.replace(dtype="bfloat16"), jax.random.key(1))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tree, tc, "cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["wq"].shape == tuple(tree["layers"]["wq"].shape)  # [L, in, out]
    np.testing.assert_array_equal(
        tp["embed"].view(torch.int16).numpy(), tree["embed"].view(np.int16)
    )
    np.testing.assert_array_equal(
        tp["lm_head"].float().numpy(), tree["lm_head"].astype(np.float32)
    )


def test_params_from_jax_refuses_int8_leaves():
    jc, tc = _configs()
    tree = {"embed": {"int8_q": np.zeros((4, 4), np.int8), "int8_s": np.ones((4, 1), np.float32)}}
    with pytest.raises(NotImplementedError, match="W8A16"):
        params_from_jax(tree, tc, "cpu")


@pytest.mark.parametrize(
    "kw",
    [dict(qkv_bias=True), dict(num_experts=4), dict(sliding_window=8),
     dict(attn_softcap=30.0), dict(kv_cache_dtype="int8")],
)
def test_unported_variants_raise(kw):
    _, tc = _configs(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.init_paged_cache(tc, 4, 16, "cpu")


def test_init_params_is_seeded():
    _, tc = _configs()
    a = tl.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    b = tl.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["layers"]["wd"], b["layers"]["wd"])
    assert a["layers"]["wq"].shape == (2, 128, 128) and a["lm_head"].shape == (128, 272)


def test_lora_and_ring_attention_raise(model):
    _, tc, _, tp = model
    toks = torch.zeros((1, 4), dtype=torch.int64)
    pos = torch.arange(4)[None]
    for kw in (dict(lora={}), dict(ring_mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tl.apply(tp, tc, toks, pos, **kw)
