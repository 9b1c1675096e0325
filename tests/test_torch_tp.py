"""Tensor parallelism in the port against the JAX package: the port at
tp = 2 (two ranks as two threads, each with its own gloo process group
over one store, parallel/group.py run_local_ranks) against the JAX
package at tp = 2 (a mesh of 2 of conftest's 8 virtual CPU devices) and
at tp = 1.

- every variant of tests/test_sharding_specs.py (llama, qwen2's biases,
  gemma2's tied head, softcaps and windows, mixtral's experts), at the
  level of llama.apply: a paged prefill and a decode step, logits within
  1e-4 in float32, and each rank's pool its KV heads of the JAX pool;
- llama through the whole engine: tests/test_torch_tp_engine.py;
- int8 weights at tp = 2 against the JAX package's int8 at tp = 1, and
  the checkpoint loader's int8 shards: values and scales equal to the
  matching slices of the JAX loader's sharded arrays;
- the divisibility errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import configs, jax_params
from _torch_threads import few_torch_threads  # noqa: F401
from kubeai_tpu.models import llama as jl
from kubeai_tpu.parallel import make_mesh, shard_tree
from kubeai_tpu.parallel.sharding import llama_param_specs, paged_cache_specs
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import ModelConfig as TMC
from kubeai_tpu_torch.models.convert import params_from_jax
from kubeai_tpu_torch.parallel.group import TPGroup, run_local_ranks
from kubeai_tpu_torch.parallel.sharding import check_divisible, shard_params

TOL = dict(rtol=1e-4, atol=1e-4)
TP = 2

# tests/test_sharding_specs.py's variants (its BASE widths), the
# families' seeded biases and norms.
BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, dtype="float32", max_position=2048)
VARIANTS = {
    "llama": {},
    "qwen2": dict(qkv_bias=True),
    "gemma2": dict(post_norms=True, rms_one_offset=True, embed_scale=True,
                   tie_word_embeddings=True, hidden_act="gelu_tanh", attn_softcap=50.0,
                   logit_softcap=30.0, sliding_window=8, sliding_layers="even"),
    "mixtral": dict(num_experts=4, num_experts_per_tok=2),
}


def _model(variant):
    from kubeai_tpu.models.base import ModelConfig as JMC

    jc = JMC(**BASE, **VARIANTS[variant])
    tc = TMC(**dataclasses.asdict(jc))
    jp = jax_params(jc, seed=1)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


def _jax_paged(jp, jc, mesh, toks, table, lens, step, P, ps):
    """JAX logits of a cold paged prefill and a decode step, and the pool
    (sharded over *mesh*'s tp axis when given)."""
    pool = jl.init_paged_cache(jc, P, ps)
    args = [jnp.asarray(a) for a in (toks, table, lens, step)]
    if mesh is None:
        a, pool = jl.prefill_paged_cold(jp, jc, args[0], pool, args[1], args[2])
        b, pool = jl.decode_step_paged(jp, jc, args[3], pool, args[1], args[2])
        return np.asarray(a), np.asarray(b), np.asarray(pool["kv"])
    sharded = shard_tree(jp, llama_param_specs(jc), mesh)
    pool = shard_tree(pool, paged_cache_specs(), mesh)
    with mesh:
        a, pool = jax.jit(lambda p, t, c, tb, ln: jl.prefill_paged_cold(p, jc, t, c, tb, ln))(
            sharded, args[0], pool, args[1], args[2])
        b, pool = jax.jit(lambda p, t, c, tb, ln: jl.decode_step_paged(p, jc, t, c, tb, ln))(
            sharded, args[3], pool, args[1], args[2])
    return np.asarray(a), np.asarray(b), np.asarray(pool["kv"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paged_prefill_and_decode_match_jax_at_tp2_and_tp1(variant, cpu_mesh_devices):
    jc, tc, jp, tparams = _model(variant)
    B, ps, mp = 2, 16, 3
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 255, (B, 32)).astype(np.int32)
    lens = np.array([20, 32], np.int32)
    step = rng.integers(1, 255, (B, 1)).astype(np.int32)
    want1 = _jax_paged(jp, jc, None, toks, table, lens, step, P, ps)
    want2 = _jax_paged(jp, jc, make_mesh(tp=TP), toks, table, lens, step, P, ps)

    def rank(group):
        params = shard_params(tparams, tc, group)
        pool = tl.init_paged_cache(tc, P, ps, "cpu", tp=TP)
        t = [torch.from_numpy(a) for a in (toks, table, lens, step)]
        a, _ = tl.prefill_paged_cold(params, tc, t[0], pool, t[1], t[2], tp_group=group)
        b, _ = tl.decode_step_paged(params, tc, t[3], pool, t[1], t[2], tp_group=group)
        return a.numpy(), b.numpy(), pool["kv"].numpy()

    Kvl = 2 * tc.num_kv_heads // TP  # combined K/V heads per rank
    for r, (a, b, kv) in enumerate(run_local_ranks(TP, rank, "cpu")):
        for want in (want2, want1):
            np.testing.assert_allclose(a, want[0], **TOL)
            np.testing.assert_allclose(b, want[1], **TOL)
        np.testing.assert_allclose(kv, want1[2][:, :, r * Kvl:(r + 1) * Kvl], **TOL)


@pytest.mark.parametrize("variant", ["llama", "qwen2"])
def test_int8_paged_forward_at_tp2_matches_jax_tp1(variant):
    """int8 weights (float32 activations): each rank's shard of the
    quantized tree, its row-parallel scales whole, gives the JAX
    package's int8 logits at tp = 1 within 1e-4. (The JAX package does
    not serve int8 over a mesh: its loader refuses it, and a row-parallel
    weight's [L, 1, out] scales cannot take the split spec.)"""
    from kubeai_tpu.engine.weights import quantize_model_params as jquant
    from kubeai_tpu_torch.engine.weights import quantize_model_params as tquant

    jc, tc, jp, tparams = _model(variant)
    B, ps, mp = 2, 16, 3
    P = 1 + B * mp
    table = np.arange(1, P, dtype=np.int32).reshape(B, mp)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 255, (B, 32)).astype(np.int32)
    lens = np.array([32, 25], np.int32)
    step = rng.integers(1, 255, (B, 1)).astype(np.int32)
    want = _jax_paged(jquant(jp, jc), jc, None, toks, table, lens, step, P, ps)
    qparams = tquant(tparams, tc)

    def rank(group):
        params = shard_params(qparams, tc, group)
        assert params["layers"]["wo"]["int8_s"].shape == qparams["layers"]["wo"]["int8_s"].shape
        pool = tl.init_paged_cache(tc, P, ps, "cpu", tp=TP)
        t = [torch.from_numpy(a) for a in (toks, table, lens, step)]
        a, _ = tl.prefill_paged_cold(params, tc, t[0], pool, t[1], t[2], tp_group=group)
        b, _ = tl.decode_step_paged(params, tc, t[3], pool, t[1], t[2], tp_group=group)
        return a.numpy(), b.numpy()

    for a, b in run_local_ranks(TP, rank, "cpu"):
        np.testing.assert_allclose(a, want[0], **TOL)
        np.testing.assert_allclose(b, want[1], **TOL)


def test_int8_shards_equal_jax_sharded_arrays(tmp_path, cpu_mesh_devices):
    """The checkpoint loader at tp = 2 with int8 (read, pad, quantize at
    full size, keep the rank's slice) against the JAX loader's int8
    arrays placed with the JAX split specs: each rank's values and scales
    equal the matching shard (a row-parallel weight's scales whole)."""
    from kubeai_tpu.engine import weights as jw
    from kubeai_tpu_torch.engine import weights as tw

    jc, tc, jp, tparams = _model("qwen2")
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    sd = tw.hf_state_dict(tparams, tc)
    tw.save_hf_checkpoint(str(tmp_path), tc, sd)
    mesh = make_mesh(tp=TP)
    jparams, _ = jw.stream_params_from_hf(jw.SafetensorsSource(str(tmp_path)), jc, tp=TP,
                                          quantization="int8")
    specs = llama_param_specs(jc)

    def rank(group):
        return tw.stream_params_from_hf(tw.SafetensorsSource(str(tmp_path)), tc, tp=TP,
                                        quantization="int8", device="cpu", tp_group=group)[0]

    def jax_shard(arr, spec, r):
        # The JAX split of this leaf over a tp = 2 mesh (scales of a
        # row-parallel weight have a size-1 split dim: replicated).
        spec = tuple(None if (s == "tp" and arr.shape[i] == 1) else s
                     for i, s in enumerate(spec))
        placed = jax.device_put(arr, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(*spec)))
        shard = [s for s in placed.addressable_shards if s.device == mesh.devices.flat[r]][0]
        return np.asarray(shard.data)

    for r, part in enumerate(run_local_ranks(TP, rank, "cpu")):
        for key in ("wq", "wk", "wo", "wd", "wg", "bq"):
            got, want = part["layers"][key], jparams["layers"][key]
            spec = specs["layers"][key]
            if isinstance(want, dict):
                for k in ("int8_q", "int8_s"):
                    np.testing.assert_array_equal(got[k].numpy(), jax_shard(want[k], spec, r))
            else:
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(jax_shard(want, spec, r), np.float32))
        for k in ("int8_q", "int8_s"):
            np.testing.assert_array_equal(part["embed"][k].numpy(),
                                          jax_shard(jparams["embed"][k], specs["embed"], r))
            np.testing.assert_array_equal(part["lm_head"][k].numpy(),
                                          jax_shard(jparams["lm_head"][k], specs["lm_head"], r))


def test_divisibility_errors():
    _, gemma = configs("gemma")  # one KV head
    with pytest.raises(ValueError, match="must divide the KV heads"):
        check_divisible(gemma, 2)
    with pytest.raises(ValueError, match="must divide the KV heads"):
        tcore.preset_params(tcore.preset_config("gemma-2b", 1), torch.device("cpu"),
                            tp_group=TPGroup(0, 2, "cpu", None, "gloo"))
    tc = TMC(**BASE)
    with pytest.raises(ValueError, match="intermediate_size: .* divisible by 2, but it is "
                                         "equal to 129"):
        check_divisible(tc.replace(intermediate_size=129), 2)
    with pytest.raises(ValueError, match="vocab_size"):
        check_divisible(tc.replace(vocab_size=257), 2)
    with pytest.raises(ValueError, match="must divide the KV heads"):
        tcore.Engine(gemma, None, ByteTokenizer(), device="cpu",
                     tp_group=TPGroup(0, 2, "cpu", None, "gloo"))
