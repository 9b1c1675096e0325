"""The port's Mixtral family (sparse MoE FFN) against the JAX package's on
the CPU. moe_mlp against the JAX package's GShard static-capacity
dispatch at capacity factor 16 (nothing dropped) and 0.5 (pairs past an
expert's capacity dropped: the same pairs, as the all-dropped tokens'
zero outputs show), with tied router logits broken toward the lower
expert as jax.lax.top_k breaks them; then the model (4 experts, top 2,
float32, widths of 64, two layers; tests/_torch_families.py): paged
forward logits and pool within 1e-4, an fp8 pool's bytes equal, the
engine's greedy tokens identical, the published config.json read as the
JAX package reads it, and [L, E, D, F] experts converted bit for bit."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.models import llama as jl
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import HF_CONFIGS, ModelConfig as TMC, mixtral_8x7b
from kubeai_tpu_torch.models.convert import params_from_jax

import _torch_families as fam
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


def _moe_inputs(B=3, S=10, D=16, F=24, E=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * sc for s, sc in (
        ((B, S, D), 1.0), ((D, E), 0.5), ((E, D, F), 0.3), ((E, D, F), 0.3), ((E, F, D), 0.3))]


@pytest.mark.parametrize("factor", [16.0, 0.5], ids=["no-drops", "drops"])
def test_moe_mlp_matches_jax(factor):
    x, wr, wg, wu, wd = _moe_inputs()
    want = np.asarray(jl.moe_mlp(*map(jnp.asarray, (x, wr, wg, wu, wd)), 2, factor))
    got = tl.moe_mlp(*map(torch.from_numpy, (x, wr, wg, wu, wd)), 2, factor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    T, E, k = 30, 4, 2
    C = int(np.ceil(k * T / E * factor))
    dropped = np.all(want == 0, axis=-1)
    assert np.array_equal(np.all(got == 0, axis=-1), dropped)
    # 0.5: C = 8 slots per expert for 60 pairs, so later tokens lose both.
    assert (C >= k * T) if factor > 1 else (C * E < k * T and dropped.any())


def test_moe_top_k_ties_pick_the_lower_expert():
    """A router with equal columns: every token ties experts 1 and 2 (and
    3); jax.lax.top_k takes the lower indices, and so must the port."""
    x, wr, wg, wu, wd = _moe_inputs(seed=1)
    wr[:, 2] = wr[:, 1]
    wr[:, 3] = wr[:, 1]
    wr[:, 0] = -10.0 * np.abs(wr[:, 1])  # never chosen first
    want = np.asarray(jl.moe_mlp(*map(jnp.asarray, (x, wr, wg, wu, wd)), 2, 16.0))
    got = tl.moe_mlp(*map(torch.from_numpy, (x, wr, wg, wu, wd)), 2, 16.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernels"])
def test_paged_forward_matches_jax(kernels):
    fam.check_paged_forward("mixtral", kernels)


def test_fp8_pool_bytes_equal_jax():
    fam.check_fp8_pool_bytes("mixtral")


def test_engine_greedy_matches_jax_engine():
    fam.check_engine_greedy("mixtral")


def test_published_config_reads_as_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS["mixtral-8x7b"]))
    jc, tc = JMC.from_json_file(str(tmp_path)), TMC.from_json_file(str(tmp_path))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc) == dataclasses.asdict(mixtral_8x7b())
    assert (tc.num_experts, tc.num_experts_per_tok, tc.moe_capacity_factor) == (8, 2, 2.0)


def test_params_from_jax_converts_experts_bit_exactly():
    jc, tc = fam.configs("mixtral", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jl.init_params(jc, jax.random.key(2)))
    tp = params_from_jax(tree, tc, "cpu")
    L, E, D, F = 2, 4, 64, 128
    for k, shape in (("wr", (L, D, E)), ("wg", (L, E, D, F)), ("wu", (L, E, D, F)),
                     ("wd", (L, E, F, D))):
        assert tuple(tp["layers"][k].shape) == shape and tp["layers"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp["layers"][k].view(torch.int16).numpy(),
                                      tree["layers"][k].view(np.int16))
