"""The port's Qwen2 family (q/k/v biases) against the JAX package's on the
CPU, at 14 query heads over 2 KV heads: groups of G = 7, which do not
divide 64 (the tensor-core tiles' row count on the card). Float32, widths
of 64, two layers, seeded weights with nonzero biases
(tests/_torch_families.py): paged forward logits and pool within 1e-4
(gather path and kernel gates), an fp8 pool's bytes equal, the engine's
greedy tokens identical, and the published Qwen2.5-7B config.json read
as the JAX package reads it."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import HF_CONFIGS, ModelConfig as TMC, qwen2_5_7b
from kubeai_tpu_torch.models.convert import params_from_jax

import _torch_families as fam
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernels"])
def test_paged_forward_matches_jax(kernels):
    fam.check_paged_forward("qwen2", kernels)


def test_fp8_pool_bytes_equal_jax():
    fam.check_fp8_pool_bytes("qwen2")


def test_engine_greedy_matches_jax_engine():
    fam.check_engine_greedy("qwen2")


def test_biases_reach_the_logits():
    """Zeroing the biases changes the logits: the test weights use them."""
    jc, tc, jp, tp = fam.model("qwen2")
    toks = torch.arange(1, 9)[None]
    pos = torch.arange(8)[None]
    with_b, _ = tl.apply(tp, tc, toks, pos)
    zeroed = {**tp, "layers": {k: torch.zeros_like(v) if k in ("bq", "bk", "bv") else v
                               for k, v in tp["layers"].items()}}
    without, _ = tl.apply(zeroed, tc, toks, pos)
    assert not torch.allclose(with_b, without, atol=1e-3)


def test_published_config_reads_as_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS["qwen2.5-7b"]))
    jc, tc = JMC.from_json_file(str(tmp_path)), TMC.from_json_file(str(tmp_path))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc) == dataclasses.asdict(qwen2_5_7b())
    assert tc.qkv_bias and tc.num_heads // tc.num_kv_heads == 7 and tc.head_dim_ == 128


def test_params_from_jax_converts_biases_bit_exactly():
    jc, tc = fam.configs("qwen2", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, fam.jax_params(jc))
    tp = params_from_jax(tree, tc, "cpu")
    for k in ("bq", "bk", "bv", "wq"):
        assert tp["layers"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp["layers"][k].view(torch.int16).numpy(),
                                      tree["layers"][k].view(np.int16))
