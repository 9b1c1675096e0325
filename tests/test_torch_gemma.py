"""The port's Gemma and Gemma2 families against the JAX package's on the
CPU. Gemma: gelu with tanh, the embedding scaled by sqrt(hidden), 1 + w
norms, a tied head and ONE KV head. Gemma2 adds post norms, attention
and final softcaps, a query scale and a window of 8 on even layers, over
prompts of 256 positions, so the window bites (shown against the same
weights without it). Float32, widths of 64, two layers, seeded weights
(tests/_torch_families.py): paged forward logits and pool within 1e-4
(gather path and kernel gates: Gemma2 takes neither flash nor the paged
kernels, as in the JAX package), an fp8 pool's bytes equal, the engine's
greedy tokens identical, the published config.json files read as the
JAX package reads them, and the 1 + w offset rounded in bf16 as JAX
rounds it."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.ops.norms import rms_norm as j_rms_norm
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.base import HF_CONFIGS, ModelConfig as TMC, gemma2_2b, gemma_2b
from kubeai_tpu_torch.ops.norms import rms_norm

import _torch_families as fam
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("kernels", [False, True], ids=["gather", "kernels"])
@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_paged_forward_matches_jax(family, kernels):
    fam.check_paged_forward(family, kernels)


@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_fp8_pool_bytes_equal_jax(family):
    fam.check_fp8_pool_bytes(family)


@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_engine_greedy_matches_jax_engine(family):
    fam.check_engine_greedy(family)


def test_gemma2_window_bites():
    """Over 64 positions, a window of 8 on the even layer changes the
    logits of every position past the window, and none before it."""
    _, tc, _, tp = fam.model("gemma2")
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, 259, (1, 64)))
    pos = torch.arange(64)[None]
    windowed, _ = tl.apply(tp, tc, toks, pos)
    full, _ = tl.apply(tp, tc.replace(sliding_window=0), toks, pos)
    diff = (windowed - full).abs().amax(dim=-1)[0]
    assert torch.all(diff[:8] == 0) and torch.all(diff[8:] > 1e-4)


def test_gemma2_takes_no_kernel_gate():
    """With both gates on, Gemma2 runs the gather path: the logits equal
    those with both gates off (the plain kernels on the CPU would sum in
    another order and without the window)."""
    _, tc, _, tp = fam.model("gemma2")
    B, ps, mp = 1, 16, 17
    table = torch.arange(1, 1 + mp, dtype=torch.int32)[None]
    toks = torch.from_numpy(np.random.default_rng(6).integers(1, 259, (B, 256)))
    outs = []
    for on in (False, True):
        c = tc.replace(use_flash_prefill=on, use_paged_kernel=on)
        pool = tl.init_paged_cache(c, 1 + mp, ps, "cpu")
        outs.append(tl.prefill_paged_cold(tp, c, toks, pool, table, torch.tensor([256]))[0])
    assert torch.equal(*outs)


@pytest.mark.parametrize("name,maker", [("gemma-2b", gemma_2b), ("gemma2-2b", gemma2_2b)])
def test_published_config_reads_as_jax(tmp_path, name, maker):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    jc, tc = JMC.from_json_file(str(tmp_path)), TMC.from_json_file(str(tmp_path))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc) == dataclasses.asdict(maker())
    assert tc.head_dim_ == 256 and tc.tie_word_embeddings and tc.rms_one_offset


def test_one_offset_rounds_in_bf16_as_jax():
    """1 + w in bf16 rounds (w = 2^-9 is lost next to 1); the port adds it
    in the weight's dtype before the norm, as the JAX package does."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = (rng.normal(size=(64,)) * 0.01).astype(np.float32)
    w[:4] = 2.0**-9
    jw = jnp.asarray(w, jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    want = j_rms_norm(jnp.asarray(x, jnp.bfloat16), jw + 1.0, 1e-6)
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16), tw, 1e-6, offset=1.0)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert float((tw + 1.0)[0]) == 1.0


def test_params_from_jax_converts_post_norms_bit_exactly():
    """Gemma2's ln1b / ln2b (and the tied head's absence) convert key by key."""
    import jax

    from kubeai_tpu_torch.models.convert import params_from_jax

    jc, tc = fam.configs("gemma2", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, fam.jax_params(jc))
    tp = params_from_jax(tree, tc, "cpu")
    assert "lm_head" not in tp
    for k in ("ln1b", "ln2b"):
        assert tp["layers"][k].dtype == torch.bfloat16 and tp["layers"][k].shape == (2, 64)
        np.testing.assert_array_equal(tp["layers"][k].view(torch.int16).numpy(),
                                      tree["layers"][k].view(np.int16))
