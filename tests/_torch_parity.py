"""Shared by the port's CPU parity test modules: a JAX engine and a port
engine on the same weights (kubeai_tpu.engine.core.build_test_engine's,
converted by params_from_jax), and the comparison of their greedy tokens.

Where the JAX engine's top two logprobs at a step are closer than
TIE_GAP, float32 summation order may legitimately pick the other token,
so a comparison stops before that step (and says so when it fails)."""

import dataclasses

import jax
import numpy as np

from kubeai_tpu.engine import core as jcore
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.models.base import ModelConfig
from kubeai_tpu_torch.models.convert import params_from_jax

TIE_GAP = 1e-5


def parity_engines(engine_kwargs: dict | None = None, seed: int = 0, jax_model_config=None):
    """(JAX engine, port engine on the CPU), one set of weights; both built
    from the same EngineConfig fields (the package defaults when None)."""
    jec = jcore.EngineConfig(**engine_kwargs) if engine_kwargs is not None else None
    je = jcore.build_test_engine(jec, seed=seed, model_config=jax_model_config)
    mc = ModelConfig(**{f.name: getattr(je.model_config, f.name)
                        for f in dataclasses.fields(ModelConfig)})
    tp = params_from_jax(jax.tree.map(np.asarray, je.params), mc, "cpu")
    tec = tcore.EngineConfig(**engine_kwargs) if engine_kwargs is not None else None
    te = tcore.build_test_engine(tec, seed=seed, device="cpu", params=tp, model_config=mc)
    return je, te


def untied(ref) -> int:
    """Steps of a greedy reference run [(id, top), ...] before its first
    near-tie."""
    for i, (_, top) in enumerate(ref):
        if top and len(top) > 1 and top[0][1] - top[1][1] < TIE_GAP:
            return i
    return len(ref)


def assert_same_greedy(got, ref, what: str = "") -> int:
    """*got* and *ref* ([(id, top), ...]) agree up to *ref*'s first
    near-tie; returns how many steps were compared."""
    upto = untied(ref)
    assert [t for t, _ in got][:upto] == [t for t, _ in ref][:upto], \
        f"{what}: greedy tokens differ (compared {upto} of {len(ref)} steps before a near-tie)"
    return upto
