"""Infinity engine pod generator (embeddings / rerank).

Port of kubeai_tpu/controller/engines/infinity.py: the JAX package's code,
its imports in this package.

Parity: internal/modelcontroller/engine_infinity.go:12-167 — env-driven
(INFINITY_MODEL_ID etc.), served under the Model's name.
"""

from __future__ import annotations

from kubeai_tpu_torch.api.core_types import Container, Pod
from kubeai_tpu_torch.controller.engines.common import (
    MODEL_PORT,
    ModelPodConfig,
    base_pod,
    default_probes,
)


def infinity_pod_for_model(model, cfg: ModelPodConfig) -> Pod:
    src = cfg.source
    if src.scheme == "hf":
        model_ref = src.huggingface_repo
    elif src.scheme == "file":
        model_ref = src.local_path  # mounted at the same path
    else:
        model_ref = "/model"
    if cfg.cache_mount_path:
        model_ref = cfg.cache_mount_path
    env = {
        "INFINITY_MODEL_ID": model_ref,
        "INFINITY_SERVED_MODEL_NAME": model.meta.name,
        "INFINITY_PORT": str(MODEL_PORT),
        "INFINITY_URL_PREFIX": "/v1",
    }
    container = Container(env=env, args=list(model.spec.args))
    default_probes(container, startup_seconds=3600)
    return base_pod(model, cfg, container)
