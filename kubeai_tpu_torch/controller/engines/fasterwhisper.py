"""FasterWhisper engine pod generator (speech-to-text).

Port of kubeai_tpu/controller/engines/fasterwhisper.py: the JAX package's code,
its imports in this package.

Parity: internal/modelcontroller/engine_fasterwhisper.go:12-147 —
configuration is env-driven (WHISPER__MODEL etc.).
"""

from __future__ import annotations

from kubeai_tpu_torch.api.core_types import Container, Pod
from kubeai_tpu_torch.controller.engines.common import (
    MODEL_PORT,
    ModelPodConfig,
    base_pod,
    default_probes,
)


def faster_whisper_pod_for_model(model, cfg: ModelPodConfig) -> Pod:
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
        "WHISPER__MODEL": model_ref,
        "WHISPER__INFERENCE_DEVICE": "auto",
        "WHISPER__PORT": str(MODEL_PORT),
        "ENABLE_UI": "false",
    }
    container = Container(env=env, args=list(model.spec.args))
    default_probes(container, startup_seconds=3600)
    return base_pod(model, cfg, container)
