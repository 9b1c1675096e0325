"""Shared pod-construction helpers for engine generators.

Port of kubeai_tpu/controller/engines/common.py: the JAX package's code,
its imports in this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import Container, Pod, Probe
from kubeai_tpu_torch.config.system import ResourceProfile, SecretNames
from kubeai_tpu_torch.controller.model_source import (
    ModelSource,
    apply_source_to_container,
    source_pod_additions,
)

MODEL_PORT = 8000


@dataclass
class ModelPodConfig:
    """Resolved per-model pod inputs (parity: getModelConfig,
    ref: internal/modelcontroller/model_controller.go:257-319)."""

    source: ModelSource
    image: str
    profile: ResourceProfile
    profile_count: int  # multiplier from "<profile>:<count>"
    secrets: SecretNames = field(default_factory=SecretNames)
    cache_mount_path: str = ""  # set when the model has a cacheProfile


def base_pod(model, cfg: ModelPodConfig, container: Container) -> Pod:
    """Assemble the pod skeleton: labels, scheduling fields from the
    resource profile multiplied by count, source credentials, model port."""
    pod = Pod()
    pod.meta.namespace = model.meta.namespace
    pod.meta.labels = {
        mt.LABEL_MODEL: model.meta.name,
        **{k: v for k, v in model.meta.labels.items() if k.startswith(mt.LABEL_FEATURE_PREFIX)},
    }
    pod.meta.owner_uids = [model.meta.uid]

    container.name = "server"
    container.image = cfg.image
    container.ports = [MODEL_PORT]
    # Profile resources multiplied by count
    # (ref: model_controller.go:289-301).
    for k, v in cfg.profile.requests.items():
        container.resources_requests[k] = _mul_quantity(v, cfg.profile_count)
    for k, v in cfg.profile.limits.items():
        container.resources_limits[k] = _mul_quantity(v, cfg.profile_count)

    pod.spec.node_selector = dict(cfg.profile.node_selector)
    pod.spec.tolerations = list(cfg.profile.tolerations)
    pod.spec.affinity = dict(cfg.profile.affinity)
    pod.spec.scheduler_name = cfg.profile.scheduler_name
    pod.spec.runtime_class_name = cfg.profile.runtime_class_name
    pod.spec.priority_class_name = model.spec.priority_class_name

    add = source_pod_additions(cfg.source, cfg.secrets)
    apply_source_to_container(add, pod, container)
    container.env.update(model.spec.env)
    pod.spec.containers.append(container)
    return pod


def default_probes(container: Container, startup_seconds: int = 10800, ready_path: str = "/health"):
    """vLLM-style probes: 3h startup allowance for big weight loads
    (ref: engine_vllm.go:101-138). *ready_path* lets engines with a real
    readiness route (the framework's engine's /readyz: engine loop down,
    draining, parked/attaching, degraded gang) probe it; third-party
    images keep /health."""
    container.startup_probe = Probe(
        path="/health", port=MODEL_PORT, failure_threshold=startup_seconds // 10,
        period_seconds=10,
    )
    container.readiness_probe = Probe(path=ready_path, port=MODEL_PORT, period_seconds=5)
    container.liveness_probe = Probe(
        path="/health", port=MODEL_PORT, period_seconds=10, failure_threshold=6
    )


_QUANTITY_SUFFIXES = (
    "Ei", "Pi", "Ti", "Gi", "Mi", "Ki",  # binary
    "E", "P", "T", "G", "M", "k", "K", "m",  # decimal (+legacy "K", milli "m")
)


def _mul_quantity(q: str, n: int) -> str:
    """Multiply a k8s-style quantity string by an integer count.
    Handles the full suffix set and fractional values ("0.5Gi" x 3 ->
    "1.5Gi"); raises on unparseable quantities rather than silently
    under-requesting resources (ref: model_controller.go:289-301
    multiplies via apimachinery's exact Quantity arithmetic)."""
    if n == 1:
        return q
    from decimal import Decimal, InvalidOperation

    s = q.strip()
    num, sfx = s, ""
    for suffix in _QUANTITY_SUFFIXES:
        if s.endswith(suffix):
            num, sfx = s[: -len(suffix)], suffix
            break
    try:
        val = Decimal(num) * n
    except InvalidOperation:
        raise ValueError(f"unparseable resource quantity {q!r}") from None
    text = format(val, "f")
    if "." in text:
        text = text.rstrip("0").rstrip(".")
    return f"{text}{sfx}"
