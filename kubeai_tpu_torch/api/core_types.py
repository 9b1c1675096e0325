"""Workload object shapes the controller emits (Pod/PVC/Job/ConfigMap).

Port of kubeai_tpu/api/core_types.py: the JAX package's code,
its imports in this package.

Structural subset of the Kubernetes core/v1 and batch/v1 types the
reference controller manipulates (ref: internal/modelcontroller/
engine_*.go pod construction, cache.go PVC/Job protocol). In cluster
mode these serialize 1:1 onto real manifests; in local mode the
LocalRuntime executes them as processes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubeai_tpu_torch.runtime.store import ObjectMeta

KIND_POD = "Pod"
KIND_PVC = "PersistentVolumeClaim"
KIND_JOB = "Job"
KIND_CONFIGMAP = "ConfigMap"
KIND_SECRET = "Secret"


@dataclass
class Probe:
    path: str = "/health"
    port: int = 8000
    initial_delay_seconds: int = 0
    period_seconds: int = 10
    failure_threshold: int = 3
    timeout_seconds: int = 3


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    sub_path: str = ""
    read_only: bool = False


@dataclass
class Volume:
    name: str = ""
    # Exactly one of:
    empty_dir: bool = False
    pvc_name: str = ""
    config_map_name: str = ""
    host_path: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    ports: list[int] = field(default_factory=list)
    resources_requests: dict[str, str] = field(default_factory=dict)
    resources_limits: dict[str, str] = field(default_factory=dict)
    volume_mounts: list[VolumeMount] = field(default_factory=list)
    startup_probe: Probe | None = None
    readiness_probe: Probe | None = None
    liveness_probe: Probe | None = None


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    volumes: list[Volume] = field(default_factory=list)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[dict] = field(default_factory=list)
    affinity: dict = field(default_factory=dict)
    scheduler_name: str = ""
    runtime_class_name: str = ""
    priority_class_name: str = ""
    service_account_name: str = ""
    restart_policy: str = "Always"
    # Multi-host slice gang scheduling (new vs reference — see engines/cuda).
    subdomain: str = ""
    hostname: str = ""


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    pod_ip: str = ""
    ready: bool = False
    scheduled: bool = False


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class PVCSpec:
    storage_class_name: str = ""
    access_modes: list[str] = field(default_factory=lambda: ["ReadWriteMany"])
    storage: str = "10Gi"


@dataclass
class PVC:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PVCSpec = field(default_factory=PVCSpec)


@dataclass
class JobStatus:
    succeeded: int = 0
    failed: int = 0


@dataclass
class Job:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    backoff_limit: int = 3
    status: JobStatus = field(default_factory=JobStatus)


@dataclass
class ConfigMap:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    data: dict[str, str] = field(default_factory=dict)


@dataclass
class Secret:
    """core/v1 Secret (string data only — the controller provisions
    tokens, e.g. the per-gang dispatch-stream secret, and references
    them from pods via envFrom secretRef so the value never appears in
    a pod spec)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    data: dict[str, str] = field(default_factory=dict)


def pod_is_ready(pod: Pod) -> bool:
    return pod.status.ready and pod.meta.deletion_timestamp is None


def job_is_completed(job: Job) -> bool:
    return job.status.succeeded > 0
