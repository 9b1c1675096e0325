"""TPUEngine pod generator of the port: the framework's own engine, which
here is the PyTorch/CUDA engine (counterpart of
kubeai_tpu/controller/engines/tpu.py, ``tpu_engine_pod_for_model``).

``TPUEngine`` keeps its name, so a Model manifest validates and routes the
same in both packages; in this package its pods run
``python -m kubeai_tpu_torch.engine.server`` against ``nvidia.com/gpu``
resources. The tensor-parallel size is the pod's GPUs (``nvidia.com/gpu``
of the resource profile times its count) times ``hosts_per_replica``, as
the JAX generator counts ``google.com/tpu``. Multi-host replicas keep the
JAX controller's bootstrap env: ``TPU_HOSTS_PER_REPLICA`` and
``TPU_SLICE_SUBDOMAIN`` here, ``TPU_WORKER_ID`` and
``TPU_WORKER_HOSTNAMES`` per pod from the controller; the port's server
forms its gang from them. Readiness is the engine's ``/readyz``.
"""

from __future__ import annotations

from kubeai_tpu_torch.api.core_types import Container, Pod
from kubeai_tpu_torch.controller.engines.common import (
    MODEL_PORT,
    ModelPodConfig,
    base_pod,
    default_probes,
)

GPU_RESOURCE = "nvidia.com/gpu"
ENGINE_MODULE = "kubeai_tpu_torch.engine.server"


def cuda_engine_pod_for_model(model, cfg: ModelPodConfig) -> Pod:
    src = cfg.source
    if src.scheme == "hf":
        model_arg = f"hf://{src.huggingface_repo}"
    elif src.scheme == "pvc":
        model_arg = "/model"
    elif src.scheme == "file":
        # A host path reads the same under LocalRuntime (no mounts) and on
        # a cluster (a hostPath volume mounted at the same path).
        model_arg = src.local_path
    elif src.scheme in ("s3", "gs", "oss"):
        # Weights staged to local disk by the loader or the cache.
        model_arg = cfg.cache_mount_path or "/model"
    else:
        raise ValueError(f"TPUEngine does not support {src.scheme}:// sources")
    if cfg.cache_mount_path:
        model_arg = cfg.cache_mount_path

    gpus = int(cfg.profile.requests.get(GPU_RESOURCE, "0") or 0) * cfg.profile_count
    args = [
        "--model", model_arg,
        "--served-model-name", model.meta.name,
        "--port", str(MODEL_PORT),
        "--tensor-parallel-size", str(max(gpus, 1) * max(cfg.profile.hosts_per_replica, 1)),
    ]
    args += list(model.spec.args)

    container = Container(
        command=["python", "-m", ENGINE_MODULE],
        args=args,
        env={"PYTHONUNBUFFERED": "1"},
    )
    default_probes(container, ready_path="/readyz")
    pod = base_pod(model, cfg, container)

    if cfg.profile.hosts_per_replica > 1:
        # One replica spans hosts_per_replica pods; they find each other
        # through the model's headless-service subdomain.
        svc = f"model-{model.meta.name}-slice"
        pod.spec.subdomain = svc
        container.env["TPU_HOSTS_PER_REPLICA"] = str(cfg.profile.hosts_per_replica)
        container.env["TPU_SLICE_SUBDOMAIN"] = svc
    return pod
