"""spec.files -> ConfigMap + subPath mounts into the server container.

Port of kubeai_tpu/controller/files.py: the JAX package's code,
its imports in this package.

Parity: internal/modelcontroller/files.go:24-113 — keys are the file path
with '/' mapped to '_', each mounted read-only at its path via subPath.
"""

from __future__ import annotations

from kubeai_tpu_torch.api.core_types import KIND_CONFIGMAP, ConfigMap, Pod, Volume, VolumeMount
from kubeai_tpu_torch.api.model_types import Model
from kubeai_tpu_torch.runtime.store import NotFound, ObjectMeta, Store

FILES_VOLUME = "model-files"


def files_configmap_name(model_name: str) -> str:
    return f"model-{model_name}-files"


def config_map_key(path: str) -> str:
    return path.replace("/", "_")


def ensure_model_files_configmap(store: Store, model: Model) -> None:
    name = files_configmap_name(model.meta.name)
    data = {config_map_key(f.path): f.content for f in model.spec.files}
    try:
        existing = store.get(KIND_CONFIGMAP, name, model.meta.namespace)
        if existing.data != data:
            existing.data = data
            store.update(KIND_CONFIGMAP, existing)
    except NotFound:
        if not model.spec.files:
            return
        cm = ConfigMap(
            meta=ObjectMeta(
                name=name,
                namespace=model.meta.namespace,
                labels={"model": model.meta.name},
                owner_uids=[model.meta.uid],
            ),
            data=data,
        )
        store.create(KIND_CONFIGMAP, cm)


def patch_file_volumes(pod: Pod, model: Model) -> None:
    if not model.spec.files:
        return
    pod.spec.volumes.append(
        Volume(name=FILES_VOLUME, config_map_name=files_configmap_name(model.meta.name))
    )
    server = pod.spec.containers[0]
    for f in model.spec.files:
        server.volume_mounts.append(
            VolumeMount(
                name=FILES_VOLUME,
                mount_path=f.path,
                sub_path=config_map_key(f.path),
                read_only=True,
            )
        )
