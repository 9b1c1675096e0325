"""LoRA adapters across a Model's replicas (port of
kubeai_tpu/controller/adapters.py).

The desired set (``spec.adapters``) is compared with each ready pod's
``adapter.kubeai.org/<name>`` labels, whose values hash the adapter's
URL (xxh64); a missing or changed adapter is loaded through the engine's
route and recorded in the labels (which the load balancer routes by), a
removed one unloaded. The native engine stages an adapter's source
itself; vLLM pods get the download sidecar (``patch_loader_sidecar``).
"""

from __future__ import annotations

import logging

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_POD, Container, Pod, Volume, VolumeMount, pod_is_ready
from kubeai_tpu_torch.api.model_types import Model
from kubeai_tpu_torch.controller.engineclient import EngineClient
from kubeai_tpu_torch.runtime.store import NotFound, Store
from kubeai_tpu_torch.utils.xxh import xxh64

log = logging.getLogger("kubeai_tpu_torch.adapters")


def url_hash(url: str) -> str:
    return f"{xxh64(url) & 0xFFFFFFFF:08x}"


def pod_addr(pod: Pod, allow_override: bool = True) -> str | None:
    ip = pod.status.pod_ip
    if allow_override:
        ip = pod.meta.annotations.get(mt.ANNOTATION_MODEL_POD_IP, ip)
    if not ip:
        return None
    port = pod.meta.annotations.get(mt.ANNOTATION_MODEL_POD_PORT, "8000")
    return f"{ip}:{port}"


class AdapterReconciler:
    def __init__(self, store: Store, client: EngineClient | None = None, allow_override: bool = True):
        self.store = store
        self.client = client or EngineClient()
        self.allow_override = allow_override

    def reconcile(self, model: Model, pods: list[Pod]) -> None:
        """Converge every ready pod's loaded adapters to the spec
        (ref: reconcileAdapters, adapters.go:24-118)."""
        desired = {a.name: a.url for a in model.spec.adapters}
        for pod in pods:
            if not pod_is_ready(pod):
                continue
            addr = pod_addr(pod, self.allow_override)
            if addr is None:
                continue
            current = {
                k[len(mt.LABEL_ADAPTER_PREFIX) :]: v
                for k, v in pod.meta.labels.items()
                if k.startswith(mt.LABEL_ADAPTER_PREFIX)
            }
            changed = False
            for name, url in desired.items():
                want_hash = url_hash(url)
                if current.get(name) == want_hash:
                    continue
                try:
                    if name in current:
                        # URL changed: the engine holds the old weights
                        # under this name — drop them before reloading.
                        self.client.unload_lora_adapter(addr, name)
                    self.client.load_lora_adapter(addr, name, url)
                except Exception as e:
                    log.warning("load adapter %s on %s failed: %s", name, addr, e)
                    continue
                current[name] = want_hash
                changed = True
            for name in list(current):
                if name not in desired:
                    try:
                        self.client.unload_lora_adapter(addr, name)
                    except Exception as e:
                        log.warning("unload adapter %s on %s failed: %s", name, addr, e)
                        continue
                    del current[name]
                    changed = True
            if changed:
                self._set_labels(pod, current)

    def _set_labels(self, pod: Pod, adapters: dict[str, str]) -> None:
        def mutate(p):
            for k in list(p.meta.labels):
                if k.startswith(mt.LABEL_ADAPTER_PREFIX):
                    del p.meta.labels[k]
            for name, h in adapters.items():
                p.meta.labels[mt.LABEL_ADAPTER_PREFIX + name] = h

        try:
            self.store.mutate(KIND_POD, pod.meta.name, mutate, pod.meta.namespace)
        except NotFound:
            pass

    def patch_loader_sidecar(self, pod: Pod, model: Model) -> None:
        """vLLM pods get the download sidecar + shared emptyDir the
        reference uses (ref: patchServerAdapterLoader, adapters.go:171-220);
        the native engine stages adapter sources itself."""
        if model.spec.engine != mt.ENGINE_VLLM:
            return
        pod.spec.volumes.append(Volume(name="adapters", empty_dir=True))
        server = pod.spec.containers[0]
        server.volume_mounts.append(VolumeMount(name="adapters", mount_path="/adapters"))
        loader = Container(
            name="adapter-loader",
            image=pod.spec.containers[0].image,
            command=["sleep", "infinity"],
            volume_mounts=[VolumeMount(name="adapters", mount_path="/adapters")],
        )
        pod.spec.containers.append(loader)
