"""Serialization between the workload dataclasses and Kubernetes manifests
(port of kubeai_tpu/runtime/k8s_manifests.py: the JAX package's code, its
imports in this package).

The cluster deployment path: the controller's Pod/PVC/Job/ConfigMap
objects render to real core/v1 + batch/v1 manifests (and Models to the
CRD form of deploy/crds/kubeai.org_models.yaml, kubeai.org/v1). Used by
the cluster store (``runtime/k8s.py``) and by

    python -m kubeai_tpu_torch.runtime.k8s_manifests --models m.yaml
        [--config sys.yaml] [--kinds Pod,Model]

which plans each Model's pods in an in-memory store and prints the
manifests as YAML (inspection, GitOps). A TPUEngine pod of this package
runs ``python -m kubeai_tpu_torch.engine.server`` on ``nvidia.com/gpu``.
"""

from __future__ import annotations

from typing import Any

from kubeai_tpu_torch.api.core_types import PVC, ConfigMap, Container, Job, Pod, Probe, Secret
from kubeai_tpu_torch.api.model_types import Model

GROUP = "kubeai.org"
VERSION = "v1"


def _meta(obj) -> dict[str, Any]:
    m: dict[str, Any] = {"name": obj.meta.name}
    if obj.meta.namespace != "default":
        m["namespace"] = obj.meta.namespace
    if obj.meta.labels:
        m["labels"] = dict(obj.meta.labels)
    if obj.meta.annotations:
        m["annotations"] = dict(obj.meta.annotations)
    if obj.meta.finalizers:
        m["finalizers"] = list(obj.meta.finalizers)
    if obj.meta.owner_uids:
        # The only ownership edge the control plane creates is Model ->
        # workload, and every owned object carries the model label; kube
        # GC then cascades deletes the way the in-memory store does.
        owner_name = obj.meta.labels.get("model", "")
        if owner_name:
            m["ownerReferences"] = [
                {
                    "apiVersion": f"{GROUP}/{VERSION}",
                    "kind": "Model",
                    "name": owner_name,
                    "uid": uid,
                    "controller": True,
                }
                for uid in obj.meta.owner_uids
            ]
    return m


def _probe(p: Probe | None) -> dict | None:
    if p is None:
        return None
    out: dict[str, Any] = {
        "periodSeconds": p.period_seconds,
        "failureThreshold": p.failure_threshold,
        "timeoutSeconds": p.timeout_seconds,
    }
    if p.initial_delay_seconds:
        out["initialDelaySeconds"] = p.initial_delay_seconds
    if p.path.startswith("exec:"):
        out["exec"] = {"command": ["/bin/sh", "-c", p.path[len("exec:") :]]}
    else:
        out["httpGet"] = {"path": p.path, "port": p.port}
    return out


def _container(c: Container) -> dict[str, Any]:
    out: dict[str, Any] = {"name": c.name or "server", "image": c.image}
    if c.command:
        out["command"] = list(c.command)
    if c.args:
        out["args"] = list(c.args)
    env = []
    env_from = []
    for k, v in c.env.items():
        if k.startswith("__envFromSecret_"):
            env_from.append({"secretRef": {"name": v, "optional": True}})
        else:
            env.append({"name": k, "value": v})
    if env:
        out["env"] = env
    if env_from:
        out["envFrom"] = env_from
    if c.ports:
        out["ports"] = [{"containerPort": p} for p in c.ports]
    resources = {}
    if c.resources_requests:
        resources["requests"] = dict(c.resources_requests)
    if c.resources_limits:
        resources["limits"] = dict(c.resources_limits)
    if resources:
        out["resources"] = resources
    if c.volume_mounts:
        out["volumeMounts"] = [
            {
                "name": m.name,
                "mountPath": m.mount_path,
                **({"subPath": m.sub_path} if m.sub_path else {}),
                **({"readOnly": True} if m.read_only else {}),
            }
            for m in c.volume_mounts
        ]
    for attr, key in [
        ("startup_probe", "startupProbe"),
        ("readiness_probe", "readinessProbe"),
        ("liveness_probe", "livenessProbe"),
    ]:
        p = _probe(getattr(c, attr))
        if p:
            out[key] = p
    return out


def _pod_spec(spec) -> dict[str, Any]:
    out: dict[str, Any] = {
        "containers": [_container(c) for c in spec.containers],
    }
    if spec.init_containers:
        out["initContainers"] = [_container(c) for c in spec.init_containers]
    volumes = []
    for v in spec.volumes:
        vol: dict[str, Any] = {"name": v.name}
        if v.empty_dir:
            vol["emptyDir"] = {}
        elif v.pvc_name:
            vol["persistentVolumeClaim"] = {"claimName": v.pvc_name}
        elif v.config_map_name:
            vol["configMap"] = {"name": v.config_map_name}
        elif v.host_path:
            vol["hostPath"] = {"path": v.host_path}
        volumes.append(vol)
    if volumes:
        out["volumes"] = volumes
    if spec.node_selector:
        out["nodeSelector"] = dict(spec.node_selector)
    if spec.tolerations:
        out["tolerations"] = list(spec.tolerations)
    if spec.affinity:
        out["affinity"] = dict(spec.affinity)
    for attr, key in [
        ("scheduler_name", "schedulerName"),
        ("runtime_class_name", "runtimeClassName"),
        ("priority_class_name", "priorityClassName"),
        ("service_account_name", "serviceAccountName"),
        ("subdomain", "subdomain"),
        ("hostname", "hostname"),
    ]:
        val = getattr(spec, attr)
        if val:
            out[key] = val
    if spec.restart_policy != "Always":
        out["restartPolicy"] = spec.restart_policy
    return out


def pod_manifest(pod: Pod) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": _meta(pod),
        "spec": _pod_spec(pod.spec),
    }


def job_manifest(job: Job) -> dict[str, Any]:
    spec = _pod_spec(job.spec)
    spec.setdefault("restartPolicy", "OnFailure")
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": _meta(job),
        "spec": {
            "backoffLimit": job.backoff_limit,
            "template": {"spec": spec},
        },
    }


def pvc_manifest(pvc: PVC) -> dict[str, Any]:
    spec: dict[str, Any] = {
        "accessModes": list(pvc.spec.access_modes),
        "resources": {"requests": {"storage": pvc.spec.storage}},
    }
    if pvc.spec.storage_class_name:
        spec["storageClassName"] = pvc.spec.storage_class_name
    return {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": _meta(pvc),
        "spec": spec,
    }


def configmap_manifest(cm: ConfigMap) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": _meta(cm),
        "data": dict(cm.data),
    }


def secret_manifest(sec: Secret) -> dict[str, Any]:
    # stringData: the apiserver base64-encodes into .data on write, so
    # round-trips through a real cluster come back in .data (see
    # parse_secret).
    return {
        "apiVersion": "v1",
        "kind": "Secret",
        "metadata": _meta(sec),
        "type": "Opaque",
        "stringData": dict(sec.data),
    }


def model_manifest(model: Model) -> dict[str, Any]:
    """Model -> kubeai.org/v1 CRD form (camelCase field names matching
    catalog.model_from_manifest's input, i.e. round-trippable)."""
    s = model.spec
    spec: dict[str, Any] = {"url": s.url, "engine": s.engine, "features": list(s.features)}
    if s.resource_profile:
        spec["resourceProfile"] = s.resource_profile
    if s.cache_profile:
        spec["cacheProfile"] = s.cache_profile
    if s.args:
        spec["args"] = list(s.args)
    if s.env:
        spec["env"] = dict(s.env)
    if s.replicas is not None:
        spec["replicas"] = s.replicas
    if s.min_replicas:
        spec["minReplicas"] = s.min_replicas
    if s.max_replicas is not None:
        spec["maxReplicas"] = s.max_replicas
    if s.autoscaling_disabled:
        spec["autoscalingDisabled"] = True
    if s.target_requests != 100:
        spec["targetRequests"] = s.target_requests
    if s.scale_down_delay_seconds != 30:
        spec["scaleDownDelaySeconds"] = s.scale_down_delay_seconds
    from kubeai_tpu_torch.api.model_types import LoadBalancing

    if s.load_balancing != LoadBalancing():
        ph = s.load_balancing.prefix_hash
        spec["loadBalancing"] = {
            "strategy": s.load_balancing.strategy,
            "prefixHash": {
                "meanLoadPercentage": ph.mean_load_percentage,
                "replication": ph.replication,
                "prefixCharLength": ph.prefix_char_length,
            },
        }
    from kubeai_tpu_torch.api.model_types import Disaggregation

    if s.disaggregation != Disaggregation():
        dz = s.disaggregation
        dz_doc: dict[str, Any] = {
            "enabled": dz.enabled,
            "prefillReplicas": dz.prefill_replicas,
            "decodeReplicas": dz.decode_replicas,
            "handoffTokens": dz.handoff_tokens,
            "prefillTargetQueue": dz.prefill_target_queue,
            "decodeTargetOccupancyPct": dz.decode_target_occupancy_pct,
        }
        if dz.max_prefill_replicas is not None:
            dz_doc["maxPrefillReplicas"] = dz.max_prefill_replicas
        if dz.max_decode_replicas is not None:
            dz_doc["maxDecodeReplicas"] = dz.max_decode_replicas
        spec["disaggregation"] = dz_doc
    if s.adapters:
        spec["adapters"] = [{"name": a.name, "url": a.url} for a in s.adapters]
    if s.files:
        spec["files"] = [{"path": f.path, "content": f.content} for f in s.files]
    if s.priority_class_name:
        spec["priorityClassName"] = s.priority_class_name
    if s.owner:
        spec["owner"] = s.owner
    doc = {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "Model",
        "metadata": _meta(model),
        "spec": spec,
    }
    st = model.status
    if st.replicas_all or st.replicas_ready or st.cache_loaded:
        doc["status"] = {
            "replicas": {"all": st.replicas_all, "ready": st.replicas_ready},
            "cache": {"loaded": st.cache_loaded},
        }
    return doc


MANIFEST_FNS = {
    "Pod": pod_manifest,
    "Job": job_manifest,
    "PersistentVolumeClaim": pvc_manifest,
    "ConfigMap": configmap_manifest,
    "Secret": secret_manifest,
    "Model": model_manifest,
}


def render_store(store, kinds=None) -> str:
    """All objects of the given kinds in a store -> multi-doc YAML."""
    import yaml

    docs = []
    for kind, fn in MANIFEST_FNS.items():
        if kinds and kind not in kinds:
            continue
        for obj in store.list(kind, namespace=None):
            docs.append(fn(obj))
    return yaml.safe_dump_all(docs, sort_keys=False)


def main(argv=None) -> None:
    """Plan the pods of the Models in ``--models`` (the reconciler over an
    in-memory store, without a runtime) and print every object as YAML."""
    import argparse

    from kubeai_tpu_torch.catalog import apply_manifest_file
    from kubeai_tpu_torch.config.system import System, load_system_config
    from kubeai_tpu_torch.controller.controller import ModelReconciler
    from kubeai_tpu_torch.runtime.store import Store

    parser = argparse.ArgumentParser("kubeai-tpu-torch-manifests")
    parser.add_argument("--models", required=True, help="YAML file of Model manifests")
    parser.add_argument("--config", default=None, help="System YAML (default profiles if unset)")
    parser.add_argument("--kinds", default=None, help="comma-separated kinds to print")
    args = parser.parse_args(argv)
    system = load_system_config(args.config) if args.config else System().default_and_validate()
    store = Store()
    reconciler = ModelReconciler(store, system)
    for model in apply_manifest_file(store, args.models):
        # Labels, replica bounds, then the pods: one reconcile each.
        for _ in range(3):
            reconciler.reconcile(model.meta.name, model.meta.namespace)
    kinds = [k.strip() for k in args.kinds.split(",")] if args.kinds else None
    print(render_store(store, kinds), end="")


if __name__ == "__main__":
    main()
