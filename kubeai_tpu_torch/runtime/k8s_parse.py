"""Kubernetes manifest dicts -> our workload dataclasses (inverse of
runtime.k8s_manifests). Used by the cluster store adapter to decode
apiserver responses.

Port of kubeai_tpu/runtime/k8s_parse.py: the JAX package's code,
its imports in this package.
"""

from __future__ import annotations

from typing import Any

from kubeai_tpu_torch.api.core_types import (
    PVC,
    ConfigMap,
    Container,
    Job,
    JobStatus,
    Pod,
    PodSpec,
    PodStatus,
    Probe,
    PVCSpec,
    Secret,
    Volume,
    VolumeMount,
)
from kubeai_tpu_torch.runtime.store import ObjectMeta


def parse_meta(doc: dict[str, Any]) -> ObjectMeta:
    m = doc.get("metadata", {}) or {}
    ts = m.get("creationTimestamp")
    created = 0.0
    if ts:
        import calendar
        import time as _time

        try:
            created = calendar.timegm(_time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
        except ValueError:
            pass
    deletion = m.get("deletionTimestamp")
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", "default"),
        labels=m.get("labels", {}) or {},
        annotations=m.get("annotations", {}) or {},
        uid=m.get("uid", ""),
        creation_time=created,
        resource_version=int(m.get("resourceVersion", 0) or 0),
        owner_uids=[o.get("uid", "") for o in m.get("ownerReferences", []) or []],
        finalizers=m.get("finalizers", []) or [],
        deletion_timestamp=1.0 if deletion else None,
    )


def parse_probe(doc: dict | None) -> Probe | None:
    if not doc:
        return None
    p = Probe(
        period_seconds=doc.get("periodSeconds", 10),
        failure_threshold=doc.get("failureThreshold", 3),
        timeout_seconds=doc.get("timeoutSeconds", 3),
        initial_delay_seconds=doc.get("initialDelaySeconds", 0),
    )
    if "httpGet" in doc:
        p.path = doc["httpGet"].get("path", "/")
        try:
            p.port = int(doc["httpGet"].get("port", 8000))
        except (TypeError, ValueError):
            pass  # named port (e.g. "http") on a foreign pod; keep default
    elif "exec" in doc:
        cmd = doc["exec"].get("command", [])
        p.path = "exec:" + (cmd[-1] if cmd else "")
    return p


def parse_container(doc: dict[str, Any]) -> Container:
    env = {e["name"]: e.get("value", "") for e in doc.get("env", []) or []}
    for ef in doc.get("envFrom", []) or []:
        name = (ef.get("secretRef") or {}).get("name")
        if name:
            env[f"__envFromSecret_{name}"] = name
    res = doc.get("resources", {}) or {}
    return Container(
        name=doc.get("name", ""),
        image=doc.get("image", ""),
        command=doc.get("command", []) or [],
        args=doc.get("args", []) or [],
        env=env,
        ports=[p.get("containerPort") for p in doc.get("ports", []) or []],
        resources_requests=res.get("requests", {}) or {},
        resources_limits=res.get("limits", {}) or {},
        volume_mounts=[
            VolumeMount(
                name=m.get("name", ""),
                mount_path=m.get("mountPath", ""),
                sub_path=m.get("subPath", ""),
                read_only=m.get("readOnly", False),
            )
            for m in doc.get("volumeMounts", []) or []
        ],
        startup_probe=parse_probe(doc.get("startupProbe")),
        readiness_probe=parse_probe(doc.get("readinessProbe")),
        liveness_probe=parse_probe(doc.get("livenessProbe")),
    )


def parse_pod_spec(doc: dict[str, Any]) -> PodSpec:
    volumes = []
    for v in doc.get("volumes", []) or []:
        vol = Volume(name=v.get("name", ""))
        if "emptyDir" in v:
            vol.empty_dir = True
        elif "persistentVolumeClaim" in v:
            vol.pvc_name = v["persistentVolumeClaim"].get("claimName", "")
        elif "configMap" in v:
            vol.config_map_name = v["configMap"].get("name", "")
        elif "hostPath" in v:
            vol.host_path = v["hostPath"].get("path", "")
        volumes.append(vol)
    return PodSpec(
        containers=[parse_container(c) for c in doc.get("containers", []) or []],
        init_containers=[parse_container(c) for c in doc.get("initContainers", []) or []],
        volumes=volumes,
        node_selector=doc.get("nodeSelector", {}) or {},
        tolerations=doc.get("tolerations", []) or [],
        affinity=doc.get("affinity", {}) or {},
        scheduler_name=doc.get("schedulerName", ""),
        runtime_class_name=doc.get("runtimeClassName", ""),
        priority_class_name=doc.get("priorityClassName", ""),
        service_account_name=doc.get("serviceAccountName", ""),
        restart_policy=doc.get("restartPolicy", "Always"),
        subdomain=doc.get("subdomain", ""),
        hostname=doc.get("hostname", ""),
    )


def parse_pod(doc: dict[str, Any]) -> Pod:
    status_doc = doc.get("status", {}) or {}
    conditions = {c.get("type"): c.get("status") for c in status_doc.get("conditions", []) or []}
    return Pod(
        meta=parse_meta(doc),
        spec=parse_pod_spec(doc.get("spec", {}) or {}),
        status=PodStatus(
            phase=status_doc.get("phase", "Pending"),
            pod_ip=status_doc.get("podIP", ""),
            ready=conditions.get("Ready") == "True",
            scheduled=conditions.get("PodScheduled") == "True",
        ),
    )


def parse_job(doc: dict[str, Any]) -> Job:
    status = doc.get("status", {}) or {}
    template_spec = ((doc.get("spec", {}) or {}).get("template", {}) or {}).get("spec", {}) or {}
    return Job(
        meta=parse_meta(doc),
        spec=parse_pod_spec(template_spec),
        backoff_limit=(doc.get("spec", {}) or {}).get("backoffLimit", 3),
        status=JobStatus(
            succeeded=status.get("succeeded", 0) or 0,
            failed=status.get("failed", 0) or 0,
        ),
    )


def parse_pvc(doc: dict[str, Any]) -> PVC:
    spec = doc.get("spec", {}) or {}
    return PVC(
        meta=parse_meta(doc),
        spec=PVCSpec(
            storage_class_name=spec.get("storageClassName", ""),
            access_modes=spec.get("accessModes", []) or [],
            storage=((spec.get("resources", {}) or {}).get("requests", {}) or {}).get("storage", ""),
        ),
    )


def parse_configmap(doc: dict[str, Any]) -> ConfigMap:
    return ConfigMap(meta=parse_meta(doc), data=doc.get("data", {}) or {})


def parse_secret(doc: dict[str, Any]) -> Secret:
    """A real apiserver returns base64 .data; our own manifests carry
    .stringData — accept both (stringData wins on key collision, same
    as the apiserver's write semantics)."""
    import base64

    data: dict[str, str] = {}
    for k, v in (doc.get("data", {}) or {}).items():
        try:
            data[k] = base64.b64decode(v).decode()
        except Exception:
            data[k] = v
    data.update(doc.get("stringData", {}) or {})
    return Secret(meta=parse_meta(doc), data=data)
