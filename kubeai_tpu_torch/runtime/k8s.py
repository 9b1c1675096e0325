"""KubeStore: the Store interface backed by a kube-apiserver (port of
kubeai_tpu/runtime/k8s.py: the JAX package's code, its imports in this
package).

The control plane (controller, balancer, autoscaler, cache, adapters)
programs against the Store surface; this adapter maps it onto the
Kubernetes REST API, so the same components run in a cluster. Models are
stored as the kubeai.org/v1 CRD (deploy/crds/), workloads as core/v1 and
batch/v1 objects, leader leases as coordination.k8s.io/v1 Lease objects,
and the autoscaler's state as a labelled ConfigMap record.

Transport is stdlib urllib against the in-cluster endpoint (the service
account's bearer token and CA bundle, the namespace file); a watch lists
first, then follows the apiserver's streamed ``?watch=true`` JSON lines
into the same WatchEvent queues the in-memory store gives. No kubernetes
client library.

Only a Model's status is written (through its ``/status`` subresource):
a Pod's or a Job's status is the kubelet's, so ``update`` drops it.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import ssl
import threading
import urllib.error
import urllib.request
from typing import Any, Callable

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import (
    KIND_CONFIGMAP,
    KIND_JOB,
    KIND_POD,
    KIND_PVC,
    KIND_SECRET,
)
from kubeai_tpu_torch.catalog import model_from_manifest
from kubeai_tpu_torch.runtime import k8s_manifests as enc
from kubeai_tpu_torch.runtime import k8s_parse as dec
from kubeai_tpu_torch.runtime.store import (
    AlreadyExists,
    Conflict,
    NotFound,
    WatchEvent,
    match_labels,
)

log = logging.getLogger("kubeai_tpu_torch.kubestore")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

def _ts_encode(t: float) -> str | None:
    """Epoch seconds -> k8s MicroTime (RFC3339, micros)."""
    import datetime

    if not t:
        return None
    return datetime.datetime.fromtimestamp(t, datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ"
    )


def _ts_decode(s: str | None) -> float:
    import datetime

    if not s:
        return 0.0
    return datetime.datetime.strptime(s, "%Y-%m-%dT%H:%M:%S.%fZ").replace(
        tzinfo=datetime.timezone.utc
    ).timestamp()


def _lease_manifest(lease: Any) -> dict:
    """Election's Lease record as a real coordination.k8s.io/v1 Lease
    (the shape the reference's leaderelection library reads/writes,
    ref: internal/leader/election.go:16-64)."""
    spec: dict[str, Any] = {
        "leaseDurationSeconds": int(lease.duration_seconds),
    }
    if lease.holder:
        spec["holderIdentity"] = lease.holder
    rt = _ts_encode(lease.renew_time)
    if rt:
        spec["renewTime"] = rt
    doc = {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {
            "name": lease.meta.name,
            "namespace": lease.meta.namespace,
            "labels": dict(lease.meta.labels or {}),
        },
        "spec": spec,
    }
    return doc


def _parse_lease(doc: dict) -> Any:
    from kubeai_tpu_torch.autoscaler.leader import Lease

    meta = dec.parse_meta(doc)
    spec = doc.get("spec") or {}
    return Lease(
        meta=meta,
        holder=spec.get("holderIdentity") or "",
        renew_time=_ts_decode(spec.get("renewTime")),
        duration_seconds=float(spec.get("leaseDurationSeconds") or 15.0),
    )


# kind -> (api prefix, plural, encoder, decoder)
_KINDS: dict[str, tuple[str, str, Callable, Callable]] = {
    mt.KIND_MODEL: ("/apis/kubeai.org/v1", "models", enc.model_manifest, model_from_manifest),
    KIND_POD: ("/api/v1", "pods", enc.pod_manifest, dec.parse_pod),
    KIND_JOB: ("/apis/batch/v1", "jobs", enc.job_manifest, dec.parse_job),
    KIND_PVC: ("/api/v1", "persistentvolumeclaims", enc.pvc_manifest, dec.parse_pvc),
    KIND_CONFIGMAP: ("/api/v1", "configmaps", enc.configmap_manifest, dec.parse_configmap),
    KIND_SECRET: ("/api/v1", "secrets", enc.secret_manifest, dec.parse_secret),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", _lease_manifest, _parse_lease),
}

# Internal record kinds (AutoscalerState) persist as ConfigMaps — the
# reference stores autoscaler state the same way (ref:
# internal/modelautoscaler/state.go). Leases are NOT records: they are
# real coordination/v1 objects (_KINDS above), matching the RBAC grant.
RECORD_LABEL = "records.kubeai.org/kind"


def _record_types() -> dict[str, Callable[[dict], Any]]:
    from kubeai_tpu_torch.autoscaler.autoscaler import AutoscalerState
    from kubeai_tpu_torch.runtime.store import ObjectMeta

    def build(cls):
        def decode(payload: dict) -> Any:
            meta = ObjectMeta(**payload.pop("meta"))
            return cls(meta=meta, **payload)

        return decode

    return {"AutoscalerState": build(AutoscalerState)}


class KubeStore:
    def __init__(
        self,
        api_server: str | None = None,
        token: str | None = None,
        ca_file: str | None = None,
        namespace: str | None = None,
    ):
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base = api_server or (f"https://{host}:{port}" if host else "http://127.0.0.1:8001")
        self.token = token
        if self.token is None and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                self.token = f.read().strip()
        self.namespace = namespace or self._default_namespace()
        self._ctx: ssl.SSLContext | None = None
        ca = ca_file or (f"{SA_DIR}/ca.crt" if os.path.exists(f"{SA_DIR}/ca.crt") else None)
        if self.base.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca)
        self._watch_threads: list[threading.Thread] = []
        self._watching = True

    @staticmethod
    def _default_namespace() -> str:
        if os.path.exists(f"{SA_DIR}/namespace"):
            with open(f"{SA_DIR}/namespace") as f:
                return f.read().strip()
        return os.environ.get("POD_NAMESPACE", "default")

    # -- REST plumbing -----------------------------------------------------

    def _url(self, kind: str, namespace: str, name: str = "", query: str = "") -> str:
        prefix, plural, _, _ = _KINDS[kind]
        url = f"{self.base}{prefix}/namespaces/{namespace}/{plural}"
        if name:
            url += f"/{name}"
        if query:
            url += f"?{query}"
        return url

    def _request(self, method: str, url: str, body: dict | None = None, content_type: str = "application/json") -> Any:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=30, context=self._ctx) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:300]
            if e.code == 404:
                raise NotFound(f"{method} {url}: {detail}") from None
            if e.code == 409:
                if "AlreadyExists" in detail or method == "POST":
                    raise AlreadyExists(detail) from None
                raise Conflict(detail) from None
            raise RuntimeError(f"{method} {url}: {e.code} {detail}") from None

    # -- record kinds (ConfigMap-backed) -----------------------------------

    def _record_cm_name(self, kind: str, name: str) -> str:
        return f"rec-{kind.lower()}-{name}".replace("_", "-").replace(".", "-")

    def _record_encode(self, kind: str, obj: Any) -> dict:
        import dataclasses

        payload = dataclasses.asdict(obj)
        return {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {
                "name": self._record_cm_name(kind, obj.meta.name),
                "namespace": obj.meta.namespace,
                "labels": {RECORD_LABEL: kind},
            },
            "data": {"payload": json.dumps(payload)},
        }

    def _record_decode(self, kind: str, doc: dict) -> Any:
        payload = json.loads(doc["data"]["payload"])
        obj = _record_types()[kind](payload)
        obj.meta.resource_version = int(doc["metadata"].get("resourceVersion", 0) or 0)
        return obj

    # -- Store interface ---------------------------------------------------

    def create(self, kind: str, obj: Any) -> Any:
        if kind not in _KINDS:
            doc = self._request(
                "POST",
                self._url(KIND_CONFIGMAP, obj.meta.namespace),
                self._record_encode(kind, obj),
            )
            return self._record_decode(kind, doc)
        _, _, encode, decode = _KINDS[kind]
        doc = self._request("POST", self._url(kind, obj.meta.namespace), encode(obj))
        return decode(doc)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        if kind not in _KINDS:
            doc = self._request(
                "GET", self._url(KIND_CONFIGMAP, namespace, self._record_cm_name(kind, name))
            )
            return self._record_decode(kind, doc)
        _, _, _, decode = _KINDS[kind]
        return decode(self._request("GET", self._url(kind, namespace, name)))

    def list(self, kind: str, namespace: str | None = "default", selector: dict[str, str] | None = None) -> list[Any]:
        if kind not in _KINDS:
            # Record kinds: labelSelector'd ConfigMap list.
            cms = self.list(KIND_CONFIGMAP, namespace, {RECORD_LABEL: kind})
            out = []
            for cm in cms:
                obj = self._record_decode(kind, {"data": cm.data, "metadata": {"resourceVersion": cm.meta.resource_version}})
                if match_labels(obj.meta.labels, selector):
                    out.append(obj)
            return out
        _, plural, _, decode = _KINDS[kind]
        query = ""
        if selector:
            query = "labelSelector=" + ",".join(f"{k}%3D{v}" for k, v in selector.items())
        if namespace is None:
            prefix = _KINDS[kind][0]
            url = f"{self.base}{prefix}/{plural}" + (f"?{query}" if query else "")
        else:
            url = self._url(kind, namespace, query=query)
        doc = self._request("GET", url)
        out = []
        for item in doc.get("items", []):
            try:
                out.append(decode(item))
            except Exception as e:
                # One undecodable (foreign) object must not poison the
                # whole control plane.
                log.warning("skipping undecodable %s %s: %s", kind, (item.get("metadata") or {}).get("name"), e)
        return out

    def update(self, kind: str, obj: Any, check_version: bool = True) -> Any:
        if kind not in _KINDS:
            doc = self._record_encode(kind, obj)
            if check_version and obj.meta.resource_version:
                doc["metadata"]["resourceVersion"] = str(obj.meta.resource_version)
            out = self._request(
                "PUT",
                self._url(KIND_CONFIGMAP, obj.meta.namespace, doc["metadata"]["name"]),
                doc,
            )
            return self._record_decode(kind, out)
        _, _, encode, decode = _KINDS[kind]
        doc = encode(obj)
        status = doc.pop("status", None)
        if check_version and obj.meta.resource_version:
            doc["metadata"]["resourceVersion"] = str(obj.meta.resource_version)
        out = self._request("PUT", self._url(kind, obj.meta.namespace, obj.meta.name), doc)
        if status is not None and kind == mt.KIND_MODEL:
            # The Model CRD enables the status subresource: main-resource
            # PUTs strip .status, so status changes go to /status.
            status_doc = {
                "apiVersion": doc["apiVersion"],
                "kind": doc["kind"],
                "metadata": {
                    "name": obj.meta.name,
                    "resourceVersion": out.get("metadata", {}).get("resourceVersion"),
                },
                "status": status,
            }
            try:
                out = self._request(
                    "PUT",
                    self._url(kind, obj.meta.namespace, obj.meta.name) + "/status",
                    status_doc,
                )
            except (NotFound, Conflict):
                pass  # subresource disabled (dev servers) or raced; next
                # reconcile converges status
        return decode(out)

    def mutate(self, kind: str, name: str, fn, namespace: str = "default", retries: int = 10) -> Any:
        for _ in range(retries):
            obj = self.get(kind, name, namespace)
            fn(obj)
            try:
                return self.update(kind, obj)
            except Conflict:
                continue
        raise Conflict(f"{kind} {namespace}/{name}: too many conflicts")

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        if kind not in _KINDS:
            self._request(
                "DELETE",
                self._url(KIND_CONFIGMAP, namespace, self._record_cm_name(kind, name)),
            )
            return
        self._request("DELETE", self._url(kind, namespace, name))

    def delete_all_of(self, kind: str, namespace: str = "default", selector: dict[str, str] | None = None) -> int:
        objs = self.list(kind, namespace, selector)
        for obj in objs:
            try:
                self.delete(kind, obj.meta.name, namespace)
            except NotFound:
                pass
        return len(objs)

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str | None = None) -> "queue.Queue[WatchEvent]":
        """Streamed apiserver watch fanned into a queue, with the
        standard list-then-watch protocol (parity: controller-runtime's
        informer semantics the reference relies on):

        - A fresh LIST emits synthetic ADDED events and pins the
          collection resourceVersion; the watch starts FROM that RV, so
          nothing falls in a list->watch gap.
        - The last delivered RV is tracked; a dropped connection resumes
          from it (no re-list, no event loss).
        - 410 Gone — at connect or as an in-stream ERROR event (the
          apiserver compacted past our RV) — triggers a full re-list;
          consumers are level-triggered and tolerate the repeats.
        """
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        kinds = [kind] if kind else list(_KINDS)
        for k in kinds:
            t = threading.Thread(
                target=self._watch_loop, args=(k, q), name=f"kube-watch-{k}", daemon=True
            )
            t.start()
            self._watch_threads.append(t)
        return q

    def unwatch(self, q) -> None:  # watches die with the process
        pass

    def _relist(self, kind: str, q: "queue.Queue[WatchEvent]") -> str:
        """LIST the collection, emit synthetic ADDED events, return the
        collection resourceVersion to start the watch from."""
        _, _, _, decode = _KINDS[kind]
        list_doc = self._request("GET", self._url(kind, self.namespace))
        for item in list_doc.get("items", []):
            try:
                q.put(WatchEvent("ADDED", kind, decode(item)))
            except Exception:
                continue
        return str((list_doc.get("metadata") or {}).get("resourceVersion") or "0")

    def _watch_loop(self, kind: str, q: "queue.Queue[WatchEvent]"):
        _, _, _, decode = _KINDS[kind]
        import time

        rv: str | None = None  # None => full re-list needed
        while self._watching:
            try:
                if rv is None:
                    rv = self._relist(kind, q)
                url = self._url(
                    kind,
                    self.namespace,
                    query=f"watch=true&resourceVersion={rv}&allowWatchBookmarks=true",
                )
                req = urllib.request.Request(url)
                req.add_header("Accept", "application/json")
                if self.token:
                    req.add_header("Authorization", f"Bearer {self.token}")
                with urllib.request.urlopen(req, timeout=330, context=self._ctx) as resp:
                    for line in resp:
                        if not self._watching:
                            return
                        try:
                            ev = json.loads(line)
                        except json.JSONDecodeError:
                            continue  # partial line; reconnect resumes
                        ev_type = ev.get("type")
                        obj = ev.get("object") or {}
                        if ev_type == "ERROR":
                            if obj.get("code") == 410:
                                # Compacted past our RV: full resync.
                                log.warning("watch %s expired (410); relisting", kind)
                                rv = None
                            else:
                                # Server-side error (e.g. etcd timeout):
                                # back off so a persistent failure can't
                                # become a hot reconnect loop.
                                log.warning("watch %s error event: %s", kind, obj)
                                time.sleep(2)
                            break
                        # Track progress even for undecodable objects so a
                        # reconnect never re-reads past events.
                        new_rv = (obj.get("metadata") or {}).get("resourceVersion")
                        if new_rv:
                            rv = str(new_rv)
                        if ev_type == "BOOKMARK":
                            continue
                        try:
                            q.put(WatchEvent(ev_type, kind, decode(obj)))
                        except Exception:
                            # Undecodable (foreign) object: skip.
                            continue
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    log.warning("watch %s connect got 410 Gone; relisting", kind)
                    rv = None
                elif self._watching:
                    log.warning("watch %s dropped (%s); resuming from rv=%s", kind, e, rv)
                    time.sleep(2)
            except Exception as e:
                if self._watching:
                    log.warning("watch %s dropped (%s); resuming from rv=%s", kind, e, rv)
                time.sleep(2)

    def close(self):
        self._watching = False
