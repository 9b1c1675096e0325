"""A kube-apiserver and a kubelet for running the operator's cluster path on
one machine, without a cluster: the REST subset and the watch stream that
``runtime/k8s.py``'s KubeStore speaks, and a kubelet that runs the Pods the
apiserver holds as local processes.

``APIServer`` serves namespaced collections under ``/api/v1`` and
``/apis/<group>/<version>`` over HTTP on loopback:

- GET of one object or of a collection (``labelSelector=k=v,...``; the
  collection's resourceVersion in the list's metadata), also across
  namespaces (``/api/v1/pods``);
- ``?watch=true&resourceVersion=N``: the events after N replayed from the
  history, then the live ones, as chunked JSON lines; a start below the
  compacted history (``compact()``) gets an in-stream 410 ERROR;
- POST (409 AlreadyExists), PUT (409 Conflict on a stale
  resourceVersion; a main-resource PUT keeps the stored status, the
  ``/status`` subresource changes only the status), DELETE;
- finalizers (a delete sets ``deletionTimestamp``; the object goes when
  an update empties its finalizers) and the garbage collector's
  background cascade over ``ownerReferences``;
- a Secret's ``stringData`` stored base64-encoded in ``data``.

It counts requests as an authorizer reads them (``requests_by``): by
(user, verb, API group, resource or ``resource/subresource``,
namespaced or not), the user being the request's bearer token ("" without
one); ``requests`` sums them by verb (``get``, ``list``, ``watch``,
``create``, ``update``, ``delete``). It also counts the 409 answers
(``conflicts``) and the events written to watch streams. Give each client's KubeStore its own token (the
Manager's one, the kubelet's another) and :func:`refused_by_role` tells
which of a user's requests a rendered RBAC Role would have refused.

``Kubelet`` is LocalRuntime over a KubeStore on that apiserver: each Pod
it is told of runs from the manifest the apiserver holds (the decoded
command, args and env), with LocalRuntime's port rewrite, readiness probe
and restarts. A Pod's status is the kubelet's to write, and KubeStore
drops a Pod's status on update, so the kubelet writes it (phase, the
Ready and PodScheduled conditions, podIP) and the pod's port annotation
straight into the apiserver's object, with a MODIFIED event. It runs
Pods only: a Job is left to a real cluster.

Usage (a Python caller; chip_smoke's ``kube`` run)::

    api = APIServer()
    mgr = Manager(system, store=KubeStore(api_server=api.url, token="operator"))
    kubelet = Kubelet(api, KubeStore(api_server=api.url, token="kubelet"))
    mgr.start(); kubelet.start()
    ...
    kubelet.stop(); mgr.stop(); api.stop()
    refused_by_role(role, api.requests_of("operator"))  # [] under the chart's Role
"""

from __future__ import annotations

import base64
import copy
import datetime
import json
import queue
import threading
import uuid
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.runtime.local import LocalRuntime


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _route(path: str) -> tuple[str | None, str, str | None, str | None]:
    """(namespace or None, plural, name, subresource) of an API path."""
    parts = path.split("?")[0].strip("/").split("/")
    # /api/v1/... or /apis/<group>/<version>/...
    rest = parts[2:] if parts[0] == "api" else parts[3:]
    ns = None
    if rest and rest[0] == "namespaces":
        ns, rest = rest[1], rest[2:]
    plural = rest[0]
    name = rest[1] if len(rest) > 1 else None
    sub = rest[2] if len(rest) > 2 else None
    return ns, plural, name, sub


_VERBS = {"POST": "create", "PUT": "update", "DELETE": "delete"}


def request_key(method: str, path: str) -> tuple[str, str, str, bool]:
    """(verb, API group, resource or ``resource/subresource``, namespaced)
    of a request, as an RBAC authorizer reads it: a GET is ``get`` with a
    name, else ``watch`` with ``watch=true``, else ``list``."""
    ns, plural, name, sub = _route(path)
    parts = path.split("?")[0].strip("/").split("/")
    group = "" if parts[0] == "api" else parts[1]
    if method == "GET":
        watch = parse_qs(urlparse(path).query).get("watch") == ["true"]
        verb = "get" if name else "watch" if watch else "list"
    else:
        verb = _VERBS[method]
    return verb, group, plural + (f"/{sub}" if sub else ""), ns is not None


def refused_by_role(role: dict, keys) -> list[tuple[str, str, str, bool]]:
    """The request keys (:func:`request_key`) among *keys* that no rule of
    the RBAC Role document *role* grants. A Role grants namespaced
    requests only (in its own namespace); ``*`` matches any group,
    resource or verb."""
    out = []
    for verb, group, resource, namespaced in sorted(set(keys)):
        ok = namespaced and any(
            ({group, "*"} & set(rule.get("apiGroups") or ()))
            and ({resource, "*"} & set(rule.get("resources") or ()))
            and ({verb, "*"} & set(rule.get("verbs") or ()))
            for rule in role.get("rules") or ())
        if not ok:
            out.append((verb, group, resource, namespaced))
    return out


class APIServer:
    """The REST subset and the watch stream (see the module docstring)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        # (namespace, plural) -> name -> document
        self.objects: dict[tuple[str, str], dict[str, dict]] = {}
        self.rv = 0
        # plural -> [(rv, type, document)]; compact() drops it.
        self.history: dict[str, list[tuple[int, str, dict]]] = {}
        self.min_rv = 0
        # (user, verb, group, resource, namespaced) -> count
        self.requests_by: Counter = Counter()
        self.conflicts = 0
        self.watch_events = 0
        self._watchers: list[tuple[str, str | None, queue.Queue]] = []
        self._lock = threading.RLock()
        self._stopped = threading.Event()
        self.httpd = ThreadingHTTPServer((host, port), _handler(self))
        self.httpd.daemon_threads = True
        self.url = f"http://{host}:{self.httpd.server_port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, args=(0.05,),
                                        name="apiserver", daemon=True)
        self._thread.start()

    @property
    def requests(self) -> Counter:
        """Every user's requests counted by verb."""
        out: Counter = Counter()
        with self._lock:
            for (_, verb, *_), n in self.requests_by.items():
                out[verb] += n
        return out

    def requests_of(self, user: str) -> set[tuple[str, str, str, bool]]:
        """The (verb, group, resource, namespaced) keys *user* sent."""
        with self._lock:
            return {k[1:] for k in self.requests_by if k[0] == user}

    # -- the store ---------------------------------------------------------

    def get(self, plural: str, name: str, namespace: str = "default") -> dict | None:
        """A copy of the stored document, or None."""
        with self._lock:
            doc = self.objects.get((namespace, plural), {}).get(name)
            return copy.deepcopy(doc) if doc is not None else None

    def kubelet_update(self, plural: str, name: str, edit, namespace: str = "default") -> bool:
        """Apply *edit(document)* to the stored object in place (the
        kubelet's status write), with a new resourceVersion and a MODIFIED
        event. False when the object is gone."""
        with self._lock:
            doc = self.objects.get((namespace, plural), {}).get(name)
            if doc is None:
                return False
            edit(doc)
            self._bump(doc)
            self._emit(namespace, plural, "MODIFIED", doc)
        return True

    def compact(self) -> None:
        """Drop the event history (etcd's compaction): a watch from a
        resourceVersion older than the current one gets 410 Gone."""
        with self._lock:
            self.history.clear()
            self.min_rv = self.rv

    def drop_watches(self) -> None:
        """End every open watch stream, as an apiserver's watch timeout
        does: a client resumes from its last resourceVersion."""
        with self._lock:
            watchers, self._watchers = self._watchers, []
        for _, _, q in watchers:
            q.put(None)

    def stop(self) -> None:
        """End every watch stream and stop serving."""
        self._stopped.set()
        self.drop_watches()
        self.httpd.shutdown()
        self.httpd.server_close()

    def _bump(self, doc: dict) -> None:
        self.rv += 1
        doc["metadata"]["resourceVersion"] = str(self.rv)

    def _emit(self, ns: str, plural: str, type_: str, doc: dict) -> None:
        snap = copy.deepcopy(doc)
        self.history.setdefault(plural, []).append(
            (int(snap["metadata"]["resourceVersion"]), type_, snap))
        for wplural, wns, q in self._watchers:
            if wplural == plural and wns in (None, ns):
                q.put({"type": type_, "object": snap})

    def _create(self, ns: str, plural: str, doc: dict) -> tuple[int, dict]:
        meta = doc.setdefault("metadata", {})
        name = meta.get("name")
        objs = self.objects.setdefault((ns, plural), {})
        if not name:
            return 422, {"kind": "Status", "reason": "Invalid", "code": 422}
        if name in objs:
            return 409, {"kind": "Status", "reason": "AlreadyExists", "code": 409,
                         "message": f"{plural} {name!r} already exists"}
        meta["namespace"] = ns
        meta["uid"] = str(uuid.uuid4())
        meta["creationTimestamp"] = _now()
        meta.pop("deletionTimestamp", None)
        if plural == "models":
            doc.pop("status", None)  # the status subresource's
        if plural == "secrets" and "stringData" in doc:
            data = doc.setdefault("data", {})
            for k, v in doc.pop("stringData").items():
                data[k] = base64.b64encode(v.encode()).decode()
        self._bump(doc)
        objs[name] = doc
        self._emit(ns, plural, "ADDED", doc)
        return 201, doc

    def _update(self, ns: str, plural: str, name: str, sub: str | None,
                doc: dict) -> tuple[int, dict]:
        objs = self.objects.get((ns, plural), {})
        cur = objs.get(name)
        if cur is None:
            return 404, {"kind": "Status", "reason": "NotFound", "code": 404}
        sent = (doc.get("metadata") or {}).get("resourceVersion")
        if sent and sent != cur["metadata"]["resourceVersion"]:
            return 409, {"kind": "Status", "reason": "Conflict", "code": 409,
                         "message": "the object has been modified"}
        if sub == "status":
            new = copy.deepcopy(cur)
            new["status"] = doc.get("status", {})
        else:
            new = doc
            meta = new.setdefault("metadata", {})
            for key in ("uid", "creationTimestamp", "deletionTimestamp", "namespace"):
                if key in cur["metadata"]:
                    meta[key] = cur["metadata"][key]
            # A main-resource PUT never changes the status.
            new.pop("status", None)
            if "status" in cur:
                new["status"] = cur["status"]
            if plural == "secrets" and "stringData" in new:
                data = new.setdefault("data", {})
                for k, v in new.pop("stringData").items():
                    data[k] = base64.b64encode(v.encode()).decode()
        self._bump(new)
        objs[name] = new
        if new["metadata"].get("deletionTimestamp") and not new["metadata"].get("finalizers"):
            self._remove(ns, plural, name)
        else:
            self._emit(ns, plural, "MODIFIED", new)
        return 200, new

    def _delete(self, ns: str, plural: str, name: str) -> tuple[int, dict]:
        cur = self.objects.get((ns, plural), {}).get(name)
        if cur is None:
            return 404, {"kind": "Status", "reason": "NotFound", "code": 404}
        if cur["metadata"].get("finalizers"):
            if not cur["metadata"].get("deletionTimestamp"):
                cur["metadata"]["deletionTimestamp"] = _now()
                self._bump(cur)
                self._emit(ns, plural, "MODIFIED", cur)
            return 200, cur
        self._remove(ns, plural, name)
        return 200, {"kind": "Status", "status": "Success"}

    def _remove(self, ns: str, plural: str, name: str) -> None:
        doc = self.objects[(ns, plural)].pop(name)
        self._bump(doc)
        self._emit(ns, plural, "DELETED", doc)
        # The garbage collector's background cascade.
        uid = doc["metadata"].get("uid")
        for (ons, oplural), objs in list(self.objects.items()):
            for oname, odoc in list(objs.items()):
                refs = odoc["metadata"].get("ownerReferences") or []
                if ons == ns and any(r.get("uid") == uid for r in refs):
                    self._delete(ons, oplural, oname)

    def _list(self, ns: str | None, plural: str, selector: dict) -> dict:
        items = [copy.deepcopy(d) for (ons, op), objs in self.objects.items()
                 if op == plural and ns in (None, ons) for d in objs.values()]
        items = [d for d in items if all(
            (d["metadata"].get("labels") or {}).get(k) == v for k, v in selector.items())]
        return {"kind": "List", "items": items, "metadata": {"resourceVersion": str(self.rv)}}


def _handler(api: APIServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _send(self, code: int, obj: dict) -> None:
            if code == 409:
                api.conflicts += 1
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _count(self) -> None:
            auth = self.headers.get("Authorization") or ""
            user = auth[len("Bearer "):] if auth.startswith("Bearer ") else ""
            with api._lock:
                api.requests_by[(user, *request_key(self.command, self.path))] += 1

        def _body(self) -> dict:
            return json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")

        def _chunk(self, payload: dict) -> None:
            data = json.dumps(payload).encode() + b"\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _watch(self, ns: str | None, plural: str, start_rv: int) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            q: queue.Queue = queue.Queue()
            with api._lock:
                if start_rv and start_rv < api.min_rv:
                    self._chunk({"type": "ERROR", "object": {
                        "kind": "Status", "code": 410, "reason": "Expired"}})
                    api.watch_events += 1
                    self.wfile.write(b"0\r\n\r\n")
                    return
                for rv, type_, doc in api.history.get(plural, []):
                    if rv > start_rv and ns in (None, doc["metadata"].get("namespace")):
                        q.put({"type": type_, "object": doc})
                api._watchers.append((plural, ns, q))
            try:
                while not api._stopped.is_set():
                    try:
                        ev = q.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    if ev is None:
                        break
                    self._chunk(ev)
                    api.watch_events += 1
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass  # the client went away
            finally:
                with api._lock:
                    api._watchers = [w for w in api._watchers if w[2] is not q]
            self.close_connection = True

        def do_GET(self):
            self._count()
            ns, plural, name, _ = _route(self.path)
            qs = parse_qs(urlparse(self.path).query)
            if qs.get("watch") == ["true"]:
                rv = int((qs.get("resourceVersion") or ["0"])[0] or 0)
                return self._watch(ns, plural, rv)
            with api._lock:
                if name:
                    doc = api.objects.get((ns, plural), {}).get(name)
                    if doc is None:
                        return self._send(404, {"kind": "Status", "reason": "NotFound",
                                                "code": 404})
                    return self._send(200, doc)
                sel = {}
                for part in (qs.get("labelSelector") or [""])[0].split(","):
                    if "=" in part:
                        k, v = part.split("=", 1)
                        sel[k] = v
                out = api._list(ns, plural, sel)
            self._send(200, out)

        def do_POST(self):
            self._count()
            ns, plural, _, _ = _route(self.path)
            doc = self._body()
            with api._lock:
                code, out = api._create(ns or "default", plural, doc)
            self._send(code, out)

        def do_PUT(self):
            self._count()
            ns, plural, name, sub = _route(self.path)
            doc = self._body()
            with api._lock:
                code, out = api._update(ns or "default", plural, name, sub, doc)
            self._send(code, out)

        def do_DELETE(self):
            self._count()
            ns, plural, name, _ = _route(self.path)
            with api._lock:
                code, out = api._delete(ns or "default", plural, name)
            self._send(code, out)

    return Handler


class Kubelet(LocalRuntime):
    """LocalRuntime over a KubeStore on *apiserver* whose status writes go
    into the apiserver's objects (see the module docstring)."""

    def __init__(self, apiserver: APIServer, store, namespace: str = "default", **kwargs):
        super().__init__(store, namespace, **kwargs)
        self.apiserver = apiserver

    def _run_job(self, job):
        pass  # Pods only

    def _set_status(self, pod_name: str, phase: str | None = None, ready: bool | None = None,
                    scheduled: bool | None = None, pod_ip: str | None = None,
                    port: int | None = None):
        def condition(status, type_, value):
            conds = [c for c in status.get("conditions", []) if c.get("type") != type_]
            conds.append({"type": type_, "status": "True" if value else "False",
                          "lastTransitionTime": _now()})
            status["conditions"] = conds

        def edit(doc):
            status = doc.setdefault("status", {})
            if phase is not None:
                status["phase"] = phase
            if ready is not None:
                condition(status, "Ready", ready)
            if scheduled is not None:
                condition(status, "PodScheduled", scheduled)
            if pod_ip is not None:
                status["podIP"] = pod_ip
            if port is not None:
                doc["metadata"].setdefault("annotations", {})[
                    mt.ANNOTATION_MODEL_POD_PORT] = str(port)

        self.apiserver.kubelet_update("pods", pod_name, edit, self.namespace)

