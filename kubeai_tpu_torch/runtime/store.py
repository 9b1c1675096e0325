"""In-process object store with k8s-like semantics (port of
kubeai_tpu/runtime/store.py).

The control plane (controller, load balancer, autoscaler) programs against
this interface; in production it is backed by the kube-apiserver (an
adapter with the same surface), and in tests/local mode by this in-memory
implementation — the same seam the reference gets from envtest (a real
apiserver with no kubelet; ref: test/integration/main_test.go:77-114).

Semantics implemented (the subset the control plane relies on):
- namespaced kinds, metadata (labels/annotations/uid/resourceVersion)
- optimistic concurrency on resourceVersion for update()
- label-selector list
- watch: events (ADDED/MODIFIED/DELETED) fanned out to subscriber queues
- ownerReferences + cascade delete (background propagation)
- finalizers: delete sets deletionTimestamp; object removed when the
  finalizer list empties
"""

from __future__ import annotations

import copy
import queue
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    uid: str = ""
    creation_time: float = 0.0
    resource_version: int = 0
    generation: int = 1
    owner_uids: list[str] = field(default_factory=list)
    finalizers: list[str] = field(default_factory=list)
    deletion_timestamp: float | None = None


class Conflict(Exception):
    """resourceVersion mismatch."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    obj: Any


def match_labels(labels: dict[str, str], selector: dict[str, str] | None) -> bool:
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


class Store:
    """Thread-safe; objects are deep-copied on the way in and out."""

    def __init__(self):
        self._lock = threading.RLock()
        # kind -> (namespace, name) -> object (any object with .meta: ObjectMeta)
        self._objs: dict[str, dict[tuple[str, str], Any]] = {}
        self._watchers: list[tuple[str | None, "queue.Queue[WatchEvent]"]] = []
        self._rv = 0

    # -- helpers -----------------------------------------------------------

    def _bump(self) -> int:
        self._rv += 1
        return self._rv

    def _emit(self, event: WatchEvent):
        for kind, q in self._watchers:
            if kind is None or kind == event.kind:
                q.put(event)

    def watch(self, kind: str | None = None) -> "queue.Queue[WatchEvent]":
        """Subscribe to events for *kind* (None = all). Returns a queue the
        caller drains; includes synthetic ADDED events for existing objects."""
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        with self._lock:
            for k, objs in self._objs.items():
                if kind is None or kind == k:
                    for obj in objs.values():
                        q.put(WatchEvent("ADDED", k, copy.deepcopy(obj)))
            self._watchers.append((kind, q))
        return q

    def unwatch(self, q) -> None:
        with self._lock:
            self._watchers = [(k, w) for k, w in self._watchers if w is not q]

    # -- CRUD --------------------------------------------------------------

    def create(self, kind: str, obj: Any) -> Any:
        with self._lock:
            key = (obj.meta.namespace, obj.meta.name)
            objs = self._objs.setdefault(kind, {})
            if key in objs:
                raise AlreadyExists(f"{kind} {key}")
            import time

            obj = copy.deepcopy(obj)
            obj.meta.uid = obj.meta.uid or uuid.uuid4().hex
            obj.meta.creation_time = obj.meta.creation_time or time.time()
            obj.meta.resource_version = self._bump()
            objs[key] = obj
            self._emit(WatchEvent("ADDED", kind, copy.deepcopy(obj)))
            return copy.deepcopy(obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        with self._lock:
            try:
                return copy.deepcopy(self._objs[kind][(namespace, name)])
            except KeyError:
                raise NotFound(f"{kind} {namespace}/{name}") from None

    def list(
        self,
        kind: str,
        namespace: str | None = "default",
        selector: dict[str, str] | None = None,
    ) -> list[Any]:
        with self._lock:
            out = []
            for (ns, _), obj in self._objs.get(kind, {}).items():
                if namespace is not None and ns != namespace:
                    continue
                if match_labels(obj.meta.labels, selector):
                    out.append(copy.deepcopy(obj))
            return out

    def update(self, kind: str, obj: Any, check_version: bool = True) -> Any:
        with self._lock:
            key = (obj.meta.namespace, obj.meta.name)
            cur = self._objs.get(kind, {}).get(key)
            if cur is None:
                raise NotFound(f"{kind} {key}")
            if check_version and obj.meta.resource_version != cur.meta.resource_version:
                raise Conflict(
                    f"{kind} {key}: version {obj.meta.resource_version} != {cur.meta.resource_version}"
                )
            obj = copy.deepcopy(obj)
            obj.meta.uid = cur.meta.uid
            obj.meta.resource_version = self._bump()
            self._objs[kind][key] = obj
            self._emit(WatchEvent("MODIFIED", kind, copy.deepcopy(obj)))
            # Finalizer protocol: a deleting object whose finalizers have
            # all been removed is actually deleted.
            if obj.meta.deletion_timestamp is not None and not obj.meta.finalizers:
                return self._remove(kind, key)
            return copy.deepcopy(obj)

    def mutate(self, kind: str, name: str, fn: Callable[[Any], None], namespace: str = "default", retries: int = 10) -> Any:
        """Read-modify-write with conflict retry."""
        for _ in range(retries):
            obj = self.get(kind, name, namespace)
            fn(obj)
            try:
                return self.update(kind, obj)
            except Conflict:
                continue
        raise Conflict(f"{kind} {namespace}/{name}: too many conflicts")

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        import time

        with self._lock:
            key = (namespace, name)
            cur = self._objs.get(kind, {}).get(key)
            if cur is None:
                raise NotFound(f"{kind} {key}")
            if cur.meta.finalizers:
                if cur.meta.deletion_timestamp is None:
                    cur.meta.deletion_timestamp = time.time()
                    cur.meta.resource_version = self._bump()
                    self._emit(WatchEvent("MODIFIED", kind, copy.deepcopy(cur)))
                return
            self._remove(kind, key)

    def delete_all_of(self, kind: str, namespace: str = "default", selector: dict[str, str] | None = None) -> int:
        n = 0
        for obj in self.list(kind, namespace, selector):
            try:
                self.delete(kind, obj.meta.name, namespace)
                n += 1
            except NotFound:
                pass
        return n

    def _remove(self, kind: str, key: tuple[str, str]):
        obj = self._objs[kind].pop(key)
        self._emit(WatchEvent("DELETED", kind, copy.deepcopy(obj)))
        # Cascade: delete objects owned by this uid (background propagation).
        owned: list[tuple[str, str, str]] = []
        for k, objs in self._objs.items():
            for (ns, name), o in objs.items():
                if obj.meta.uid in o.meta.owner_uids:
                    owned.append((k, ns, name))
        for k, ns, name in owned:
            try:
                self.delete(k, name, ns)
            except NotFound:
                pass
        return None
