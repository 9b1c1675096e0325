"""Lease-based leader election (port of kubeai_tpu/autoscaler/leader.py).

A Lease record in the store, renewed every third of its duration;
``is_leader`` is the flag the autoscaler gates its ticks on. The store's
resource-version conflict check makes the take-over a compare-and-swap.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from kubeai_tpu_torch.runtime.store import AlreadyExists, Conflict, NotFound, ObjectMeta, Store

KIND_LEASE = "Lease"


@dataclass
class Lease:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    renew_time: float = 0.0
    duration_seconds: float = 15.0


class Election:
    def __init__(self, store: Store, identity: str, lease_name: str = "kubeai-tpu.kubeai.org", duration: float = 15.0, namespace: str = "default"):
        self.store = store
        self.identity = identity
        self.lease_name = lease_name
        self.duration = duration
        self.namespace = namespace
        self.is_leader = threading.Event()
        # Set by stop(): the loop waits on it between renewals, so a stop
        # returns at once instead of after the rest of an interval.
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(target=self._loop, name="leader-election", daemon=True)
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread:
            self._thread.join(timeout=5)
        # Release the lease if held.
        if self.is_leader.is_set():
            try:
                self.store.mutate(
                    KIND_LEASE,
                    self.lease_name,
                    lambda l: (setattr(l, "holder", ""), setattr(l, "renew_time", 0.0)),
                    self.namespace,
                )
            except NotFound:
                pass
            self.is_leader.clear()

    def _loop(self):
        interval = self.duration / 3
        while not self._stopped.is_set():
            try:
                self._try_acquire_or_renew()
            except Exception:
                self.is_leader.clear()
            self._stopped.wait(interval)

    def _try_acquire_or_renew(self):
        now = time.time()
        try:
            lease = self.store.get(KIND_LEASE, self.lease_name, self.namespace)
        except NotFound:
            lease = Lease(
                meta=ObjectMeta(name=self.lease_name, namespace=self.namespace),
                holder=self.identity,
                renew_time=now,
                duration_seconds=self.duration,
            )
            try:
                self.store.create(KIND_LEASE, lease)
                self.is_leader.set()
            except AlreadyExists:
                self.is_leader.clear()
            return

        expired = now - lease.renew_time > lease.duration_seconds
        if lease.holder == self.identity or expired or not lease.holder:
            lease.holder = self.identity
            lease.renew_time = now
            try:
                self.store.update(KIND_LEASE, lease)
                self.is_leader.set()
            except Conflict:
                self.is_leader.clear()
        else:
            self.is_leader.clear()
