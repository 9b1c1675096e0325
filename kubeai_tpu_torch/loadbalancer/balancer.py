"""LoadBalancer: pod watcher -> per-model endpoint groups.

Port of kubeai_tpu/loadbalancer/balancer.py: the JAX package's code,
its imports in this package.

Parity: internal/loadbalancer/load_balancer.go:53-202 — watches Pods,
keeps a group per model with ready endpoints (address from pod IP or the
model-pod-ip/port override annotations when allowed — the test/dev seam),
adapter sets from pod labels, and tracks KubeAI self-pod IPs for the
autoscaler's peer scrape.
"""

from __future__ import annotations

import logging
import threading

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_POD, Pod, pod_is_ready
from kubeai_tpu_torch.faults import fault
from kubeai_tpu_torch.loadbalancer.group import Endpoint, EndpointGroup
from kubeai_tpu_torch.runtime.store import Store

log = logging.getLogger("kubeai_tpu_torch.loadbalancer")

DEFAULT_PORT = 8000


def pod_endpoint(pod: Pod, allow_override: bool) -> Endpoint | None:
    """Address + adapter set for a ready server pod
    (ref: load_balancer.go:108-137)."""
    ip = pod.status.pod_ip
    port = DEFAULT_PORT
    if allow_override:
        ip = pod.meta.annotations.get(mt.ANNOTATION_MODEL_POD_IP, ip)
    port_ann = pod.meta.annotations.get(mt.ANNOTATION_MODEL_POD_PORT)
    if port_ann:
        port = int(port_ann)
    if not ip:
        return None
    adapters = {
        k[len(mt.LABEL_ADAPTER_PREFIX) :]
        for k in pod.meta.labels
        if k.startswith(mt.LABEL_ADAPTER_PREFIX)
    }
    return Endpoint(
        address=f"{ip}:{port}",
        adapters=adapters,
        # Disaggregated phase role rides the controller-stamped label;
        # "" on unified pods.
        role=pod.meta.labels.get(mt.LABEL_ROLE, ""),
    )


class LoadBalancer:
    def __init__(
        self,
        store: Store,
        allow_pod_address_override: bool = False,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 10.0,
        health_kwargs: dict | None = None,
    ):
        """*health_kwargs* are forwarded verbatim into every
        EndpointGroup — the gray-failure scoring knobs (outlier_k,
        scoring_window, ...) for drills/tests that need windows tighter
        than the env defaults."""
        self.store = store
        self.allow_override = allow_pod_address_override
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.health_kwargs = dict(health_kwargs or {})
        self._groups: dict[str, EndpointGroup] = {}
        self._groups_lock = threading.Lock()
        self._self_ips: list[str] = []
        self._running = False
        self._thread: threading.Thread | None = None

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="loadbalancer", daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        q = self.store.watch(KIND_POD)
        # Initial sync happens via synthetic ADDED events.
        while self._running:
            try:
                ev = q.get(timeout=0.1)
            except Exception:
                continue
            try:
                model = ev.obj.meta.labels.get(mt.LABEL_MODEL)
                if model:
                    self._reconcile_model(model, ev.obj.meta.namespace)
            except Exception:
                log.exception("endpoint reconcile failed")

    def _reconcile_model(self, model_name: str, namespace: str = "default"):
        # Failpoint: chaos tests stall/fail endpoint convergence here
        # (the watcher loop logs and survives injected errors).
        fault("balancer.reconcile")
        pods = self.store.list(KIND_POD, namespace, {mt.LABEL_MODEL: model_name})
        observed: dict[str, Endpoint] = {}
        ranks_ready: dict[str, set[int]] = {}
        gang_size: dict[str, int] = {}
        for pod in pods:
            sid = pod.meta.labels.get("slice-id")
            if sid is not None:
                # Expected gang size comes from the controller-stamped
                # env (NOT the observed pod count: a gang that lost a pod
                # object entirely must still read as incomplete).
                expected = 0
                for c in pod.spec.containers[:1]:
                    expected = int(
                        c.env.get("TPU_HOSTS_PER_REPLICA")
                        or len([h for h in c.env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h])
                        or 0
                    )
                gang_size[sid] = max(gang_size.get(sid, 0), expected, 1)
                if pod_is_ready(pod):
                    ranks_ready.setdefault(sid, set()).add(
                        int(pod.meta.labels.get("slice-rank", "0"))
                    )
        for pod in pods:
            if not pod_is_ready(pod):
                continue
            # Multi-host slice gangs: the replica's address is rank 0's
            # endpoint, and only once the WHOLE gang is ready (a partial
            # gang can't serve — its mesh hasn't formed).
            sid = pod.meta.labels.get("slice-id")
            if sid is not None:
                if pod.meta.labels.get("slice-rank", "0") != "0":
                    continue
                if len(ranks_ready.get(sid, ())) < gang_size.get(sid, 1):
                    continue
            ep = pod_endpoint(pod, self.allow_override)
            if ep is not None:
                observed[pod.meta.name] = ep
        self.group(model_name).reconcile_endpoints(observed)

    def group(self, model_name: str) -> EndpointGroup:
        with self._groups_lock:
            g = self._groups.get(model_name)
            if g is None:
                g = EndpointGroup(
                    breaker_threshold=self.breaker_threshold,
                    breaker_cooldown=self.breaker_cooldown,
                    name=model_name,
                    **self.health_kwargs,
                )
                self._groups[model_name] = g
            return g

    def report_result(self, model_name: str, addr: str, ok: bool, started_at: float | None = None) -> None:
        """Passive-health feed: the proxy reports each attempt's outcome
        so the endpoint breaker ejects consistently-failing endpoints
        BEFORE the pod watcher notices them dying. *started_at* (attempt
        connect time, time.monotonic()) lets the breaker discard stale
        successes from attempts predating an ejection."""
        self.group(model_name).report_result(addr, ok, started_at=started_at)

    def observe_latency(self, model_name: str, addr: str, seconds: float, count: int = 1) -> None:
        """Latency-evidence feed for the gray-failure scorer: the proxy
        reports per-attempt TTFT/latency and the FleetCollector reports
        scrape-delta means (*count* = requests the aggregate covers)."""
        self.group(model_name).observe_latency(addr, seconds, count=count)

    def health_snapshot(self) -> dict[str, dict]:
        """model -> latency-scoring view (/debug/health)."""
        with self._groups_lock:
            groups = dict(self._groups)
        return {name: g.health_snapshot() for name, g in sorted(groups.items())}

    def breaker_snapshot(self) -> dict[str, list[dict]]:
        """model -> per-endpoint breaker states (/debug/endpoints)."""
        with self._groups_lock:
            groups = dict(self._groups)
        return {name: g.breaker_snapshot() for name, g in sorted(groups.items())}

    def routing_snapshot(self) -> dict[str, dict]:
        """model -> CHWBL ring + recent-pick view (/debug/routing)."""
        with self._groups_lock:
            groups = dict(self._groups)
        return {name: g.routing_snapshot() for name, g in sorted(groups.items())}

    # -- proxy interface (ref: load_balancer.go:176-202) -------------------

    def await_best_address(self, req, timeout: float | None = None, cancelled=None, exclude=None):
        """Returns (addr, done_fn). Blocks until an endpoint exists.
        *exclude*: addresses that already failed this request (retries
        prefer fresh endpoints when any exist)."""
        import time as _time

        lb = req.load_balancing
        t0 = _time.monotonic()
        addr, done = self.group(req.model_name).get_best_addr(
            strategy=lb.strategy,
            prefix=req.prefix,
            adapter=req.adapter,
            mean_load_factor=lb.prefix_hash.mean_load_percentage / 100.0,
            timeout=timeout,
            cancelled=cancelled,
            exclude=exclude,
            # Disaggregated phase preference (set per request by the
            # proxy; "" = no preference). A missing pool fails open to
            # the surviving one inside get_best_addr.
            role=getattr(req, "role", ""),
            # QoS class: batch may route to soft-ejected endpoints
            # (degraded-mode bulk tier).
            priority=getattr(req, "priority", ""),
        )
        # Endpoint-pick span (duck-typed obs.SpanBuilder): this wait IS
        # the scale-from-zero cold start when no endpoint exists yet.
        tr = getattr(req, "trace", None)
        if tr is not None:
            try:
                tr.add_span(
                    "endpoint_pick", t0, strategy=lb.strategy, endpoint=addr
                )
            except Exception:  # tracing must never fail routing
                pass
        return addr, done

    def get_all_addresses(self, model_name: str) -> list[str]:
        return self.group(model_name).get_all_addrs()

    def get_endpoint_roles(self, model_name: str) -> dict[str, str]:
        """address -> phase role for the model's endpoints ("" =
        unified) — the fleet collector's role dimension."""
        return self.group(model_name).endpoint_roles()

    def get_self_ips(self) -> list[str]:
        """Ready KubeAI operator pod IPs for autoscaler peer scraping
        (ref: load_balancer.go:68-83). Local mode: empty (self only)."""
        return list(self._self_ips)
