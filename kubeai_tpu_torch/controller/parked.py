"""Parked replicas: engine processes started before any Model needs them
(port of kubeai_tpu/controller/parked.py).

The pool keeps ``System.parked_replicas`` pods running
``python -m kubeai_tpu_torch.engine.server --parked``: CUDA up, the
kernel libraries built and loaded for ``parkedArgs``' configuration
(``--park-config``), HTTP serving, /readyz 503. A scale-up of an eligible
Model claims one (POST /v1/attach with the desired pod's args) instead of
spawning a process: the server loads the weights and turns ready, and
the pod is relabelled to the Model at the claim, so the balancer takes it
once it is ready.

Each attach goes to the autoscaler's DecisionLog (``/debug/autoscaler``)
as an ``action: parked_attach`` record. A parked pod serves one Model:
the engine cannot detach, so a scale-down deletes the adopted pod like
any other and the pool tops itself back up.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_POD, Container, Pod, PodSpec
from kubeai_tpu_torch.controller.engines.common import MODEL_PORT
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.runtime.store import Conflict, NotFound, ObjectMeta, Store
from kubeai_tpu_torch import env_float

log = logging.getLogger("kubeai_tpu_torch.parked")

# "true" while waiting in the pool; flipped to "attached" at claim time
# so the pool selector (parked=true) stops seeing the pod.
LABEL_PARKED = "kubeai.org/parked"

M_PARKED_PODS = default_registry.gauge(
    "kubeai_parked_pods",
    "unattached parked replicas currently available in the pool",
)
M_PARKED_ATTACHES = default_registry.counter(
    "kubeai_parked_attaches_total",
    "scale-from-zero replica starts served by attaching a parked pod "
    "instead of cold-spawning, by model",
)


class ParkedPool:
    """Maintains the pool at System.parked_replicas and serves claim()
    to the model reconciler. The reconcile loop is cheap (one store
    list per tick) and self-heals: adopted or deleted pods are replaced
    so the pool is always ready for the next scale-from-zero."""

    def __init__(
        self,
        store: Store,
        system,
        namespace: str = "default",
        decision_log=None,
        interval_seconds: float = 1.0,
        attach_timeout: float = 5.0,
        clock=time.time,
    ):
        self.store = store
        self.system = system
        self.namespace = namespace
        self.decision_log = decision_log
        self.interval = interval_seconds
        self.attach_timeout = attach_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # Forecast-ahead pre-warm: model -> (extra free pods, expiry).
        # TTL'd so a wrong forecast returns the surplus automatically.
        self._prewarm: dict[str, tuple[int, float]] = {}

    # -- predictive pre-warm -----------------------------------------------

    def request_prewarm(
        self,
        extra: int,
        model: str = "",
        ttl_seconds: float = 120.0,
        detail: dict | None = None,
    ) -> int:
        """Ask the pool to hold *extra* additional free pods for an
        expected ramp (obs/forecast.py via the autoscaler). Extras from
        all models are summed into reconcile()'s target, capped by
        KUBEAI_PARKED_PREWARM_MAX; each request refreshes the model's
        TTL. Returns the pool-wide extra now in effect."""
        cap = int(env_float("KUBEAI_PARKED_PREWARM_MAX", 4.0))
        extra = max(int(extra), 0)
        now = self._clock()
        with self._lock:
            prev = self._prewarm.get(model, (0, 0.0))[0]
            if extra <= 0:
                self._prewarm.pop(model, None)
            else:
                self._prewarm[model] = (min(extra, cap), now + ttl_seconds)
            total = self._prewarm_extra(now)
        if extra > prev and self.decision_log is not None:
            self.decision_log.append({
                "t": now,
                "action": "parked_prewarm",
                "source": "forecast",
                "model": model,
                "extra": extra,
                "pool_extra": total,
                "ttl_seconds": ttl_seconds,
                "detail": detail or {},
            })
        self._wake.set()
        return total

    def _prewarm_extra(self, now: float) -> int:
        cap = int(env_float("KUBEAI_PARKED_PREWARM_MAX", 4.0))
        for m in [m for m, (_, exp) in self._prewarm.items() if exp <= now]:
            del self._prewarm[m]
        return min(sum(n for n, _ in self._prewarm.values()), cap)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="parked-pool", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._running = False
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        while self._running:
            try:
                self.reconcile()
            except Exception:
                log.exception("parked pool reconcile failed")
            self._wake.wait(self.interval)
            self._wake.clear()

    # -- pool maintenance --------------------------------------------------

    def _free_pods(self) -> list[Pod]:
        return self.store.list(
            KIND_POD, self.namespace, {LABEL_PARKED: "true"}
        )

    def reconcile(self) -> None:
        free = self._free_pods()
        M_PARKED_PODS.set(len(free))
        with self._lock:
            extra = self._prewarm_extra(self._clock())
        want = int(getattr(self.system, "parked_replicas", 0)) + extra
        for _ in range(want - len(free)):
            self._create()
        for pod in sorted(free, key=lambda p: p.meta.name)[want:]:
            try:
                self.store.delete(KIND_POD, pod.meta.name, self.namespace)
            except NotFound:
                pass
        self._sweep_failed_attaches()

    def _sweep_failed_attaches(self) -> None:
        """Adopted pods whose attach FAILED are stranded scale-ups: the
        claim stamped them with the plan's current pod-hash, so the pod
        planner counts them as an up-to-date replica that is 'still
        starting' and never replaces them. Detect the failure through
        /readyz (attach: failed: ...) and DELETE the pod — the model
        reconciler then creates a normal replica (or claims a fresh
        parked pod)."""
        adopted = self.store.list(
            KIND_POD, self.namespace, {LABEL_PARKED: "attached"}
        )
        for pod in adopted:
            if pod.status.ready:
                continue
            addr = self._pod_addr(pod)
            if addr is None:
                continue
            try:
                with urllib.request.urlopen(
                    f"http://{addr}/readyz", timeout=1
                ) as resp:
                    body = json.loads(resp.read())
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read())
                except Exception:
                    continue
            except Exception:
                continue  # unreachable: the runtime owns process death
            attach = str(body.get("attach", ""))
            # "failed: ..." = the attach thread died; "parked" on an
            # ADOPTED pod = the process crashed mid-attach and was
            # restarted with its original --parked args (claim() flips
            # the state to "attaching" synchronously before adoption,
            # so a legitimate adoptee can never read plain "parked").
            # Both are stranded scale-ups the pod planner will never
            # replace. "attaching" stays in flight.
            if not (attach.startswith("failed") or attach == "parked"):
                continue
            model = pod.meta.labels.get(mt.LABEL_MODEL, "")
            log.warning(
                "parked pod %s attach failed (%s); deleting so model %s "
                "falls back to a normal create", pod.meta.name, attach, model,
            )
            if self.decision_log is not None:
                self.decision_log.append({
                    "t": self._clock(),
                    "model": model,
                    "action": "parked_attach_failed",
                    "pod": pod.meta.name,
                    "error": attach,
                })
            try:
                self.store.delete(KIND_POD, pod.meta.name, self.namespace)
            except NotFound:
                pass

    def _create(self) -> None:
        name = f"parked-{uuid.uuid4().hex[:8]}"
        args = ["--parked", "--port", str(MODEL_PORT)] + [
            str(a) for a in getattr(self.system, "parked_args", [])
        ]
        container = Container(
            name="server",
            command=["python", "-m", "kubeai_tpu_torch.engine.server"],
            args=args,
            env={"PYTHONUNBUFFERED": "1"},
            ports=[MODEL_PORT],
        )
        pod = Pod(
            meta=ObjectMeta(
                name=name,
                namespace=self.namespace,
                labels={LABEL_PARKED: "true"},
            ),
            spec=PodSpec(containers=[container]),
        )
        # On a real cluster a parked pod must still land on the right
        # node with the right resources (a bare pod can neither hold a
        # GPU nor be adopted by a GPU model): parkedResourceProfile
        # ("<profile>:<count>") applies the same scheduling fields model
        # pods get. LocalRuntime ignores these, so it stays optional.
        profile_ref = getattr(self.system, "parked_resource_profile", "")
        if profile_ref:
            pname, _, count_s = profile_ref.rpartition(":")
            pname = pname or profile_ref
            count = int(count_s) if count_s.isdigit() else 1
            profile = self.system.resource_profiles.get(pname)
            if profile is None:
                log.warning("unknown parkedResourceProfile %r", pname)
            else:
                from kubeai_tpu_torch.controller.engines.common import _mul_quantity

                for k, v in profile.requests.items():
                    container.resources_requests[k] = _mul_quantity(v, count)
                for k, v in profile.limits.items():
                    container.resources_limits[k] = _mul_quantity(v, count)
                pod.spec.node_selector = dict(profile.node_selector)
                pod.spec.tolerations = list(profile.tolerations)
                pod.spec.affinity = dict(profile.affinity)
                if profile.image_name:
                    container.image = profile.image_name
        try:
            self.store.create(KIND_POD, pod)
            log.info("parked pool: created %s", name)
        except Conflict:
            pass

    # -- adoption ----------------------------------------------------------

    @staticmethod
    def _pod_addr(pod: Pod) -> str | None:
        ip = pod.status.pod_ip
        if not ip:
            return None
        port = pod.meta.annotations.get(mt.ANNOTATION_MODEL_POD_PORT) or str(MODEL_PORT)
        return f"{ip}:{port}"

    def claim(self, model, desired_pod: Pod) -> Pod | None:
        """Adopt one parked pod for *model*'s scale-up: POST the desired
        pod's engine args to /v1/attach, then relabel the pod to the
        model (incl. the plan's pod-hash label, so the planner treats it
        as current). Returns the adopted pod, or None when no parked pod
        is running/accepting — the caller falls back to a normal create.
        """
        free = [p for p in self._free_pods() if p.status.phase == "Running"]
        args = [str(a) for a in desired_pod.spec.containers[0].args]
        for pod in free:
            addr = self._pod_addr(pod)
            if addr is None:
                continue
            try:
                req = urllib.request.Request(
                    f"http://{addr}/v1/attach",
                    data=json.dumps({"args": args}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=self.attach_timeout) as resp:
                    accepted = resp.status == 202
            except Exception as e:
                log.info("parked pod %s refused attach (%s); trying next", pod.meta.name, e)
                continue
            if not accepted:
                continue
            self._adopt(pod, model, desired_pod)
            M_PARKED_ATTACHES.inc(labels={"model": model.meta.name})
            if self.decision_log is not None:
                self.decision_log.append({
                    "t": self._clock(),
                    "model": model.meta.name,
                    "action": "parked_attach",
                    "pod": pod.meta.name,
                    "addr": addr,
                    "parked_free_remaining": len(free) - 1,
                })
            log.info(
                "scale-from-zero: attached model %s to parked pod %s",
                model.meta.name, pod.meta.name,
            )
            self._wake.set()  # top the pool back up promptly
            return pod
        return None

    def _adopt(self, pod: Pod, model, desired_pod: Pod) -> None:
        expected_hash = desired_pod.meta.labels.get(mt.LABEL_POD_HASH, "")

        def mutate(p):
            p.meta.labels[mt.LABEL_MODEL] = model.meta.name
            # The plan compares pods by hash LABEL, not recomputed spec:
            # stamping the expected hash makes the adopted pod count as
            # current despite its parked-mode spec.
            p.meta.labels[mt.LABEL_POD_HASH] = expected_hash
            p.meta.labels[LABEL_PARKED] = "attached"
            for k, v in desired_pod.meta.labels.items():
                if k.startswith(mt.LABEL_FEATURE_PREFIX):
                    p.meta.labels[k] = v
            p.meta.owner_uids = [model.meta.uid] if model.meta.uid else []
            # Readiness is owned by the runtime's /readyz probe: the
            # attach is in flight, so the pod must read not-ready until
            # the engine actually serves.
            p.status.ready = False

        try:
            self.store.mutate(KIND_POD, pod.meta.name, mutate, self.namespace)
        except NotFound:
            pass
