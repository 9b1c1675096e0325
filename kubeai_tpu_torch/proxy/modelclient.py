"""Model lookup + scaling operations.

Port of kubeai_tpu/proxy/modelclient.py: the JAX package's code,
its imports in this package.

Parity: internal/modelclient (client.go:22-73, scale.go:14-100) — 404/400
lookup semantics with adapter validation, request-triggered 0->1
scale-from-zero, autoscaler-driven Scale with min/max clamp and the
consecutive-scale-down gate.
"""

from __future__ import annotations

import threading

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.proxy.apiutils import APIError
from kubeai_tpu_torch.runtime.store import NotFound, Store


class ModelClient:
    def __init__(self, store: Store, namespace: str = "default", required_consecutive_scale_downs=None):
        self.store = store
        self.namespace = namespace
        self._lock = threading.Lock()
        # model -> consecutive scale-down decision count
        # (ref: scale.go consecutiveScaleDowns map)
        self._consecutive_scale_downs: dict[str, int] = {}
        self._required_consecutive = required_consecutive_scale_downs or (lambda m: 3)

    def lookup_model(self, model_name: str, adapter: str, selectors: dict[str, str]) -> mt.Model:
        try:
            model = self.store.get(mt.KIND_MODEL, model_name, self.namespace)
        except NotFound:
            raise APIError(404, f"model {model_name!r} not found")
        for k, v in selectors.items():
            if model.meta.labels.get(k) != v:
                raise APIError(404, f"model {model_name!r} does not match selector {k}={v}")
        if adapter and not any(a.name == adapter for a in model.spec.adapters):
            raise APIError(404, f"model {model_name!r} has no adapter {adapter!r}")
        return model

    def list_all_models(self) -> list[mt.Model]:
        return self.store.list(mt.KIND_MODEL, self.namespace)

    def scale_at_least_one_replica(self, model: mt.Model) -> None:
        """Request-triggered 0->1 (ref: scale.go:14-39): only when
        autoscaling is enabled and current replicas == 0."""
        if model.spec.autoscaling_disabled:
            return
        # Disaggregated models get the kick too: their pools are floored
        # at 1 so the spec.replicas mutation is a harmless no-op for the
        # role planner — but on topologies where disaggregation is
        # ignored (multi-host slice gangs), spec.replicas IS the driver
        # and skipping here would break scale-from-zero entirely.
        try:
            def mutate(m):
                if (m.spec.replicas or 0) == 0:
                    m.spec.replicas = 1

            self.store.mutate(mt.KIND_MODEL, model.meta.name, mutate, self.namespace)
        except NotFound:
            pass

    @staticmethod
    def _decision(desired: int, applied: bool, reason: str, clamped=None, current=None, replicas=None, n=None, required=None) -> dict:
        """The audit-record shape every scale decision returns — one
        builder so unified and per-pool records can never drift."""
        return {
            "desired": desired,
            "clamped": clamped,
            "current": current,
            "replicas": replicas if replicas is not None else current,
            "applied": applied,
            "reason": reason,
            "consecutive_scale_downs": n,
            "required_consecutive": required,
        }

    def _gated_apply(self, gate_key: str, model: mt.Model, desired: int, clamped: int, current: int, mutate) -> dict:
        """The shared scale policy (ref: scale.go:43-100): scale-up
        applies immediately; scale-down only after N consecutive
        decisions (check-then-increment — it fires on the (required+1)th
        and keeps firing until a non-scale-down decision resets the
        counter, keyed by *gate_key* so pools gate independently)."""
        n = required = None
        if clamped < current:
            with self._lock:
                n = self._consecutive_scale_downs.get(gate_key, 0)
                required = self._required_consecutive(model)
                if n < required:
                    self._consecutive_scale_downs[gate_key] = n + 1
                    return self._decision(
                        desired, False, "scale_down_deferred",
                        clamped=clamped, current=current,
                        n=n + 1, required=required,
                    )
        else:
            with self._lock:
                self._consecutive_scale_downs[gate_key] = 0
            if clamped == current:
                return self._decision(
                    desired, False, "no_change", clamped=clamped, current=current
                )
        try:
            self.store.mutate(mt.KIND_MODEL, model.meta.name, mutate, self.namespace)
        except NotFound:
            return self._decision(
                desired, False, "model_not_found", clamped=clamped, current=current
            )
        return self._decision(
            desired, True,
            "scaled_down" if clamped < current else "scaled_up",
            clamped=clamped, current=current, replicas=clamped,
            n=n, required=required,
        )

    def scale(self, model_name: str, desired: int) -> dict:
        """Autoscaler-driven scale (ref: scale.go:43-100): clamped to
        [minReplicas, maxReplicas], applied through the shared gate.
        Returns the decision detail the autoscaler's audit log records
        (existing callers that ignore the return value are unaffected)."""
        try:
            model = self.store.get(mt.KIND_MODEL, model_name, self.namespace)
        except NotFound:
            return self._decision(desired, False, "model_not_found")
        s = model.spec
        clamped = max(desired, s.min_replicas)
        if s.max_replicas is not None:
            clamped = min(clamped, s.max_replicas)

        def mutate(m):
            m.spec.replicas = clamped

        return self._gated_apply(
            model_name, model, desired, clamped, s.replicas or 0, mutate
        )

    def scale_pool(self, model_name: str, role: str, desired: int) -> dict:
        """Per-pool scale for a disaggregated model: the same gate as
        scale() keyed per pool (a draining decode pool cannot reset the
        prefill pool's counter), clamped to [1, maxPool] and applied to
        the disaggregation spec fields the controller plans each pool
        from."""
        from kubeai_tpu_torch.disagg import ROLE_PREFILL, pool_max_replicas, pool_replicas

        try:
            model = self.store.get(mt.KIND_MODEL, model_name, self.namespace)
        except NotFound:
            return self._decision(desired, False, "model_not_found")
        dz = model.spec.disaggregation
        if not dz.enabled:
            return self._decision(desired, False, "not_disaggregated")
        clamped = max(desired, 1)  # pools never scale to zero (v1)
        cap = pool_max_replicas(dz, role)
        if cap is not None:
            clamped = min(clamped, cap)

        def mutate(m):
            if role == ROLE_PREFILL:
                m.spec.disaggregation.prefill_replicas = clamped
            else:
                m.spec.disaggregation.decode_replicas = clamped

        return self._gated_apply(
            f"{model_name}/{role}", model, desired, clamped,
            pool_replicas(dz, role), mutate,
        )
