"""The engine's ``kubeai_qos_*`` metrics and ``GET /debug/qos`` (port of
kubeai_tpu/qos/stats.py, same names and help strings). The
preemption-storm incident trigger and the proxy's counters are
operator-side and not ported."""

from __future__ import annotations

import json

from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.qos.classes import CLASSES

M_DEPTH = default_registry.gauge(
    "kubeai_qos_queue_depth",
    "requests waiting in the engine admission queue, by priority class",
)
M_WAIT = default_registry.histogram(
    "kubeai_qos_queue_wait_seconds",
    "arrival-to-slot-admission wait by priority class (per-class SLO input)",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0),
)
M_REQS = default_registry.counter(
    "kubeai_qos_requests_total",
    "requests accepted into the engine admission queue, by priority class",
)
M_SHED = default_registry.counter(
    "kubeai_qos_shed_total",
    "requests refused (429) by class-aware admission control under "
    "saturation, by priority class — batch sheds first, interactive last",
)
M_BUDGET_DROPS = default_registry.counter(
    "kubeai_qos_budget_drops_total",
    "queued requests dropped because their per-class queue-wait budget "
    "expired before a slot opened, by priority class",
)
M_DEFICIT = default_registry.gauge(
    "kubeai_qos_fair_deficit",
    "deficit-round-robin token balance per tenant lane within a priority "
    "class (bounded lanes; overflow tenants fold into __other__)",
)
M_PREEMPTIONS = default_registry.counter(
    "kubeai_qos_preemptions_total",
    "batch decode slots seized mid-stream to admit a waiting interactive "
    "request",
)
M_PREEMPTED_TOKENS = default_registry.counter(
    "kubeai_qos_preempted_tokens_total",
    "generated tokens discarded at preemption (the deterministic re-run "
    "regenerates them; the proxy's resume cursor dedups the stream)",
)


def record_admitted(priority: str, wait_s: float) -> None:
    """A queued request won a decode slot after *wait_s* in line."""
    M_WAIT.observe(max(wait_s, 0.0), labels={"class": priority})


def record_preemption(generated_tokens: int) -> None:
    """A batch slot was seized after *generated_tokens* tokens."""
    M_PREEMPTIONS.inc()
    M_PREEMPTED_TOKENS.inc(max(int(generated_tokens), 0))


_queue = None  # the live engine's QoSQueue (Engine.start installs it)


def install_queue(q) -> None:
    """Point /debug/qos at the live engine's queue."""
    global _queue
    _queue = q


def uninstall_queue(q) -> None:
    """Identity-checked: a stopped engine must not unhook a newer one's."""
    global _queue
    if _queue is q:
        _queue = None


def qos_snapshot() -> dict:
    doc = {
        "classes": list(CLASSES),
        "preemptions": int(M_PREEMPTIONS.value()),
        "preempted_tokens": int(M_PREEMPTED_TOKENS.value()),
    }
    q = _queue
    if q is not None:
        doc["queue"] = q.snapshot()
    return doc


def handle_qos_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    """GET /debug/qos: per-class depth and sheds, per-tenant fair-share
    deficits and preemption counters of this engine."""
    if path != "/debug/qos":
        return None
    return 200, "application/json", json.dumps(qos_snapshot(), indent=2, sort_keys=True).encode()
