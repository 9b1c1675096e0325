"""The engine's ``kubeai_qos_*`` metrics (port of kubeai_tpu/qos/stats.py,
same names and help strings). The preemption-storm incident trigger and
``/debug/qos`` are operator-side and not ported."""

from __future__ import annotations

from kubeai_tpu_torch.metrics import default_registry

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
