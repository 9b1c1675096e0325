"""Multi-tenant QoS (port of kubeai_tpu/qos): the class lattice, header
names and the proxy's resolution rules (classes.py), the class-aware
admission queue (queue.py), the preemption marker and the proxy's resume
dial (preempt.py), and the ``kubeai_qos_*`` metrics with ``/debug/qos``
(stats.py). The preemption-storm incident trigger is not ported."""

from kubeai_tpu_torch.qos.classes import (
    CLASSES,
    DEFAULT_CLASS,
    PREEMPTIBLE_HEADER,
    PRIORITY_HEADER,
    normalize_priority,
    rank,
    resolve_priority,
    tenant_default_class,
)
from kubeai_tpu_torch.qos.preempt import (
    PREEMPT_FINISH_REASON,
    PreemptResumeError,
    acquire_resume_upstream,
    is_preempt_event,
)
from kubeai_tpu_torch.qos.queue import QoSQueue
from kubeai_tpu_torch.qos.stats import (
    handle_qos_request,
    install_queue,
    record_admitted,
    record_preemption,
    record_resolved,
    record_resume,
    uninstall_queue,
)

__all__ = [
    "CLASSES",
    "DEFAULT_CLASS",
    "PREEMPTIBLE_HEADER",
    "PREEMPT_FINISH_REASON",
    "PRIORITY_HEADER",
    "PreemptResumeError",
    "QoSQueue",
    "acquire_resume_upstream",
    "handle_qos_request",
    "install_queue",
    "is_preempt_event",
    "normalize_priority",
    "rank",
    "record_admitted",
    "record_preemption",
    "record_resolved",
    "record_resume",
    "resolve_priority",
    "tenant_default_class",
    "uninstall_queue",
]
