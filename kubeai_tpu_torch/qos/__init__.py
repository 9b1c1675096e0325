"""The engine's side of multi-tenant QoS (port of kubeai_tpu/qos): the
class lattice and header names, the class-aware admission queue, and the
``kubeai_qos_*`` metrics. The proxy's resolution rules, the preemption
marker's detector, the storm incident trigger and ``/debug/qos`` stay
operator-side and are not ported."""

from kubeai_tpu_torch.qos.classes import (
    CLASSES,
    DEFAULT_CLASS,
    PREEMPTIBLE_HEADER,
    PRIORITY_HEADER,
    normalize_priority,
    rank,
)
from kubeai_tpu_torch.qos.queue import QoSQueue
from kubeai_tpu_torch.qos.stats import record_admitted, record_preemption

__all__ = [
    "CLASSES",
    "DEFAULT_CLASS",
    "PREEMPTIBLE_HEADER",
    "PRIORITY_HEADER",
    "QoSQueue",
    "normalize_priority",
    "rank",
    "record_admitted",
    "record_preemption",
]
