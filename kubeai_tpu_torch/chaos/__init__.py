"""Seeded chaos campaigns over the port's serving stack (port of
kubeai_tpu/chaos): ``schedule`` (the seeded fault plans), ``campaign``
(the episode loop and its invariants), ``invariants`` (the quiesce and
leak checks), ``shrink`` (ddmin over a schedule) and ``report`` (the
campaign document's schema). ``python -m kubeai_tpu_torch.chaos`` runs
one."""

from .campaign import ChaosCampaign, induced_schedule, stream_request
from .invariants import quiesce_violations
from .report import validate_chaos_doc
from .schedule import FaultEvent, Schedule, generate_schedule, subsystem_of
from .shrink import ddmin

__all__ = [
    "ChaosCampaign",
    "FaultEvent",
    "Schedule",
    "ddmin",
    "generate_schedule",
    "induced_schedule",
    "quiesce_violations",
    "stream_request",
    "subsystem_of",
    "validate_chaos_doc",
]
