"""Priority classes and the headers the proxy stamps (port of
kubeai_tpu/qos/classes.py, the engine's side), and the tenant-lane
constants, which obs/tenants.py defines.

Three classes, strictly ordered: interactive > standard > batch. The
proxy resolves a request's class once and stamps it as X-Priority; the
engine parses it leniently (an unknown value serves as standard)."""

from __future__ import annotations

# The proxy's hashed tenant id (TENANT_HEADER) keys a queue's fair lanes.
# Requests without one share the anonymous lane, and tenants past the lane
# cap fold into OTHER.
from kubeai_tpu_torch.obs.tenants import (  # noqa: F401
    ANONYMOUS,
    OTHER,
    TENANT_HEADER,
    sanitize_tenant,
)

CLASSES: tuple[str, ...] = ("interactive", "standard", "batch")
DEFAULT_CLASS = "standard"

# Stamped by the proxy after validation.
PRIORITY_HEADER = "X-Priority"
# Stamped by the proxy only for replayable batch streams with no planned
# handoff: the engine may seize this request's slot mid-decode.
PREEMPTIBLE_HEADER = "X-Preemptible"

_RANK = {c: i for i, c in enumerate(CLASSES)}


def rank(priority: str) -> int:
    """Dequeue order: 0 (interactive) serves before 2 (batch). Unknown
    strings rank with standard."""
    return _RANK.get(priority, _RANK[DEFAULT_CLASS])


def normalize_priority(value: str | None) -> str:
    """The class *value* names (any case, surrounding whitespace
    ignored), else ""."""
    if not value:
        return ""
    v = value.strip().lower()
    return v if v in _RANK else ""
