"""Priority classes, the headers the proxy stamps and the proxy's
resolution rules (port of kubeai_tpu/qos/classes.py), and the tenant-lane
constants, which obs/tenants.py defines.

Three classes, strictly ordered: interactive > standard > batch. The
proxy resolves a request's class once (``resolve_priority``: header >
body field > tenant default > standard) and stamps it as X-Priority; the
engine parses it leniently (an unknown value serves as standard)."""

from __future__ import annotations

import os

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


def tenant_default_class(tenant: str) -> str:
    """Per-tenant default class from KUBEAI_QOS_TENANT_CLASS, a comma
    list of <hashed-tenant-id>=<class> pairs (the ids /debug/tenants
    reports). Read per call, so it can change without a restart."""
    spec = os.environ.get("KUBEAI_QOS_TENANT_CLASS", "")
    if not spec or not tenant:
        return ""
    for part in spec.split(","):
        key, _, cls = part.strip().partition("=")
        if key == tenant and cls.strip().lower() in _RANK:
            return cls.strip().lower()
    return ""


def resolve_priority(header_value: str, body_value: str, tenant: str) -> str:
    """The proxy's resolution: header > body ``priority`` field > tenant
    default > standard. An explicit value that names no class raises
    ValueError (the proxy answers 400): a typo must not serve silently
    as standard."""
    for value, origin in ((header_value, PRIORITY_HEADER), (body_value, "priority")):
        if value and value.strip():
            got = normalize_priority(value)
            if not got:
                raise ValueError(
                    f"invalid {origin} value {value.strip()!r}: "
                    f"expected one of {', '.join(CLASSES)}"
                )
            return got
    return tenant_default_class(tenant) or DEFAULT_CLASS
