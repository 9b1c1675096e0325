"""The incident trigger seam (port of the install and publish functions of
kubeai_tpu/obs/incidents.py).

Sources (the tenant accountant's flood detector) publish a named trigger;
an installed recorder, any object with ``publish(trigger, model=,
detail=, key=)``, captures it. The incident black box itself lives on
the operator's side and is not ported: in an engine process nothing is
installed, and ``publish_trigger`` does nothing.
"""

from __future__ import annotations

import logging

log = logging.getLogger("kubeai_tpu_torch.incidents")

_recorder = None


def install_recorder(rec) -> None:
    global _recorder
    _recorder = rec


def uninstall_recorder(rec) -> None:
    """Identity-checked: a stopped owner must not clobber a newer
    recorder's installation."""
    global _recorder
    if _recorder is rec:
        _recorder = None


def installed_recorder():
    return _recorder


def publish_trigger(trigger: str, model: str = "", detail: dict | None = None,
                    key: str = "") -> str | None:
    """Fire *trigger* at the installed recorder (nothing happens when none
    is installed). Never raises: a trigger must not break its source's
    hot path. *key* overrides the recorder's debounce key. Returns what
    the recorder's ``publish`` returns (an incident id), else None."""
    rec = _recorder
    if rec is None:
        return None
    try:
        return rec.publish(trigger, model=model, detail=detail, key=key)
    except Exception:
        log.exception("incident trigger %s failed to publish", trigger)
        return None
