"""Batch preemption: the finish marker and the proxy-side resume dial.

Port of kubeai_tpu/qos/preempt.py: the JAX package's code,
its imports in this package.

Preemption reuses the mid-stream replay machinery end to end
(proxy/recovery.py), exactly like the disagg handoff: the engine
finishes the seized batch stream with ``finish_reason: "preempted"``
(no detokenizer tail flush — a flushed tail would desync the proxy's
event-count cursor), the proxy withholds that marker chunk and
re-dispatches the request with ``X-Resume-Tokens`` set to the events
already delivered, and the deterministic re-run regenerates the prefix
— the client sees one uninterrupted stream, zero duplicated and zero
dropped events. Only streams the proxy stamped ``X-Preemptible`` can
carry the marker, and that stamp requires replay eligibility
(deterministic sample, single choice, streaming) and NO planned
handoff: a request can be handed off or preempted in a flight, never
both.
"""

from __future__ import annotations

import json
import time

from kubeai_tpu_torch import env_float

# The marker finish_reason the engine emits when a batch slot is seized
# for a waiting interactive request (cf. HANDOFF_FINISH_REASON).
PREEMPT_FINISH_REASON = "preempted"


def is_preempt_event(event: bytes) -> bool:
    """Whether an SSE event is the engine's preemption marker (a data
    event whose first choice finished with reason "preempted").
    Substring pre-filter keeps the hot path free of JSON parsing; the
    parse confirms so a completion whose TEXT contains the word can
    never trigger a resume."""
    if not event.startswith(b"data:") or b"preempted" not in event:
        return False
    payload = event[5:].strip()
    if payload == b"[DONE]":
        return False
    try:
        choices = json.loads(payload).get("choices") or []
        return any(
            isinstance(c, dict) and c.get("finish_reason") == PREEMPT_FINISH_REASON
            for c in choices
        )
    except (ValueError, AttributeError):
        return False


class PreemptResumeError(ConnectionError):
    """No upstream could be acquired to resume a preempted batch
    stream; it terminates where the preemption cut it (client-visible
    truncation, exactly like an exhausted replay)."""


def acquire_resume_upstream(
    proxy, req, path, base_headers, body, cancelled, remaining, forwarded
):
    """Re-dispatch a preempted batch stream. Returns ``(resp, conn,
    done, addr, t_conn)`` like the handoff acquisition it mirrors, with
    two deliberate differences:

    - No endpoint exclusion. A preempting replica is HEALTHY — it shed
      this batch stream on purpose and is the natural resume target
      once its interactive burst drains — so each attempt passes a
      throwaway failed set to the shared connector instead of the
      flight's blacklist.
    - A pause before the first attempt (KUBEAI_QOS_RESUME_DELAY) and a
      linear backoff between attempts: the engine that preempted is
      busy admitting interactive work, and an instant re-submit at
      batch class would likely be shed (429) right back.

    The first attempt is free — a preemption is planned work, not a
    failure — further attempts draw a "replay" retry-budget token.
    Raises PreemptResumeError when no upstream is acquirable."""
    attempts = 0
    max_attempts = max(int(env_float("KUBEAI_QOS_RESUME_ATTEMPTS", 8.0)), 1)
    last_err: Exception | str | None = None

    def _pause(seconds: float) -> None:
        rem = remaining()
        if rem is not None:
            seconds = min(seconds, max(rem - 0.001, 0.0))
        deadline = time.monotonic() + seconds
        while seconds > 0:
            if cancelled is not None and cancelled.is_set():
                return
            step = min(0.05, deadline - time.monotonic())
            if step <= 0:
                return
            time.sleep(step)
            seconds = deadline - time.monotonic()

    _pause(max(env_float("KUBEAI_QOS_RESUME_DELAY", 0.05), 0.0))
    while True:
        rem = remaining()
        if cancelled is not None and cancelled.is_set():
            raise PreemptResumeError("request cancelled at preemption resume")
        if rem is not None and rem <= 0:
            raise PreemptResumeError("deadline exceeded at preemption resume")
        if attempts >= max_attempts or (
            attempts > 0 and not proxy.budget.try_take("replay")
        ):
            raise PreemptResumeError(
                f"no resume upstream after {attempts} attempts: {last_err}"
            )
        if attempts > 0:
            _pause(min(0.25 * attempts, 2.0))
        attempts += 1
        await_t = 5.0 if rem is None else min(5.0, max(rem, 0.001))
        try:
            addr, done = proxy.lb.await_best_address(
                req, timeout=await_t, cancelled=cancelled,
            )
        except (TimeoutError, RuntimeError) as e:
            raise PreemptResumeError(f"no resume endpoint: {e}") from None
        hdrs = dict(base_headers)
        # A resumed flight must never re-enter the handoff plan, and a
        # 429/5xx at connect must not blacklist the replica for OTHER
        # requests — hence the per-attempt throwaway failed set.
        hdrs.pop("X-Handoff-Planned", None)
        resp, conn, t_conn, err = proxy._connect_resume_upstream(
            req, addr, done, path, hdrs, body, remaining(),
            set(), forwarded,
        )
        if resp is None:
            last_err = err
            continue
        return resp, conn, done, addr, t_conn
