"""Replay-based prefill→decode handoff (proxy side).

Port of kubeai_tpu/disagg/handoff.py: the JAX package's code,
its imports in this package.

v1 handoff streams no KV: it reuses the mid-stream replay machinery
(proxy/recovery.py). The prefill replica serves the prompt phase plus
the first K stream events, then finishes the capped generation with
``finish_reason: "handoff"``; the proxy withholds that marker chunk,
re-dispatches the request to the decode pool with ``X-Resume-Tokens``
set to the number of events already delivered, and the decode replica's
deterministic-prefix replay regenerates the KV — the client sees one
uninterrupted stream with zero duplicated and zero dropped events.

Eligibility mirrors replay (deterministic sample, single choice,
streaming — recovery.request_replayable); everything else serves
unified on the decode pool, where an uncapped replica behaves exactly
like pre-disaggregation serving.
"""

from __future__ import annotations

import json

from kubeai_tpu_torch.metrics import default_registry

# The marker finish_reason a budget-capped prefill engine emits instead
# of "length" — unambiguous to the proxy (a genuine short completion
# keeps its real finish_reason and never triggers a handoff).
HANDOFF_FINISH_REASON = "handoff"

M_HANDOFFS = default_registry.counter(
    "kubeai_disagg_handoffs_total",
    "prefill→decode handoffs by outcome: ok = decode stream grafted, "
    "failed = no decode upstream acquirable (client saw truncation), "
    "deadline = request budget expired at the cutover point",
)
M_HANDOFF_LATENCY = default_registry.histogram(
    "kubeai_disagg_handoff_seconds",
    "cutover latency: prefill handoff marker observed → decode replica "
    "answering 200 with a stream (the replayed-prefix regeneration "
    "happens inside the decode engine after this)",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)
M_DISAGG_REQUESTS = default_registry.counter(
    "kubeai_disagg_requests_total",
    "requests entering a disaggregated model by serving mode: handoff = "
    "routed prefill-first with a planned handoff, unified = handoff-"
    "ineligible, served whole on the decode pool",
)


def is_handoff_event(event: bytes) -> bool:
    """Whether an SSE event is the prefill engine's handoff marker (a
    data event whose first choice finished with reason "handoff").
    Substring pre-filter keeps the hot path free of JSON parsing; the
    parse confirms so a completion whose TEXT contains the word can
    never trigger a cutover."""
    if not event.startswith(b"data:") or b"handoff" not in event:
        return False
    payload = event[5:].strip()
    if payload == b"[DONE]":
        return False
    try:
        choices = json.loads(payload).get("choices") or []
        return any(
            isinstance(c, dict) and c.get("finish_reason") == HANDOFF_FINISH_REASON
            for c in choices
        )
    except (ValueError, AttributeError):
        return False


class HandoffError(ConnectionError):
    """No decode upstream could be acquired for a planned handoff; the
    stream terminates where the prefill stopped (client-visible
    truncation, exactly like an exhausted replay)."""


def acquire_handoff_upstream(
    proxy, req, path, base_headers, body, cancelled, failed_addrs, remaining, forwarded
):
    """Connect a decode-pool upstream for a planned handoff. Returns
    ``(resp, conn, done, addr, t_conn)`` like the proxy's replay
    acquisition. The FIRST attempt is free — a handoff is planned work,
    not a failure — but every further attempt (a decode replica that
    refused or died at connect) draws a "replay" retry-budget token, so
    a decode-pool outage cannot turn handoffs into a retry storm.

    The caller must have set ``req.role`` to the decode role already:
    endpoint selection prefers the decode pool and fails open to any
    surviving endpoint (unified fallback) when that pool is gone.
    Raises HandoffError when no upstream is acquirable; outcome
    accounting (M_HANDOFFS) stays with the caller, which knows whether
    the failure was deadline, cancellation, or exhaustion."""
    attempts = 0
    last_err: Exception | str | None = None
    while True:
        rem = remaining()
        if cancelled is not None and cancelled.is_set():
            raise HandoffError("request cancelled at handoff")
        if rem is not None and rem <= 0:
            raise HandoffError("deadline exceeded at handoff")
        if attempts > proxy.max_retries or (
            attempts > 0 and not proxy.budget.try_take("replay")
        ):
            raise HandoffError(
                f"no decode upstream after {attempts} attempts: {last_err}"
            )
        attempts += 1
        await_t = 5.0 if rem is None else min(5.0, max(rem, 0.001))
        try:
            addr, done = proxy.lb.await_best_address(
                req, timeout=await_t, cancelled=cancelled,
                exclude=failed_addrs or None,
            )
        except (TimeoutError, RuntimeError) as e:
            raise HandoffError(f"no decode endpoint: {e}") from None
        hdrs = dict(base_headers)
        # This is the DECODE leg: drop the planned-handoff intent so a
        # fail-open pick of the prefill replica (decode pool gone)
        # serves the stream whole instead of budget-capping it again.
        hdrs.pop("X-Handoff-Planned", None)
        # Shared connect-and-validate-graft step with crash replay
        # (stamps X-Resume-Tokens + the remaining deadline, accepts
        # only a 200 SSE answer, does the failure bookkeeping).
        resp, conn, t_conn, err = proxy._connect_resume_upstream(
            req, addr, done, path, hdrs, body, remaining(),
            failed_addrs, forwarded,
        )
        if resp is None:
            last_err = err
            continue
        return resp, conn, done, addr, t_conn
