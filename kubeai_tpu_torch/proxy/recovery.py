"""Recovery primitives for the proxy: retry budget, hedging, SSE replay.

Port of kubeai_tpu/proxy/recovery.py: the JAX package's code,
its imports in this package.

Retry amplification is how a blip becomes an outage: when every replica
of a model goes unhealthy at once, per-request retries multiply the
offered load by (max_retries + 1) exactly when capacity is lowest
("Taming the Chaos", arxiv 2508.19559). The RetryBudget is a process-
wide token bucket gating ALL proxy retries — connect/5xx failovers,
mid-stream replays, and latency hedges draw from one budget sized as a
fraction (~10%) of the request rate, so a fleet-wide outage degrades to
fail-fast instead of a retry storm.

The SSE event splitter backs mid-stream replay (proxy/handler.py): a
replayable stream is forwarded event-at-a-time (a half-written event
from a dying upstream never reaches the client), and the forwarded
event count is the resume cursor a replay suppresses on the fresh
upstream.
"""

from __future__ import annotations

import os
import threading

from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch import env_float as _env_float

# One counter for every retry-shaped decision the proxy makes; the
# reason label separates failure-driven retries from recovery replays
# and latency hedges.
M_RETRIES = default_registry.counter(
    "kubeai_proxy_retries_total",
    "extra upstream attempts by reason: error = connect/5xx failover, "
    "replay = mid-stream resume on another endpoint, hedge = latency "
    "hedge for a slow non-streaming request",
)
M_BUDGET_REMAINING = default_registry.callback_gauge(
    "kubeai_retry_budget_remaining",
    "tokens left in the process-wide retry budget (retries/replays/"
    "hedges each cost 1; every handled request deposits the configured "
    "ratio; 0 = fail-fast mode)",
)


class RetryBudget:
    """Token bucket: each handled request deposits *ratio* tokens (capped
    at *cap*); each retry/replay/hedge withdraws 1. The bucket starts
    full so short bursts after idle retry freely; under sustained
    failure it drains to the deposit rate — retries bounded at ~ratio
    of the request rate. ``cap <= 0`` disables gating (every take
    succeeds). Thread-safe; injectable for tests."""

    def __init__(self, ratio: float | None = None, cap: float | None = None):
        self.ratio = (
            _env_float("KUBEAI_RETRY_BUDGET_RATIO", 0.1) if ratio is None else ratio
        )
        self.cap = (
            _env_float("KUBEAI_RETRY_BUDGET_CAP", 100.0) if cap is None else cap
        )
        self._tokens = self.cap
        self._lock = threading.Lock()

    def deposit(self) -> None:
        if self.cap <= 0:
            return
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.cap)

    def try_take(self, reason: str) -> bool:
        """Withdraw one token for a retry attempt; False = out of budget
        (the caller must fail fast). A granted take increments
        kubeai_proxy_retries_total{reason=...}."""
        if self.cap <= 0:
            M_RETRIES.inc(labels={"reason": reason})
            return True
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
        M_RETRIES.inc(labels={"reason": reason})
        return True

    def remaining(self) -> float:
        with self._lock:
            return round(self._tokens, 3)


class HedgeTracker:
    """Rolling non-streaming upstream latency window -> the hedge delay
    (p95, floored at *min_delay*). Until *min_samples* observations the
    delay is the floor — hedging too eagerly on a cold window would
    double the load of every request."""

    def __init__(
        self,
        min_delay: float | None = None,
        window: int = 128,
        min_samples: int = 8,
    ):
        self.min_delay = (
            _env_float("KUBEAI_HEDGE_DELAY_MS", 50.0) / 1000.0
            if min_delay is None
            else min_delay
        )
        self.window = window
        self.min_samples = min_samples
        self._lat: list[float] = []
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)
            if len(self._lat) > self.window:
                del self._lat[: len(self._lat) - self.window]

    def delay(self) -> float:
        with self._lock:
            lat = list(self._lat)
        if len(lat) < self.min_samples:
            return self.min_delay
        lat.sort()
        p95 = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
        return max(p95, self.min_delay)


def hedging_enabled() -> bool:
    """Latency hedging is opt-in (KUBEAI_HEDGE=1): it trades extra
    engine load for tail latency, a call only the operator can make."""
    return os.environ.get("KUBEAI_HEDGE", "") in ("1", "true", "yes")


def replay_enabled() -> bool:
    """Mid-stream replay defaults ON; KUBEAI_REPLAY=0 turns the whole
    mechanism off (eligibility per request is still gated on
    determinism — see request_replayable)."""
    return os.environ.get("KUBEAI_REPLAY", "1") not in ("0", "false", "no")


def request_replayable(body) -> bool:
    """Whether a parsed request body is safe to replay mid-stream on
    another endpoint. Requires:

    - a streaming completion/chat request (non-streaming bodies retry
      whole, or hedge);
    - a deterministic sample: greedy (temperature == 0) or an explicit
      seed — engines regenerate the identical token stream, so the
      proxy can align the fresh stream against what it already
      forwarded;
    - a single choice (n <= 1): multi-choice SSE interleaving is
      thread-timing-dependent, so an event-count cursor cannot align.

    Everything else is treated as non-idempotent: replay off, the
    client sees the truncation exactly as before.
    """
    if body is None or not getattr(body, "stream", False):
        return False
    data = getattr(body, "data", None)
    if not isinstance(data, dict):
        return False
    if data.get("n") not in (None, 1):
        return False
    temp = data.get("temperature", 1.0)
    if temp is None:
        temp = 1.0
    try:
        greedy = float(temp) <= 0.0
    except (TypeError, ValueError):
        return False
    return greedy or data.get("seed") is not None


def sse_events(read_chunk, flush_tail: bool = False):
    """Re-frame a byte stream into complete SSE events (blank-line
    delimited blocks, delimiter included; both LF and CRLF line endings
    — third-party engine images behind the operator may emit either).
    *read_chunk* is a no-arg callable returning the next bytes chunk
    (b"" on EOF). Trailing bytes that never completed an event are
    DISCARDED — that is the point: a half-event from a dying upstream
    must not reach the client.

    *flush_tail* yields the trailing remainder on a CLEAN EOF instead:
    the passthrough (non-replay) proxy path uses it so a third-party
    engine whose final event lacks the terminating blank line still
    delivers every byte the upstream sent — only clean exhaustion
    flushes; a mid-stream death still raises out of *read_chunk*
    before the flush is reached."""
    buf = b""
    while True:
        chunk = read_chunk()
        if not chunk:
            if flush_tail and buf:
                yield buf
            return
        buf += chunk
        while True:
            # Earliest terminator wins; b"\r\n\r\n" contains no
            # b"\n\n", so the two searches never overlap-misfire.
            i_lf = buf.find(b"\n\n")
            i_crlf = buf.find(b"\r\n\r\n")
            if i_crlf != -1 and (i_lf == -1 or i_crlf < i_lf):
                end = i_crlf + 4
            elif i_lf != -1:
                end = i_lf + 2
            else:
                break
            yield buf[:end]
            buf = buf[end:]


def is_token_event(event: bytes) -> bool:
    """A data event carrying stream content — the unit the replay
    cursor counts. ``data: [DONE]`` is a terminator, not content."""
    if not event.startswith(b"data:"):
        return False
    return event[5:].strip() != b"[DONE]"
