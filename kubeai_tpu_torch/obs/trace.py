"""Request tracing primitives (port of kubeai_tpu/obs/trace.py; stdlib
only, like the original).

- **TraceContext**: W3C ``traceparent`` in and out (32-hex trace id,
  16-hex span id). When the caller sent only an ``X-Request-ID``, the
  trace id derives from it deterministically, so the JAX proxy and a
  port engine land on the same trace id across the hop.
- **RequestTrace**: the stamp collector the engine's scheduler thread
  uses (``mark()`` / ``tok()``: a monotonic read and a list append);
  the flight recorder (obs/recorder.py) assembles spans off-thread.
- **SpanBuilder**: context-managed spans for paths that are not hot.

Durations use the monotonic clock; each trace carries one wall-clock
anchor (``t0_wall``).
"""

from __future__ import annotations

import hashlib
import re
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
# Correlation ids go into headers/log lines: safe charset, bounded
# length (the JAX package's rule: trace ids derive from the sanitized
# request id on both sides of the proxy -> engine hop).
_RID_RE = re.compile(r"[^A-Za-z0-9._\-]")


def sanitize_request_id(rid: str) -> str:
    return _RID_RE.sub("", str(rid))[:128]


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def trace_id_from_request_id(rid: str) -> str:
    """Deterministic 32-hex trace id from a bare request id: both sides
    of the proxy->engine hop derive the SAME trace id from the same
    ``X-Request-ID`` even if the ``traceparent`` header is dropped by an
    intermediary."""
    return hashlib.md5(rid.encode()).hexdigest()


@dataclass
class TraceContext:
    trace_id: str
    span_id: str
    request_id: str = ""
    sampled: bool = True

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"

    def child(self) -> "TraceContext":
        """A new context under this one (same trace, fresh span id) —
        what gets stamped on the downstream hop."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            request_id=self.request_id,
            sampled=self.sampled,
        )


def parse_traceparent(header: str | None) -> TraceContext | None:
    m = _TRACEPARENT_RE.match((header or "").strip().lower())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    # All-zero ids are invalid per W3C; version ff is reserved.
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(
        trace_id=trace_id,
        span_id=span_id,
        sampled=bool(int(flags, 16) & 1),
    )


def extract_context(headers, fallback_request_id: str = "") -> TraceContext:
    """Trace context from inbound HTTP headers (case-insensitive):
    ``traceparent`` wins; else the trace id derives from
    ``X-Request-ID``; else both are generated. Always returns a usable
    context — tracing never fails a request."""
    tp = rid = ""
    for k in headers.keys():
        lk = k.lower()
        if lk == "traceparent":
            tp = headers[k]
        elif lk == "x-request-id":
            rid = sanitize_request_id(headers[k])
    rid = rid or sanitize_request_id(fallback_request_id)
    ctx = parse_traceparent(tp)
    if ctx is not None:
        ctx.request_id = rid or ctx.trace_id[:16]
        return ctx
    if rid:
        return TraceContext(
            trace_id=trace_id_from_request_id(rid),
            span_id=new_span_id(),
            request_id=rid,
        )
    trace_id = new_trace_id()
    return TraceContext(
        trace_id=trace_id, span_id=new_span_id(), request_id=trace_id[:16]
    )


# ---------------------------------------------------------------------------
# Hot-path stamp collector (engine scheduler).


class RequestTrace:
    """Timestamp collector for one engine request. The scheduler loop
    only ever calls ``mark``/``tok`` (a monotonic read + list append);
    span assembly happens in the flight recorder's worker thread."""

    __slots__ = (
        "ctx", "component", "model", "t0_wall", "t0_mono",
        "marks", "tokens", "end_mono", "outcome", "attrs",
    )

    def __init__(
        self,
        ctx: TraceContext | None = None,
        component: str = "engine",
        model: str = "",
        t0_mono: float | None = None,
    ):
        self.ctx = ctx.child() if ctx is not None else extract_context({})
        self.component = component
        self.model = model
        self.t0_mono = time.monotonic() if t0_mono is None else t0_mono
        # Wall anchor taken once; offsets are all monotonic.
        self.t0_wall = time.time() - (time.monotonic() - self.t0_mono)
        self.marks: list[tuple[str, float]] = []
        self.tokens: list[float] = []
        self.end_mono: float | None = None
        self.outcome: str = ""
        self.attrs: dict = {}

    def mark(self, name: str) -> None:
        self.marks.append((name, time.monotonic()))

    def tok(self) -> None:
        self.tokens.append(time.monotonic())

    def finish(self, outcome: str, **attrs) -> None:
        if self.end_mono is None:  # first terminal wins
            self.end_mono = time.monotonic()
            self.outcome = outcome
            self.attrs.update(attrs)

    def first_mark(self, name: str) -> float | None:
        for n, t in self.marks:
            if n == name:
                return t
        return None


# ---------------------------------------------------------------------------
# Eager span API (proxy handler — not a hot path).


@dataclass
class Span:
    name: str
    t_start: float  # monotonic
    t_end: float
    attrs: dict = field(default_factory=dict)


class SpanBuilder:
    """Assembles a request timeline span-by-span. Thread-safe enough
    for its use: one handler thread appends; finish() is idempotent
    (body-close and error paths can race on client disconnect)."""

    def __init__(self, ctx: TraceContext, component: str, model: str = ""):
        self.ctx = ctx
        self.component = component
        self.model = model
        self.t0_mono = time.monotonic()
        self.t0_wall = time.time() - 0.0
        self.spans: list[Span] = []
        self.attrs: dict = {}
        self.outcome = ""
        self._done = threading.Event()
        self._recorder = None

    @contextmanager
    def span(self, name: str, **attrs):
        t0 = time.monotonic()
        sp = Span(name, t0, t0, dict(attrs))
        try:
            yield sp
        finally:
            sp.t_end = time.monotonic()
            self.spans.append(sp)

    def add_span(self, name: str, t_start: float, **attrs) -> None:
        """Append an already-timed span (t_start monotonic)."""
        self.spans.append(Span(name, t_start, time.monotonic(), dict(attrs)))

    def child_traceparent(self) -> str:
        """traceparent for the downstream hop: same trace, this
        builder's span id as the parent."""
        return self.ctx.traceparent()

    def finish(self, outcome: str, recorder=None, **attrs) -> None:
        """Close the timeline and hand it to *recorder* (or the default
        recorder). Idempotent — the first caller's outcome wins."""
        if self._done.is_set():
            return
        self._done.set()
        self.outcome = outcome
        self.attrs.update(attrs)
        self._end_mono = time.monotonic()
        if recorder is None:
            from kubeai_tpu_torch.obs.recorder import default_recorder as recorder
        recorder.record_timeline(self._assemble())

    def _assemble(self) -> dict:
        base = self.t0_wall - self.t0_mono

        def ms(t_mono: float) -> float:
            return round((base + t_mono) * 1000, 3)

        return {
            "trace_id": self.ctx.trace_id,
            "span_id": self.ctx.span_id,
            "request_id": self.ctx.request_id,
            "component": self.component,
            "model": self.model,
            "outcome": self.outcome,
            "start_ms": ms(self.t0_mono),
            "duration_ms": round((self._end_mono - self.t0_mono) * 1000, 3),
            "attrs": dict(self.attrs),
            "phases": [
                {
                    "name": s.name,
                    "start_ms": ms(s.t_start),
                    "duration_ms": round((s.t_end - s.t_start) * 1000, 3),
                    "attrs": dict(s.attrs),
                }
                for s in self.spans
            ],
        }
