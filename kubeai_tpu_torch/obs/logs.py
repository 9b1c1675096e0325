"""Context-stamped structured logging (port of kubeai_tpu/obs/logs.py).

- **Context**: a ``contextvars`` field set (``trace_id``, ``span_id``,
  ``request_id``, ``model``, ``tenant``, ``qos_class``) that the engine
  server's handler thread binds once per request; every record logged
  while it is bound carries the fields. The scheduler thread serves many
  requests, so its per-request sites stamp ``extra=trace_extra(req.trace)``.
- **get_logger(name)**: a ``LoggerAdapter`` merging the bound context
  with explicit ``extra=`` fields into one ``kubeai_ctx`` attribute.
- **JSON / text formatters and setup_logging(role)**
  (``KUBEAI_LOG_FORMAT``, ``KUBEAI_LOG_LEVEL``).
- **LogRing**: a bounded ring of recent WARNING+ records of the
  ``kubeai_tpu_torch`` loggers, served at ``GET /debug/logs
  ?level=&since=&trace=&limit=`` and counted in
  ``kubeai_log_records_total``.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import threading
import time
from collections import deque
from urllib.parse import parse_qs

from kubeai_tpu_torch.metrics import default_registry

# The canonical correlation fields, in render order. Anything else in a
# record's context dict is a free-form attribute (endpoint=, state=...).
CONTEXT_FIELDS = (
    "trace_id", "span_id", "request_id", "model", "tenant", "qos_class",
)

# Parent logger every kubeai_tpu_torch.* module logger propagates to:
# where the ring attaches.
LOGGER_ROOT = "kubeai_tpu_torch"

_log_ctx: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kubeai_log_ctx", default=None
)


def set_log_context(**fields) -> None:
    """REPLACE the current context (empty values dropped). Request
    entrypoints (one thread per in-flight request) call this at the top
    of the request so stale fields from the thread's previous request
    can never leak onto the next one."""
    _log_ctx.set({k: v for k, v in fields.items() if v})


def bind_log_context(**fields) -> None:
    """MERGE non-empty fields into the current context — for fields
    that only become known mid-request (model after parse, tenant after
    auth, qos_class after resolution)."""
    cur = dict(_log_ctx.get() or {})
    for k, v in fields.items():
        if v:
            cur[k] = v
    _log_ctx.set(cur)


def trace_extra(tr, **more) -> dict:
    """``extra=`` fields from anything carrying a ``.ctx``
    (RequestTrace / SpanBuilder) — the explicit stamp for the engine
    scheduler thread, where one thread serves many requests and the
    contextvar cannot disambiguate."""
    out: dict = {}
    ctx = getattr(tr, "ctx", None)
    if ctx is not None:
        out["trace_id"] = ctx.trace_id
        out["span_id"] = ctx.span_id
        out["request_id"] = ctx.request_id
    model = getattr(tr, "model", "")
    if model:
        out["model"] = model
    for k, v in more.items():
        if v:
            out[k] = v
    return out


class ContextLogger(logging.LoggerAdapter):
    """Merges the bound contextvar fields with explicit ``extra=``
    fields (explicit wins) under one ``kubeai_ctx`` record attribute."""

    def process(self, msg, kwargs):
        ctx = dict(_log_ctx.get() or {})
        extra = kwargs.pop("extra", None) or {}
        for k, v in extra.items():
            if v not in (None, ""):
                ctx[k] = v
        kwargs["extra"] = {"kubeai_ctx": ctx}
        return msg, kwargs


def get_logger(name: str) -> ContextLogger:
    """The structured replacement for ``logging.getLogger`` on serving
    hot paths."""
    return ContextLogger(logging.getLogger(name), {})


def record_to_entry(record: logging.LogRecord) -> dict:
    """One LogRecord -> the JSON-able entry shape of the ring and the
    /debug/logs payload."""
    entry = {
        "ts": round(record.created, 3),
        "level": record.levelname,
        "logger": record.name,
        "message": record.getMessage(),
    }
    ctx = getattr(record, "kubeai_ctx", None)
    if isinstance(ctx, dict):
        for k, v in ctx.items():
            entry.setdefault(k, v)
    if record.exc_info and record.exc_info[0] is not None:
        entry["exc_type"] = getattr(record.exc_info[0], "__name__", "Exception")
    return entry


# ---------------------------------------------------------------------------
# Formatters + the shared CLI bootstrap.


class JsonFormatter(logging.Formatter):
    def __init__(self, role: str = ""):
        super().__init__()
        self.role = role

    def format(self, record: logging.LogRecord) -> str:
        doc = record_to_entry(record)
        if self.role:
            doc["role"] = self.role
        if record.exc_info and record.exc_info[0] is not None:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


class TextFormatter(logging.Formatter):
    """Human format with the context rendered as a trailing
    ``[k=v ...]`` block — same fields as JSON mode, greppable."""

    def __init__(self, role: str = ""):
        fmt = "%(asctime)s %(levelname)s %(name)s: %(message)s"
        if role:
            fmt = f"%(asctime)s %(levelname)s [{role}] %(name)s: %(message)s"
        super().__init__(fmt)

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        ctx = getattr(record, "kubeai_ctx", None)
        if isinstance(ctx, dict) and ctx:
            ordered = [k for k in CONTEXT_FIELDS if k in ctx]
            ordered += [k for k in ctx if k not in CONTEXT_FIELDS]
            base += " [" + " ".join(f"{k}={ctx[k]}" for k in ordered) + "]"
        return base


def setup_logging(role: str = "", *, level=None, stream=None) -> None:
    """The engine server's logging bootstrap: ``KUBEAI_LOG_FORMAT=json|text``
    picks the formatter, ``KUBEAI_LOG_LEVEL`` the level. Replaces the root
    handlers (re-running is idempotent) and installs the /debug/logs
    ring so records are captured from process start."""
    if level is None:
        name = (os.environ.get("KUBEAI_LOG_LEVEL") or "INFO").strip().upper()
        level = logging.getLevelName(name)
        if not isinstance(level, int):
            level = logging.INFO
    fmt = (os.environ.get("KUBEAI_LOG_FORMAT") or "text").strip().lower()
    formatter = JsonFormatter(role) if fmt == "json" else TextFormatter(role)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(formatter)
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
    install_log_ring()


# ---------------------------------------------------------------------------
# The bounded WARNING+ ring behind GET /debug/logs.

DEFAULT_RING_CAPACITY = 512

# Counted at the ring (WARNING+ in serving processes), so dashboards
# can plot error-log rate by model without scraping log lines. `model`
# cardinality is bounded by the deployed model set; records with no
# model in context fold into "".
M_LOG_RECORDS = default_registry.counter(
    "kubeai_log_records_total",
    "WARNING+ log records captured by the /debug/logs ring, by level "
    "and the model stamped in the record's request context",
)


class LogRing(logging.Handler):
    """Bounded ring of recent WARNING+ records as entry dicts. Emit is
    a dict build + deque append under a lock — cheap enough for any
    path that already decided to log."""

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY,
                 level: int = logging.WARNING):
        super().__init__(level=level)
        self.capacity = capacity
        self._records: deque[dict] = deque(maxlen=capacity)
        self._ring_lock = threading.Lock()
        self._total = 0

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = record_to_entry(record)
            with self._ring_lock:
                self._records.append(entry)
                self._total += 1
            M_LOG_RECORDS.inc(labels={
                "level": entry.get("level", ""),
                "model": entry.get("model", ""),
            })
        except Exception:
            self.handleError(record)

    def snapshot(self, level: str | None = None, since: float | None = None,
                 trace: str | None = None, limit: int = 200) -> dict:
        """Most-recent-first records with optional filters: minimum
        *level* name, *since* epoch seconds, *trace* matching either
        trace_id or request_id."""
        min_level = None
        if level:
            lv = logging.getLevelName(level.strip().upper())
            if isinstance(lv, int):
                min_level = lv
        with self._ring_lock:
            rows = list(self._records)
            total = self._total
        rows.reverse()
        out = []
        for e in rows:
            if len(out) >= max(limit, 1):
                break
            if min_level is not None:
                lv = logging.getLevelName(e.get("level", ""))
                if not isinstance(lv, int) or lv < min_level:
                    continue
            if since is not None and e.get("ts", 0) < since:
                continue
            if trace and trace not in (e.get("trace_id"), e.get("request_id")):
                continue
            out.append(e)
        return {
            "records": out,
            "capacity": self.capacity,
            "min_level": logging.getLevelName(self.level),
            "total_seen": total,
            "evicted": max(total - len(rows), 0),
        }


_ring: LogRing | None = None
_ring_lock = threading.Lock()


def install_log_ring(capacity: int = DEFAULT_RING_CAPACITY,
                     level: int = logging.WARNING) -> LogRing:
    """Attach the process-wide ring to the package logger (idempotent:
    the first install wins; later calls return the existing ring)."""
    global _ring
    with _ring_lock:
        if _ring is None:
            _ring = LogRing(capacity=capacity, level=level)
            logging.getLogger(LOGGER_ROOT).addHandler(_ring)
        return _ring


def installed_log_ring() -> LogRing | None:
    return _ring


def uninstall_log_ring(ring: LogRing) -> None:
    """Detach *ring* IF it is still the installed one — identity-checked
    like install_recorder/clear_callback, so a test tearing down its
    ring can't clobber a newer owner's."""
    global _ring
    with _ring_lock:
        if _ring is ring:
            logging.getLogger(LOGGER_ROOT).removeHandler(ring)
            _ring = None


# ---------------------------------------------------------------------------
# GET /debug/logs, listed in recorder.DEBUG_INDEX.


def handle_logs_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    if path != "/debug/logs":
        return None
    q = parse_qs(query or "")

    def first(name: str) -> str | None:
        vals = q.get(name)
        return vals[0] if vals else None

    since = None
    raw_since = first("since")
    if raw_since:
        try:
            v = float(raw_since)
            # Same convention as /debug/history: small values mean
            # "seconds ago", large ones are epoch timestamps.
            since = v if v >= 1e8 else time.time() - v
        except ValueError:
            pass
    try:
        limit = max(1, min(int(first("limit") or 200), 1000))
    except ValueError:
        limit = 200
    ring = install_log_ring()
    doc = ring.snapshot(
        level=first("level"), since=since, trace=first("trace"), limit=limit
    )
    return 200, "application/json", json.dumps(doc).encode()
