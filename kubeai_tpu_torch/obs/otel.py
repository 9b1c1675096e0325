"""OTLP/HTTP+JSON export of the engine's spans, metrics and logs (port of
kubeai_tpu/obs/otel.py).

The flight recorder's timelines become OTLP spans (a root span per
request, a child per phase), the metrics registry becomes OTLP metric
points (cumulative), and the records of the ``kubeai_tpu_torch`` loggers
at INFO and above become OTLP log records. All of it goes onto one
bounded queue that a daemon worker posts to ``KUBEAI_OTLP_ENDPOINT``
(``/v1/traces``, ``/v1/metrics``, ``/v1/logs``). Off unless the
endpoint is set; stdlib only.

- **The request path never waits.** A producer appends to the queue; a
  full queue drops the item and counts it
  (``kubeai_otel_dropped_total{signal,reason="queue_full"}``).
- **Drops are counted.** A batch that fails its retries counts
  ``reason="send_error"``; what is still queued at stop is flushed once
  and the rest counts ``reason="shutdown"``. Sent items count in
  ``kubeai_otel_exported_total{signal}``.
- **A collector that is down** costs retries and backoff on the worker
  thread only.

Knobs: ``KUBEAI_OTLP_ENDPOINT``, ``KUBEAI_OTLP_QUEUE_MAX`` (2048),
``KUBEAI_OTLP_FLUSH_INTERVAL`` (1 s), ``KUBEAI_OTLP_METRICS_INTERVAL``
(10 s) and ``KUBEAI_OTLP_TIMEOUT`` (2 s).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import urllib.request
from collections import deque

from kubeai_tpu_torch.metrics import CallbackGauge, Counter, Gauge, Histogram, default_registry
from kubeai_tpu_torch.obs import recorder as _recorder
from kubeai_tpu_torch.obs.logs import LOGGER_ROOT, record_to_entry

OTLP_ENDPOINT_ENV = "KUBEAI_OTLP_ENDPOINT"

M_EXPORTED = default_registry.counter(
    "kubeai_otel_exported_total",
    "telemetry items successfully exported over OTLP/HTTP, by signal "
    "(span | metric | log)",
)
M_DROPPED = default_registry.counter(
    "kubeai_otel_dropped_total",
    "telemetry items dropped by the OTLP exporter, by signal and reason "
    "(queue_full | send_error | shutdown)",
)

_SEVERITY = {"DEBUG": 5, "INFO": 9, "WARNING": 13, "ERROR": 17, "CRITICAL": 21}

SIGNALS = ("span", "metric", "log")


def _attrs(d: dict) -> list[dict]:
    """dict -> OTLP KeyValue list (None and "" dropped; anything not a
    bool, int or float as a string)."""
    out = []
    for k, v in d.items():
        if v is None or v == "":
            continue
        if isinstance(v, bool):
            val = {"boolValue": v}
        elif isinstance(v, int):
            val = {"intValue": str(v)}
        elif isinstance(v, float):
            val = {"doubleValue": v}
        else:
            val = {"stringValue": str(v)}
        out.append({"key": str(k), "value": val})
    return out


def timeline_to_spans(doc: dict) -> list[dict]:
    """One timeline -> a root span for the request and a child per phase.
    A child's id is the md5 of (root span id, phase index, name), so a
    timeline exported twice gives the same ids."""
    trace_id = doc.get("trace_id", "") or ""
    span_id = doc.get("span_id", "") or ""
    start_ns = int(doc.get("start_ms", 0) * 1e6)
    end_ns = start_ns + int(doc.get("duration_ms", 0) * 1e6)
    outcome = doc.get("outcome", "")
    root = {
        "traceId": trace_id,
        "spanId": span_id,
        "name": doc.get("component") or "request",
        "kind": 2,  # SPAN_KIND_SERVER
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": _attrs({
            "request_id": doc.get("request_id"),
            "model": doc.get("model"),
            "outcome": outcome,
            **{k: v for k, v in (doc.get("attrs") or {}).items()
               if not isinstance(v, (list, dict))},
        }),
        "status": {"code": 2 if outcome == "error" else 1},
    }
    spans = [root]
    for i, ph in enumerate(doc.get("phases") or []):
        p_start = int(ph.get("start_ms", 0) * 1e6)
        child_id = hashlib.md5(f"{span_id}/{i}/{ph.get('name')}".encode()).hexdigest()[:16]
        spans.append({
            "traceId": trace_id,
            "spanId": child_id,
            "parentSpanId": span_id,
            "name": str(ph.get("name", "phase")),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(p_start),
            "endTimeUnixNano": str(p_start + int(ph.get("duration_ms", 0) * 1e6)),
            "attributes": _attrs({k: v for k, v in (ph.get("attrs") or {}).items()
                                  if not isinstance(v, (list, dict))}),
        })
    return spans


def entry_to_log_record(entry: dict) -> dict:
    """A ``logs.record_to_entry`` dict -> an OTLP logRecord, with the
    trace and span ids where the entry has them."""
    known = ("ts", "level", "logger", "message", "trace_id", "span_id")
    rec = {
        "timeUnixNano": str(int(entry.get("ts", 0) * 1e9)),
        "severityText": entry.get("level", ""),
        "severityNumber": _SEVERITY.get(entry.get("level", ""), 0),
        "body": {"stringValue": entry.get("message", "")},
        "attributes": _attrs({
            "logger": entry.get("logger"),
            **{k: v for k, v in entry.items() if k not in known},
        }),
    }
    if entry.get("trace_id"):
        rec["traceId"] = entry["trace_id"]
    if entry.get("span_id"):
        rec["spanId"] = entry["span_id"]
    return rec


def registry_to_metrics(registry, now_ns: int) -> list[dict]:
    """Every registered metric as OTLP metric objects (cumulative
    temporality). The exporter's own counters are left out: they move
    during an export, so every batch would dirty the next."""
    out: list[dict] = []
    for name, m in sorted(registry.metrics().items()):
        if name in (M_EXPORTED.name, M_DROPPED.name):
            continue
        if isinstance(m, Histogram):
            dps = [{
                "attributes": _attrs(dict(key)),
                "timeUnixNano": str(now_ns),
                "count": str(n),
                "sum": total,
                "bucketCounts": [str(c) for c in counts],
                "explicitBounds": list(m.buckets),
            } for key, (counts, total, n) in sorted(m.snapshot().items())]
            if dps:
                out.append({"name": m.name, "description": m.help,
                            "histogram": {"dataPoints": dps, "aggregationTemporality": 2}})
        elif isinstance(m, CallbackGauge):
            try:
                v = m.value()
            except Exception:
                continue  # a dying callback must not break the batch
            out.append({"name": m.name, "description": m.help,
                        "gauge": {"dataPoints": [{"timeUnixNano": str(now_ns),
                                                  "asDouble": float(v)}]}})
        elif isinstance(m, (Counter, Gauge)):
            dps = [{"attributes": _attrs(dict(key)), "timeUnixNano": str(now_ns),
                    "asDouble": float(v)} for key, v in sorted(m.snapshot().items())]
            if not dps:
                continue
            if isinstance(m, Counter):
                out.append({"name": m.name, "description": m.help,
                            "sum": {"dataPoints": dps, "aggregationTemporality": 2,
                                    "isMonotonic": True}})
            else:
                out.append({"name": m.name, "description": m.help,
                            "gauge": {"dataPoints": dps}})
    return out


class _ExportHandler(logging.Handler):
    """Puts the package loggers' records on the exporter's queue."""

    def __init__(self, exporter: "OtelExporter", level: int = logging.INFO):
        super().__init__(level=level)
        self._exporter = exporter

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._exporter.enqueue("log", record_to_entry(record))
        except Exception:
            self.handleError(record)


class OtelExporter:
    """A bounded-queue OTLP/HTTP+JSON exporter with one daemon worker."""

    def __init__(self, endpoint: str, *, service: str = "kubeai", queue_max: int = 2048,
                 flush_interval: float = 1.0, metrics_interval: float = 10.0,
                 timeout: float = 2.0, max_retries: int = 2, registry=default_registry,
                 log_level: int = logging.INFO):
        self.endpoint = endpoint.rstrip("/")
        self.service = service
        self.queue_max = queue_max
        self.flush_interval = flush_interval
        self.metrics_interval = metrics_interval
        self.timeout = timeout
        self.max_retries = max_retries
        self.registry = registry
        self.last_error: str = ""
        self.consecutive_failures = 0
        self._q: deque = deque()
        self._q_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._drain_on_stop = True
        self._thread: threading.Thread | None = None
        self._handler = _ExportHandler(self, level=log_level)
        self._resource = {"attributes": _attrs({"service.name": service,
                                                "telemetry.sdk.name": "kubeai_tpu_torch"})}
        self._scope = {"name": "kubeai_tpu_torch"}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "OtelExporter":
        self._stop.clear()
        _recorder.add_timeline_hook(self._on_timeline)
        logging.getLogger(LOGGER_ROOT).addHandler(self._handler)
        self._thread = threading.Thread(target=self._run, name="otlp-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 5.0) -> None:
        """Detach from the producers, flush what is queued once (when
        *drain*), then count what is left as dropped at shutdown."""
        _recorder.remove_timeline_hook(self._on_timeline)
        logging.getLogger(LOGGER_ROOT).removeHandler(self._handler)
        self._drain_on_stop = drain
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        with self._q_lock:
            leftovers = list(self._q)
            self._q.clear()
        for signal, _ in leftovers:
            M_DROPPED.inc(labels={"signal": signal, "reason": "shutdown"})

    # -- producers: a bounded append, never a wait -------------------------

    def enqueue(self, signal: str, item) -> bool:
        with self._q_lock:
            if len(self._q) >= self.queue_max:
                M_DROPPED.inc(labels={"signal": signal, "reason": "queue_full"})
                return False
            self._q.append((signal, item))
        self._wake.set()
        return True

    def _on_timeline(self, doc: dict) -> None:
        # The raw timeline; the worker converts it.
        self.enqueue("span", doc)

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        next_metrics = time.monotonic() + self.metrics_interval
        while not self._stop.is_set():
            self._wake.wait(timeout=self.flush_interval)
            self._wake.clear()
            self.flush()
            if time.monotonic() >= next_metrics:
                self.export_metrics()
                next_metrics = time.monotonic() + self.metrics_interval
        if self._drain_on_stop:
            self.flush(final=True)

    def flush(self, final: bool = False) -> None:
        """Drain the queue: one POST per signal present."""
        with self._q_lock:
            items = list(self._q)
            self._q.clear()
        if not items:
            return
        spans = [it for sig, it in items if sig == "span"]
        logs = [it for sig, it in items if sig == "log"]
        if spans:
            flat = [s for doc in spans for s in timeline_to_spans(doc)]
            payload = {"resourceSpans": [{
                "resource": self._resource,
                "scopeSpans": [{"scope": self._scope, "spans": flat}],
            }]}
            self._send("/v1/traces", payload, "span", len(spans), final=final)
        if logs:
            payload = {"resourceLogs": [{
                "resource": self._resource,
                "scopeLogs": [{"scope": self._scope,
                               "logRecords": [entry_to_log_record(e) for e in logs]}],
            }]}
            self._send("/v1/logs", payload, "log", len(logs), final=final)

    def export_metrics(self) -> int:
        """Send one cumulative snapshot of the registry now; returns the
        number of metric objects sent."""
        metrics = registry_to_metrics(self.registry, time.time_ns())
        if not metrics:
            return 0
        payload = {"resourceMetrics": [{
            "resource": self._resource,
            "scopeMetrics": [{"scope": self._scope, "metrics": metrics}],
        }]}
        ok = self._send("/v1/metrics", payload, "metric", len(metrics))
        return len(metrics) if ok else 0

    def _send(self, path: str, payload: dict, signal: str, count: int,
              final: bool = False) -> bool:
        body = json.dumps(payload).encode()
        delay = 0.2
        attempts = 1 if final else self.max_retries + 1
        for attempt in range(attempts):
            try:
                req = urllib.request.Request(self.endpoint + path, data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    r.read()
                M_EXPORTED.inc(count, labels={"signal": signal})
                self.consecutive_failures = 0
                return True
            except Exception as e:
                self.last_error = f"{path}: {str(e)[:200]}"
                self.consecutive_failures += 1
                if attempt + 1 < attempts and not self._stop.wait(delay):
                    delay = min(delay * 2, 2.0)
        M_DROPPED.inc(count, labels={"signal": signal, "reason": "send_error"})
        return False

    def report(self) -> dict:
        counts = {"exported": {}, "dropped": {}}
        for sig in SIGNALS:
            counts["exported"][sig] = M_EXPORTED.value(labels={"signal": sig})
            counts["dropped"][sig] = sum(
                M_DROPPED.value(labels={"signal": sig, "reason": reason})
                for reason in ("queue_full", "send_error", "shutdown"))
        with self._q_lock:
            queued = len(self._q)
        return {
            "endpoint": self.endpoint,
            "service": self.service,
            "queued": queued,
            "queue_max": self.queue_max,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            **counts,
        }


# ---------------------------------------------------------------------------
# The process's exporter.

_exporter: OtelExporter | None = None


def install_exporter(exporter: OtelExporter) -> OtelExporter:
    global _exporter
    _exporter = exporter
    return exporter


def installed_exporter() -> OtelExporter | None:
    return _exporter


def uninstall_exporter(exporter: OtelExporter) -> None:
    """Identity-checked: a stopped owner must not clobber a newer one."""
    global _exporter
    if _exporter is exporter:
        _exporter = None


def maybe_start_exporter(service: str) -> OtelExporter | None:
    """Start and install an exporter when ``KUBEAI_OTLP_ENDPOINT`` is set;
    otherwise nothing runs."""
    endpoint = (os.environ.get(OTLP_ENDPOINT_ENV) or "").strip()
    if not endpoint:
        return None

    def _f(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, ""))
        except ValueError:
            return default

    exp = OtelExporter(
        endpoint,
        service=service,
        queue_max=int(_f("KUBEAI_OTLP_QUEUE_MAX", 2048)),
        flush_interval=_f("KUBEAI_OTLP_FLUSH_INTERVAL", 1.0),
        metrics_interval=_f("KUBEAI_OTLP_METRICS_INTERVAL", 10.0),
        timeout=_f("KUBEAI_OTLP_TIMEOUT", 2.0),
    )
    exp.start()
    return install_exporter(exp)
