"""Flight recorder (port of kubeai_tpu/obs/recorder.py): bounded rings of
finished request timelines and scheduler step records, and the engine
server's /debug surface over them.

- ``record_timeline(dict)``: an assembled timeline (SpanBuilder).
- ``submit(RequestTrace)``: a finished request's raw stamps from the
  scheduler thread; a daemon worker assembles the phase spans (queue,
  prefill, decode) off that thread.
- ``record_step(**fields)``: one scheduler step record (a decode chunk
  with its host segments, a prefill call).
- ``add_timeline_hook(fn)`` / ``remove_timeline_hook(fn)``: subscribers
  (the OTLP exporter) called with every recorded timeline.

Routes: ``/debug/requests[?limit=&id=&tenant=]``, ``/debug/engine
[?limit=]`` and ``/debug/trace[?limit=]`` (Chrome trace-event JSON for
Perfetto: one lane per request, one for the scheduler's steps).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from urllib.parse import parse_qs

from kubeai_tpu_torch.obs.trace import RequestTrace

DEFAULT_TIMELINES = 1024
DEFAULT_STEPS = 512


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_TIMELINES, step_capacity: int = DEFAULT_STEPS):
        self._lock = threading.Lock()
        self._timelines: deque[dict] = deque(maxlen=capacity)
        self._steps: deque[dict] = deque(maxlen=step_capacity)
        self._q: "queue.Queue[RequestTrace]" = queue.Queue()
        self._worker: threading.Thread | None = None
        self._worker_lock = threading.Lock()

    # -- ingest ------------------------------------------------------------

    def record_timeline(self, timeline: dict) -> None:
        with self._lock:
            self._timelines.append(timeline)
        # Hooks must not block (the exporter's is a bounded enqueue); one
        # that raises loses only its own copy.
        for fn in list(_timeline_hooks):
            try:
                fn(timeline)
            except Exception:
                pass

    def submit(self, tr: RequestTrace, observe=None) -> None:
        """Enqueue a finished RequestTrace for off-thread assembly
        (scheduler-thread-safe: one queue put). *observe*, if given,
        runs on the worker thread with the trace before assembly — the
        seam for O(tokens) metric derivation (per-token TPOT observes)
        that must stay off the scheduler thread."""
        self._ensure_worker()
        self._q.put((tr, observe))

    def record_step(self, **fields) -> None:
        """Append one scheduler step record (cheap: dict build + deque
        append; deque appends are atomic under the GIL)."""
        fields.setdefault("t_ms", round(time.time() * 1000, 3))
        self._steps.append(fields)

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._worker_lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._drain, name="flight-recorder", daemon=True
            )
            self._worker.start()

    def _drain(self) -> None:
        while True:
            tr, observe = self._q.get()
            try:
                if observe is not None:
                    observe(tr)
                self.record_timeline(assemble_request_trace(tr))
            except Exception:
                pass  # a malformed trace must never kill the worker
            finally:
                self._q.task_done()

    # -- read --------------------------------------------------------------

    def snapshot(self, limit: int | None = None, wait: float = 1.0) -> list[dict]:
        """Most-recent-first timelines. Waits (bounded) for the assembly
        queue to drain so a caller that just finished a request sees it."""
        deadline = time.monotonic() + wait
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.002)
        with self._lock:
            out = list(self._timelines)
        out.reverse()
        return out[:limit] if limit else out

    def engine_steps(self, limit: int | None = None) -> list[dict]:
        out = list(self._steps)
        out.reverse()
        return out[:limit] if limit else out

    # -- export ------------------------------------------------------------

    def chrome_trace(self, limit: int | None = None) -> dict:
        """Chrome trace-event JSON (``X`` complete events, µs units).
        Each request timeline gets its own tid lane; the scheduler step
        records land on a dedicated lane so per-request phases line up
        against batch composition in Perfetto."""
        events: list[dict] = []
        timelines = self.snapshot(limit)
        for tid, tl in enumerate(timelines, start=1):
            name = f"{tl.get('component', '?')} {tl.get('request_id', '')}".strip()
            events.append({
                "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                "args": {"name": name},
            })
            events.append({
                "ph": "X", "pid": 1, "tid": tid,
                "name": f"request:{tl.get('outcome') or '?'}",
                "ts": round(tl["start_ms"] * 1000, 1),
                "dur": round(tl["duration_ms"] * 1000, 1),
                "args": {
                    "trace_id": tl.get("trace_id", ""),
                    "model": tl.get("model", ""),
                    **tl.get("attrs", {}),
                },
            })
            for ph in tl.get("phases", []):
                events.append({
                    "ph": "X", "pid": 1, "tid": tid, "name": ph["name"],
                    "ts": round(ph["start_ms"] * 1000, 1),
                    "dur": round(ph["duration_ms"] * 1000, 1),
                    "args": ph.get("attrs", {}),
                })
        steps = self.engine_steps()
        if steps:
            events.append({
                "ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
                "args": {"name": "engine scheduler"},
            })
            for st in steps:
                args = {k: v for k, v in st.items() if k not in ("t_ms", "dur_ms", "kind")}
                dur_ms = st.get("dur_ms", 0.0)
                events.append({
                    "ph": "X", "pid": 1, "tid": 0,
                    "name": st.get("kind", "step"),
                    # t_ms is stamped when the step is RECORDED (its
                    # end); the complete-event ts is its start.
                    "ts": round((st["t_ms"] - dur_ms) * 1000, 1),
                    "dur": round(dur_ms * 1000, 1),
                    "args": args,
                })
                # Counter tracks: stalls and occupancy visible INLINE on
                # the timeline (Perfetto renders "C" events as graphs),
                # not only in the /debug/pipeline aggregate.
                ts_end = round(st["t_ms"] * 1000, 1)
                if st.get("kind") != "decode_chunk":
                    continue
                slots = st.get("slots")
                if isinstance(slots, (list, tuple)):
                    events.append({
                        "ph": "C", "pid": 1, "name": "slot occupancy",
                        "ts": ts_end, "args": {"active": len(slots)},
                    })
                if "pages_total" in st and "pages_used" in st:
                    events.append({
                        "ph": "C", "pid": 1, "name": "free KV pages",
                        "ts": ts_end,
                        "args": {"free": st["pages_total"] - st["pages_used"]},
                    })
                if "fetch_wait_ms" in st:
                    events.append({
                        "ph": "C", "pid": 1, "name": "fetch_wait_ms",
                        "ts": ts_end, "args": {"ms": st["fetch_wait_ms"]},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def assemble_request_trace(tr: RequestTrace) -> dict:
    """RequestTrace (raw marks + token stamps) -> timeline dict with the
    canonical engine phases:

    - ``queue``   submit -> prefill dispatch (slot + KV page wait)
    - ``prefill`` prefill dispatch -> first emitted token
    - ``decode``  first token -> terminal (attrs carry per-token
      offsets, so TTFT/TPOT percentiles are recomputable from the
      recorded timeline alone — bench.py does exactly that)
    """
    base = tr.t0_wall - tr.t0_mono

    def ms(t_mono: float) -> float:
        return round((base + t_mono) * 1000, 3)

    end = tr.end_mono if tr.end_mono is not None else time.monotonic()
    phases: list[dict] = []
    t_prefill = tr.first_mark("prefill")
    t_first_tok = tr.tokens[0] if tr.tokens else None
    phases.append({
        "name": "queue",
        "start_ms": ms(tr.t0_mono),
        "duration_ms": round(((t_prefill if t_prefill is not None else end) - tr.t0_mono) * 1000, 3),
        "attrs": {},
    })
    if t_prefill is not None:
        phases.append({
            "name": "prefill",
            "start_ms": ms(t_prefill),
            "duration_ms": round(
                ((t_first_tok if t_first_tok is not None else end) - t_prefill) * 1000, 3
            ),
            "attrs": {k: tr.attrs[k] for k in ("prompt_tokens", "reuse_tokens") if k in tr.attrs},
        })
    if t_first_tok is not None:
        gaps = [
            (b - a) * 1000 for a, b in zip(tr.tokens, tr.tokens[1:])
        ]
        decode_attrs: dict = {
            "tokens": len(tr.tokens),
            # Offsets from request start (ms): TTFT = offsets[0], TPOT =
            # consecutive diffs. Rounded to keep /debug payloads small.
            "token_offsets_ms": [
                round((t - tr.t0_mono) * 1000, 2) for t in tr.tokens
            ],
        }
        if gaps:
            decode_attrs["tpot_ms_mean"] = round(sum(gaps) / len(gaps), 3)
        phases.append({
            "name": "decode",
            "start_ms": ms(t_first_tok),
            "duration_ms": round((end - t_first_tok) * 1000, 3),
            "attrs": decode_attrs,
        })
    return {
        "trace_id": tr.ctx.trace_id,
        "span_id": tr.ctx.span_id,
        "request_id": tr.ctx.request_id,
        "component": tr.component,
        "model": tr.model,
        "outcome": tr.outcome or "unknown",
        "start_ms": ms(tr.t0_mono),
        "duration_ms": round((end - tr.t0_mono) * 1000, 3),
        "attrs": {k: v for k, v in tr.attrs.items()},
        "phases": phases,
    }


default_recorder = FlightRecorder()

_timeline_hooks: list = []


def add_timeline_hook(fn) -> None:
    if fn not in _timeline_hooks:
        _timeline_hooks.append(fn)


def remove_timeline_hook(fn) -> None:
    try:
        _timeline_hooks.remove(fn)
    except ValueError:
        pass


# ---------------------------------------------------------------------------
# The /debug HTTP surface of the engine server.

# Extra named sections merged into the /debug/engine payload (e.g. the
# cold-start phase timeline). Providers are zero-arg callables returning
# JSON-able values; latest registration per key wins, and a failing
# provider drops only its own section — the debug plane must never 500
# because one data source broke.
_engine_debug_sections: dict[str, object] = {}


def register_engine_debug_section(key: str, fn) -> None:
    _engine_debug_sections[key] = fn


def unregister_engine_debug_section(key: str, fn) -> None:
    """Remove *fn* IF it is still the current provider for *key* — the
    seam a dying owner (a stopped engine) uses so this process-global
    dict stops pinning it, without clobbering a newer owner's
    registration (mirrors CallbackGauge.clear_callback)."""
    if _engine_debug_sections.get(key) is fn:
        _engine_debug_sections.pop(key, None)


def handle_debug_request(
    path: str, query: str = "", recorder: FlightRecorder | None = None
) -> tuple[int, str, bytes] | None:
    """Route a GET to the debug surface. Returns (status, content_type,
    body) or None when *path* is not a debug route."""
    rec = recorder or default_recorder
    q = parse_qs(query or "")

    def intq(name, default):
        try:
            return int(q[name][0])
        except (KeyError, ValueError, IndexError):
            return default

    if path == "/debug/requests":
        limit = intq("limit", 50)
        wanted = (q.get("id") or [None])[0]
        tenant = (q.get("tenant") or [None])[0]
        tls = rec.snapshot(limit=None if (wanted or tenant) else limit)
        if wanted:
            tls = [
                t for t in tls
                if wanted in (t.get("trace_id"), t.get("request_id"))
            ]
        if tenant:
            # Tenant-attributed timelines (the proxy/engine stamp the
            # hashed tenant id into span attrs): one tenant's requests
            # isolated from the ring in one GET.
            tls = [
                t for t in tls
                if (t.get("attrs") or {}).get("tenant") == tenant
            ]
        if wanted or tenant:
            tls = tls[:limit]
        body = json.dumps({"requests": tls}).encode()
        return 200, "application/json", body
    if path == "/debug/engine":
        payload = {"steps": rec.engine_steps(intq("limit", 100))}
        # Snapshot: install() can register a section from another
        # thread (a parked replica's attach) mid-GET — iterating the
        # live dict would raise "changed size during iteration".
        for key, fn in list(_engine_debug_sections.items()):
            try:
                payload[key] = fn()
            except Exception:
                pass
        body = json.dumps(payload).encode()
        return 200, "application/json", body
    if path == "/debug/trace":
        body = json.dumps(rec.chrome_trace(intq("limit", 200))).encode()
        return 200, "application/json", body
    return None


# ---------------------------------------------------------------------------
# The /debug index: every debug route the engine server answers, one line
# each. The JAX engine's list, less the operator-side surfaces (incidents,
# canary, forecast), which answer "not installed here" 404s, as on a JAX
# engine, and are not listed.

DEBUG_INDEX: tuple[tuple[str, str], ...] = (
    ("/debug/requests",
     "completed request timelines, most recent first (?limit=&id=&tenant=)"),
    ("/debug/engine",
     "last scheduler step records: batch composition, tokens, kernel, KV pages (?limit=)"),
    ("/debug/trace",
     "Chrome trace-event JSON for Perfetto: request lanes + scheduler lane (?limit=)"),
    ("/debug/faults",
     "fault-injection failpoints: list armed faults; arm/disarm via ?set=/?clear= "
     "(gated by KUBEAI_DEBUG_FAULTS)"),
    ("/debug/tenants",
     "per-tenant usage metering: rolling-window share, tokens, latency attainment, "
     "cost proxies, heavy-hitter ranking"),
    ("/debug/qos",
     "QoS scheduling: per-class queue depth and shed counts, per-tenant fair-share "
     "deficits, preemption counters"),
    ("/debug/history",
     "embedded time-series history: tiered metric trajectories with gap markers "
     "(?series=&since=&step=)"),
    ("/debug/logs",
     "recent WARNING+ structured log records with trace correlation "
     "(?level=&since=&trace=&limit=)"),
    ("/debug/pipeline",
     "windowed decode stall attribution (dispatch/host_overlap/fetch_wait/emit) "
     "+ live MFU/roofline"),
    ("/debug/profile",
     "on-demand torch.profiler trace, CPU and CUDA (?seconds=; gated by "
     "KUBEAI_DEBUG_PROFILE)"),
)

# The operator-side surfaces: an engine answers 404 on each (the JAX
# engine's "not installed on this process").
OPERATOR_SIDE = {
    "/debug/incidents": "no incident recorder installed on this process",
    "/debug/canary": "no canary prober installed on this process",
    "/debug/forecast": "no forecaster installed on this process (operator-side surface)",
}


def debug_index_response() -> tuple[int, str, bytes]:
    """The ``GET /debug`` payload: every route the engine server mounts."""
    body = json.dumps({
        "server": "engine",
        "endpoints": [{"path": p, "description": d} for p, d in DEBUG_INDEX],
    }).encode()
    return 200, "application/json", body


def handle_operator_side_request(path: str) -> tuple[int, str, bytes] | None:
    """The 404 an engine gives for an operator-side surface, or None."""
    msg = OPERATOR_SIDE.get(path)
    if msg is None:
        return None
    return 404, "application/json", json.dumps({"error": {"message": msg}}).encode()
