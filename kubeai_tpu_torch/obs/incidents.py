"""The incident black box (port of kubeai_tpu/obs/incidents.py): triggered
snapshots of every debug surface, a bounded ring in memory and on disk,
and ``GET /debug/incidents[?id=]``.

Trigger sources across the stack call ``publish_trigger(name, model=,
detail=, key=)``; it does nothing until a recorder is installed (an
engine process installs none). The operator's ``IncidentRecorder``:

- **Publish is cheap.** Sources publish under their own locks (the
  breaker under its group's condition): ``publish`` only stamps the
  debounce table and enqueues; a worker thread captures, after a short
  settle (``KUBEAI_INCIDENT_SETTLE``, 0.05 s) so the triggering request
  reaches its outcome first.
- **Leader-gated.** A follower's surfaces are cold: it captures nothing.
- **Debounced.** One incident per (trigger, key or model) per
  ``KUBEAI_INCIDENT_DEBOUNCE`` seconds (30), a sliding window: repeats
  are counted on the held incident. Slow-cadence triggers (crash loops,
  gang re-forms, canary failures, traffic anomalies) get
  ``KUBEAI_INCIDENT_SLOW_DEBOUNCE`` (300).
- **Bounded.** A memory ring of *capacity* and a disk ring of at most
  ``KUBEAI_INCIDENT_MAX`` files under ``KUBEAI_INCIDENT_DIR`` (written to a
  temporary name and renamed; the ``incidents.disk`` failpoint fails a
  write, which leaves the incident in memory only). The document is the
  JAX recorder's: each package reads the other's ring.
- **Counter watch** (``watch_tick``, every *watch_interval*): the
  deltas of ``kubeai_pod_restarts_total`` (``crash_loop``),
  ``kubeai_gang_reforms_total`` (``gang_reform``) and
  ``kubeai_engine_requests_total`` by outcome (``error_spike``,
  ``deadline_spike``), per source: the local registry and each scraped
  endpoint's page (*remote_pages*, the fleet's ``parsed_pages_by_addr``).

``standard_sources`` is the operator's set of sections; ``python -m
kubeai_tpu_torch.obs.incident_report`` renders a document.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import tempfile
import threading
import time
from collections import deque

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.faults import fault
from kubeai_tpu_torch.metrics import Counter, default_registry

log = logging.getLogger("kubeai_tpu_torch.incidents")

M_INCIDENTS = default_registry.counter(
    "kubeai_incidents_total", "incident snapshots captured, by trigger source")
M_CAPTURE = default_registry.histogram(
    "kubeai_incident_capture_seconds",
    "wall time to capture one correlated incident snapshot (all sections)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30))
M_SUPPRESSED = default_registry.counter(
    "kubeai_incident_suppressed_total",
    "triggers deduped into an existing incident by the debounce window")


def incident_dir_default() -> str:
    """``KUBEAI_INCIDENT_DIR``, else ``kubeai-incidents`` in the temporary
    directory."""
    return (os.environ.get("KUBEAI_INCIDENT_DIR", "")
            or os.path.join(tempfile.gettempdir(), "kubeai-incidents"))


# ---------------------------------------------------------------------------
# The trigger bus: one module-level recorder.

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
    is installed). Never raises and never blocks: a trigger must not break
    its source's hot path. *key* overrides the debounce key (the model by
    default). Returns the incident id when a capture was scheduled."""
    rec = _recorder
    if rec is None:
        return None
    try:
        return rec.publish(trigger, model=model, detail=detail, key=key)
    except Exception:
        log.exception("incident trigger %s failed to publish", trigger)
        return None


def _counter_sources(name: str, by_addr=None, include_local: bool = True
                     ) -> dict[str, dict[tuple, float]]:
    """Counter *name*'s cumulative values by label set, per source:
    ``"local"`` (this process's registry) and each scraped page by its
    address. Kept apart so an endpoint whose scrape failed for a tick is
    differenced against its own baseline when it comes back. An
    in-process engine is both in the registry and scraped: with pages,
    engine counters pass *include_local=False*."""
    out: dict[str, dict[tuple, float]] = {}
    if include_local:
        m = default_registry.get(name)
        if isinstance(m, Counter):
            out["local"] = dict(m.snapshot())
    if by_addr:
        for addr, page in by_addr.items():
            series: dict[tuple, float] = {}
            for labels, v in page.get(name, []):
                key = tuple(sorted(labels.items()))
                series[key] = series.get(key, 0.0) + v
            out[addr] = series
    return out


class IncidentRecorder:
    """Captures one snapshot of every source per accepted trigger.

    *sources* maps a section name to a zero-argument callable returning
    JSON-able data; a source that raises gives ``{"error": ...}`` for its
    section only. *election* is any object with an ``is_leader`` Event
    (None: always leader). *clock* drives the debounce, *wall* stamps the
    documents."""

    def __init__(self, sources: dict | None = None, incident_dir: str | None = None,
                 capacity: int = 32, max_disk: int | None = None,
                 debounce_seconds: float | None = None, clock=time.monotonic, wall=time.time,
                 election=None, remote_pages=None, watch_interval: float = 10.0):
        self._sources: dict[str, object] = dict(sources or {})
        self.incident_dir = incident_dir if incident_dir is not None else incident_dir_default()
        self.capacity = capacity
        self.max_disk = (max_disk if max_disk is not None
                         else int(env_float("KUBEAI_INCIDENT_MAX", 64)))
        self.debounce = (debounce_seconds if debounce_seconds is not None
                         else env_float("KUBEAI_INCIDENT_DEBOUNCE", 30.0))
        # Triggers that repeat at or past the general window (the 60 s
        # crash-loop backoff, 300 s gang re-form timeout, 30 s canary) get
        # a wider one, never narrower than the general.
        slow = max(self.debounce, env_float("KUBEAI_INCIDENT_SLOW_DEBOUNCE", 300.0))
        self.trigger_debounce = {t: slow for t in (
            "crash_loop", "gang_reform", "canary_error", "canary_corrupt", "traffic_anomaly")}
        self.settle = env_float("KUBEAI_INCIDENT_SETTLE", 0.05)
        self._clock = clock
        self._wall = wall
        self._election = election
        self._remote_pages = remote_pages
        self.watch_interval = watch_interval
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._last_fire: dict[tuple[str, str], float] = {}
        # id -> repeats folded into a held incident.
        self._suppressed: dict[str, int] = {}
        self._last_id: dict[tuple[str, str], str] = {}
        self._seq = 0
        self._q: "queue.Queue[dict | None]" = queue.Queue()
        self._worker: threading.Thread | None = None
        self._worker_lock = threading.Lock()
        # The counter watch: kind -> source -> {label set: cumulative}.
        # None until the first tick seeds it. A source's baseline outlives
        # its absence (a failed scrape) for watch_absent_ticks ticks, so
        # errors counted meanwhile still show as a delta.
        self._watch_base: dict[str, dict[str, dict[tuple, float]]] | None = None
        self._watch_absent: dict[tuple[str, str], int] = {}
        self.watch_absent_ticks = 60
        # A held incident's repeats are written to disk at most once per
        # debounce window; the ids waiting are flushed by the watch loop
        # and by stop().
        self._fold_flushed: dict[str, float] = {}
        self._fold_dirty: set[str] = set()
        self._watch_thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._running = False
        # Set by stop(): a stopped recorder takes no trigger and starts no
        # worker (one never started still takes triggers).
        self._stopped = False
        self.error_min_requests = env_float("KUBEAI_INCIDENT_ERROR_MIN", 5.0)
        self.error_rate_threshold = env_float("KUBEAI_INCIDENT_ERROR_RATE", 0.3)

    def register_source(self, name: str, fn) -> None:
        self._sources[name] = fn

    def _leading(self) -> bool:
        return self._election is None or self._election.is_leader.is_set()

    # -- triggering --------------------------------------------------------

    def publish(self, trigger: str, model: str = "", detail: dict | None = None,
                key: str = "") -> str | None:
        """Accept or debounce one trigger: stamps the table and enqueues,
        no I/O (callers hold their own locks)."""
        if self._stopped or not self._leading():
            return None
        now = self._clock()
        window = self.trigger_debounce.get(trigger, self.debounce)
        with self._lock:
            key = (trigger, key or model)
            last = self._last_fire.get(key)
            if last is not None and now - last < window:
                # A sliding window: a condition that keeps firing folds
                # into one incident until it is quiet for a whole window.
                self._last_fire[key] = now
                M_SUPPRESSED.inc(labels={"trigger": trigger})
                held = self._last_id.get(key)
                if held is not None:
                    self._suppressed[held] = self._suppressed.get(held, 0) + 1
                    # The worker rewrites the document on disk.
                    self._ensure_worker()
                    self._q.put({"fold": held})
                return None
            self._last_fire[key] = now
            self._seq += 1
            incident_id = f"{int(self._wall() * 1000):013d}-{self._seq:04d}-{trigger}"
            self._last_id[key] = incident_id
        self._ensure_worker()
        self._q.put({"id": incident_id, "t": self._wall(), "trigger": trigger, "model": model,
                     "detail": dict(detail or {})})
        return incident_id

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._worker_lock:
            if self._stopped:
                return
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(target=self._drain, name="incident-recorder",
                                            daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            event = self._q.get()
            try:
                if event is None:  # stop()'s sentinel
                    return
                if "fold" in event:
                    self._persist_fold(event["fold"], force=event.get("force", False))
                else:
                    self._capture(event)
            except Exception:
                log.exception("incident capture failed")
            finally:
                self._q.task_done()

    def _persist_fold(self, incident_id: str, force: bool = False) -> None:
        """Rewrite a held incident with its repeat count, at most once per
        debounce window unless *force* (a later flush catches up)."""
        now = self._clock()
        last = self._fold_flushed.get(incident_id)
        if not force and last is not None and now - last < self.debounce:
            self._fold_dirty.add(incident_id)
            return
        doc = None
        with self._lock:
            for d in self._ring:
                if d["id"] == incident_id:
                    d["suppressed_repeats"] = self._suppressed.get(incident_id, 0)
                    doc = dict(d)
                    break
        self._fold_dirty.discard(incident_id)
        if doc is not None:
            self._fold_flushed[incident_id] = now
            self._persist(doc)

    # -- capture -----------------------------------------------------------

    def _capture(self, event: dict) -> None:
        if self.settle > 0:
            time.sleep(self.settle)
        t0 = time.monotonic()
        sections: dict[str, object] = {}
        ok: list[str] = []
        for name, fn in list(self._sources.items()):
            try:
                sections[name] = fn()
                ok.append(name)
            except Exception as e:
                sections[name] = {"error": str(e)[:300]}
        dur = time.monotonic() - t0
        doc = dict(event)
        doc["sections"] = sections
        doc["sections_ok"] = ok
        doc["capture_seconds"] = round(dur, 4)
        with self._lock:
            doc["suppressed_repeats"] = self._suppressed.get(doc["id"], 0)
            # An incident leaving the memory ring takes its bookkeeping.
            evicted = self._ring[0]["id"] if len(self._ring) == self._ring.maxlen else None
            self._ring.append(doc)
            if evicted is not None:
                self._suppressed.pop(evicted, None)
                self._fold_flushed.pop(evicted, None)
                self._fold_dirty.discard(evicted)
                for k in [k for k, v in self._last_id.items() if v == evicted]:
                    del self._last_id[k]
        M_INCIDENTS.inc(labels={"trigger": event["trigger"]})
        M_CAPTURE.observe(dur)
        self._persist(doc)
        log.warning("incident %s captured: trigger=%s model=%s sections=%d/%d in %.2fs",
                    doc["id"], event["trigger"], event["model"] or "-", len(ok), len(sections),
                    dur)

    def _persist(self, doc: dict) -> None:
        """Write *doc* into the disk ring (a temporary name, renamed); a
        failed write leaves it in memory only."""
        if not self.incident_dir:
            return
        final = os.path.join(self.incident_dir, f"incident-{doc['id']}.json")
        tmp = final + ".tmp"
        try:
            fault("incidents.disk")  # FaultError is an OSError
            os.makedirs(self.incident_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, final)
            self._prune_disk()
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            log.warning("incident persist failed (%s); kept in memory only", e)

    def _prune_disk(self) -> None:
        # Ids start with zero-padded epoch ms: name order is time order.
        # Left-over temporary files go too (the worker is the only writer).
        names = []
        for n in os.listdir(self.incident_dir):
            if not n.startswith("incident-"):
                continue
            if n.endswith(".json.tmp"):
                try:
                    os.remove(os.path.join(self.incident_dir, n))
                except OSError:
                    pass
            elif n.endswith(".json"):
                names.append(n)
        names.sort()
        for n in names[: max(len(names) - self.max_disk, 0)]:
            try:
                os.remove(os.path.join(self.incident_dir, n))
            except OSError:
                pass

    # -- counter watch -----------------------------------------------------

    def watch_tick(self) -> None:
        """Difference the watched counters against each source's baseline
        and publish the derived triggers. The first tick, and a source's
        first sighting, only seed; a delta below zero (a restart) is 0."""
        now = self._clock()
        with self._lock:
            # Entries quiet for twice their window can suppress nothing.
            for k in [k for k, t in self._last_fire.items()
                      if now - t > 2 * self.trigger_debounce.get(k[0], self.debounce)]:
                del self._last_fire[k]
        for iid in list(self._fold_dirty):
            last = self._fold_flushed.get(iid)
            if last is None or now - last >= self.debounce:
                self._ensure_worker()
                self._q.put({"fold": iid})
        by_addr = None
        if self._remote_pages is not None:
            try:
                by_addr = self._remote_pages() or {}
            except Exception:
                by_addr = {}
        # Engine counters come from the pages when there are pages; pod
        # restarts are the operator's own.
        engine_local = self._remote_pages is None
        cur = {
            "restarts": _counter_sources("kubeai_pod_restarts_total"),
            "reforms": _counter_sources("kubeai_gang_reforms_total", by_addr,
                                        include_local=engine_local),
            "requests": _counter_sources("kubeai_engine_requests_total", by_addr,
                                         include_local=engine_local),
        }
        base = self._watch_base
        if base is None:
            self._watch_base = {kind: {s: dict(series) for s, series in v.items()}
                                for kind, v in cur.items()}
            return

        def delta(kind: str) -> dict[tuple, float]:
            out: dict[tuple, float] = {}
            for source, series in cur[kind].items():
                base_series = base.get(kind, {}).get(source)
                if base_series is None:
                    continue  # a first sighting only seeds
                for key, v in series.items():
                    d = v - base_series.get(key, 0.0)
                    if d > 0:
                        out[key] = out.get(key, 0.0) + d
            return out

        deltas = {kind: delta(kind) for kind in cur}
        for kind, sources in cur.items():
            bk = base.setdefault(kind, {})
            for s, series in sources.items():
                bk[s] = dict(series)
                self._watch_absent.pop((kind, s), None)
            for s in [s for s in bk if s not in sources]:
                n = self._watch_absent.get((kind, s), 0) + 1
                if n >= self.watch_absent_ticks:
                    del bk[s]
                    self._watch_absent.pop((kind, s), None)
                else:
                    self._watch_absent[(kind, s)] = n
        if not self._leading():
            return

        for key, d in deltas["restarts"].items():
            self.publish("crash_loop", model=dict(key).get("model", ""), detail={"restarts": d})
        reform_d = sum(deltas["reforms"].values())
        if reform_d > 0:
            self.publish("gang_reform", detail={"reforms": reform_d})
        req_d = deltas["requests"]
        total = sum(req_d.values())
        if total >= self.error_min_requests:
            bad = sum(v for key, v in req_d.items() if dict(key).get("outcome") == "error")
            cancelled = sum(v for key, v in req_d.items()
                            if dict(key).get("outcome") == "cancelled")
            if bad / total >= self.error_rate_threshold:
                self.publish("error_spike", detail={
                    "errors": bad, "window_requests": total,
                    "error_rate": round(bad / total, 4)})
            if cancelled / total >= self.error_rate_threshold:
                self.publish("deadline_spike", detail={
                    "cancelled": cancelled, "window_requests": total,
                    "cancelled_rate": round(cancelled / total, 4)})

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._stopped = False
        self._stop_evt.clear()
        self._watch_thread = threading.Thread(target=self._watch_loop, name="incident-watch",
                                              daemon=True)
        self._watch_thread.start()

    def stop(self) -> None:
        self._running = False
        # Refuse triggers first, so a late publish cannot start a worker
        # after the sentinel below was taken.
        self._stopped = True
        self._stop_evt.set()
        if self._watch_thread:
            self._watch_thread.join(timeout=5)
        worker = self._worker
        if worker is not None and worker.is_alive():
            for iid in list(self._fold_dirty):
                self._q.put({"fold": iid, "force": True})
            self._q.put(None)
            worker.join(timeout=5)

    def _watch_loop(self) -> None:
        while self._running:
            if self._stop_evt.wait(self.watch_interval):
                return
            try:
                self.watch_tick()
            except Exception:
                log.exception("incident counter watch failed")

    def wait_idle(self, timeout: float = 5.0) -> bool:
        """Wait (at most *timeout*) until every enqueued capture landed."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        return not self._q.unfinished_tasks

    # -- read --------------------------------------------------------------

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """Incident summaries, newest first (sections by name only)."""
        with self._lock:
            docs = list(self._ring)
        docs.reverse()
        if limit:
            docs = docs[:limit]
        return [{"id": d["id"], "t": d["t"], "trigger": d["trigger"], "model": d["model"],
                 "detail": d["detail"], "sections": sorted(d["sections"]),
                 "sections_ok": d["sections_ok"], "capture_seconds": d["capture_seconds"],
                 "suppressed_repeats": self._suppressed.get(d["id"], 0)}
                for d in docs]

    def get(self, incident_id: str) -> dict | None:
        """The full document: from the memory ring, else the disk ring."""
        with self._lock:
            for d in self._ring:
                if d["id"] == incident_id:
                    doc = dict(d)
                    doc["suppressed_repeats"] = self._suppressed.get(incident_id, 0)
                    return doc
        # The id comes from ?id=: only the id alphabet may become a path.
        if self.incident_dir and incident_id and all(
                c.isalnum() or c in "_-" for c in incident_id):
            path = os.path.join(self.incident_dir, f"incident-{incident_id}.json")
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None
        return None

    def disk_index(self) -> list[str]:
        """The ids in the disk ring, newest first."""
        if not self.incident_dir or not os.path.isdir(self.incident_dir):
            return []
        try:
            names = sorted((n for n in os.listdir(self.incident_dir)
                            if n.startswith("incident-") and n.endswith(".json")),
                           reverse=True)
        except OSError:
            return []
        return [n[len("incident-"):-len(".json")] for n in names]

    def report(self) -> dict:
        """The /debug/incidents list payload."""
        return {
            "active": self._leading(),
            "incident_dir": self.incident_dir,
            "debounce_seconds": self.debounce,
            "capacity": {"memory": self.capacity, "disk": self.max_disk},
            "incidents": self.snapshot(),
            "disk": self.disk_index(),
        }


# ---------------------------------------------------------------------------
# Sources


def engine_debug_source(addrs_fn, timeout: float = 2.0, per_model_cap: int = 4):
    """A source that GETs each endpoint's ``/debug/engine?limit=25`` step
    records and ``/debug/pipeline`` stall report, at most *per_model_cap*
    endpoints a model, over the fleet's shared scrape pool (a capture
    takes its slowest endpoint's time). *addrs_fn* gives model ->
    [addr]; an unreachable endpoint gives its error."""
    import urllib.request

    def fetch_one(item: tuple[str, str]) -> tuple[str, str, dict]:
        model, addr = item
        base = addr if addr.startswith("http") else f"http://{addr}"
        rec: dict[str, object] = {}
        for key, p in (("engine", "/debug/engine?limit=25"), ("pipeline", "/debug/pipeline")):
            try:
                with urllib.request.urlopen(base + p, timeout=timeout) as r:
                    rec[key] = json.loads(r.read())
            except Exception as e:
                rec[key] = {"error": str(e)[:200]}
        return model, addr, rec

    def fetch():
        from kubeai_tpu_torch.autoscaler.fleet import shared_scrape_executor

        try:
            by_model = addrs_fn() or {}
        except Exception as e:
            return {"error": str(e)[:200]}
        items = [(model, addr) for model, addrs in by_model.items()
                 for addr in list(addrs)[:per_model_cap]]
        out: dict[str, dict] = {}
        for model, addr, rec in shared_scrape_executor().map(fetch_one, items):
            out.setdefault(model, {})[addr] = rec
        return out

    return fetch


def standard_sources(lb, model_client, fleet=None, decision_log=None, slo=None, canary=None,
                     history=None, forecaster=None, trace_limit: int = 30) -> dict:
    """The operator's sections, each read at capture time: endpoints,
    requests, engines, tenants, logs, routing, and those of the given
    SLO monitor, fleet, decision log, canary, history and forecaster."""
    from kubeai_tpu_torch.obs.logs import logs_incident_source
    from kubeai_tpu_torch.obs.recorder import default_recorder
    from kubeai_tpu_torch.obs.tenants import default_accountant

    def model_names() -> list[str]:
        return [m.meta.name for m in model_client.list_all_models()]

    sources: dict[str, object] = {
        "endpoints": lambda: {"models": lb.breaker_snapshot()},
        "requests": lambda: {"requests": default_recorder.snapshot(limit=trace_limit)},
        "engines": engine_debug_source(
            lambda: {m: lb.get_all_addresses(m) for m in model_names()}),
        "tenants": default_accountant.report,
        "logs": logs_incident_source(limit=2 * trace_limit),
    }
    if hasattr(lb, "routing_snapshot"):
        sources["routing"] = lb.routing_snapshot
    if slo is not None:
        sources["slo"] = slo.report
    if fleet is not None:
        sources["fleet"] = lambda: fleet.debug_view(model_names())
    if decision_log is not None:
        sources["autoscaler"] = lambda: {"decisions": decision_log.snapshot(limit=50)}
    if canary is not None:
        sources["canary"] = canary.report
    if history is not None:
        sources["history"] = history.context_block
    if forecaster is not None:
        sources["forecast"] = lambda: forecaster.report(points=32)
    return sources


# ---------------------------------------------------------------------------
# GET /debug/incidents (the operator's proxy chains it; an engine answers
# 404 from obs/recorder.py's operator-side list).


def handle_incident_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    if path != "/debug/incidents":
        return None
    rec = _recorder
    if rec is None:
        return 404, "application/json", json.dumps(
            {"error": {"message": "no incident recorder installed on this process"}}).encode()
    from urllib.parse import parse_qs

    wanted = (parse_qs(query or "").get("id") or [None])[0]
    if wanted:
        doc = rec.get(wanted)
        if doc is None:
            return 404, "application/json", json.dumps(
                {"error": {"message": f"no incident {wanted!r}"}}).encode()
        return 200, "application/json", json.dumps(doc).encode()
    return 200, "application/json", json.dumps(rec.report()).encode()
