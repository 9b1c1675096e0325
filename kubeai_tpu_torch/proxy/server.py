"""Operator-facing OpenAI API server (+ metrics/health endpoints).

Port of kubeai_tpu/proxy/server.py: the JAX package's code,
its imports in this package.

Parity: internal/openaiserver (handler.go:20-69, models.go:13-109) mounted
at /openai on :8000, and the manager's metrics server on :8080
(ref: internal/manager/run.go:267-282). Inference routes stream the
proxied upstream body through unchanged (SSE included).
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import time

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.faults import handle_faults_request
from kubeai_tpu_torch.metrics import default_registry, set_build_info
from kubeai_tpu_torch.obs.canary import handle_canary_request
from kubeai_tpu_torch.obs.forecast import handle_forecast_request
from kubeai_tpu_torch.obs.history import handle_history_request
from kubeai_tpu_torch.obs.incidents import handle_incident_request
from kubeai_tpu_torch.obs.logs import handle_logs_request, install_log_ring
from kubeai_tpu_torch.obs.recorder import handle_debug_request
from kubeai_tpu_torch.obs.tenants import handle_tenant_request
from kubeai_tpu_torch.proxy.apiutils import (
    APIError,
    parse_label_selector,
    sanitize_request_id,
)
from kubeai_tpu_torch.qos import handle_qos_request

from kubeai_tpu_torch.obs.logs import get_logger

log = get_logger("kubeai_tpu_torch.openaiserver")

INFERENCE_PATHS = (
    "/openai/v1/chat/completions",
    "/openai/v1/completions",
    "/openai/v1/embeddings",
    "/openai/v1/rerank",
    "/openai/v1/audio/transcriptions",
)


# The operator's GET /debug index: the JAX operator's routes.
# /debug/autoscaler, /debug/fleet and /debug/slo answer once the Manager
# attaches the autoscaler's decision log, the fleet collector and the SLO
# monitor; /debug/canary, /debug/incidents and /debug/forecast once it
# installs the prober, the incident recorder and the forecaster.
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
     "QoS scheduling: per-class queue depth/wait/shed, per-tenant fair-share "
     "deficits, preemption + resume counters"),
    ("/debug/endpoints",
     "per-model circuit-breaker view: endpoint states, consecutive failures, in-flight"),
    ("/debug/routing", "CHWBL ring snapshot + recent pick distribution per model"),
    ("/debug/health",
     "latency health scoring: per-endpoint TTFT p95/EWMA, pick weights, slow-start "
     "ramp, soft-ejection state"),
    ("/debug/autoscaler",
     "scaling decision audit: one record per tick per model/pool (?limit=&model=)"),
    ("/debug/fleet",
     "fleet saturation: per-endpoint engine scrapes, per-model aggregates, capacity headroom"),
    ("/debug/slo",
     "SLO monitor report: attainment + burn rate per objective over the rolling window"),
    ("/debug/incidents",
     "incident black box: triggered cross-layer snapshots (?id= for the full document; "
     "operator-side)"),
    ("/debug/canary", "synthetic canary prober state per model (operator-side)"),
    ("/debug/history",
     "embedded time-series history: tiered metric trajectories with gap markers "
     "(?series=&since=&step=)"),
    ("/debug/forecast",
     "predictive telemetry: per-model forecast curves, prediction intervals, accuracy, "
     "anomaly state (?model=; operator-side)"),
    ("/debug/logs",
     "recent WARNING+ structured log records with trace correlation "
     "(?level=&since=&trace=&limit=)"),
)


def debug_index_response() -> tuple[int, str, bytes]:
    body = json.dumps({
        "server": "operator",
        "endpoints": [{"path": p, "description": d} for p, d in DEBUG_INDEX],
    }).encode()
    return 200, "application/json", body


class OpenAIServer:
    def __init__(self, model_proxy, model_client, host: str = "0.0.0.0", port: int = 8000):
        self.proxy = model_proxy
        self.model_client = model_client
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.port = self.httpd.server_port
        self._thread: threading.Thread | None = None
        # Graceful drain state (mirror of EngineServer's): once draining,
        # /readyz goes 503 (LBs stop routing here), new inference is
        # rejected with Retry-After, and in-flight proxied streams get a
        # budget to finish before stop().
        self.draining = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._stop_lock = threading.Lock()
        self._stopped = False
        # Capacity-observability attachments (wired by the manager):
        # the autoscaler's DecisionLog (/debug/autoscaler), the fleet
        # scrape collector (/debug/fleet), and the SLOMonitor
        # (/debug/slo). Any left None 404s its route.
        self.decision_log = None
        self.fleet = None
        self.slo = None
        # Leader election handle: the autoscaler only ticks on the
        # lease holder, so /debug/autoscaler marks follower replicas'
        # (empty) logs as inactive instead of reading like "the
        # autoscaler never ran".
        self.election = None

    def start(self):
        set_build_info("operator")
        # /debug/logs must capture WARNING+ records from server start,
        # not from its first GET.
        install_log_ring()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("openai server on :%d", self.port)

    def stop(self):
        # Idempotent: drain() calls stop(), and process teardown may too.
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self.draining.set()
        self.httpd.shutdown()

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def _track(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight += delta

    def drain(self, grace: float = 30.0) -> None:
        """Graceful shutdown: flip readiness, reject new inference with
        503 + Retry-After, let in-flight proxied requests finish for up
        to *grace* seconds, then stop the server (severing whatever is
        left — clients see a closed stream, not a hang)."""
        self.draining.set()
        log.info("proxy draining: %d in flight, grace %.1fs", self.inflight(), grace)
        deadline = time.monotonic() + grace
        while self.inflight() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        leftover = self.inflight()
        if leftover:
            log.warning("proxy drain budget expired with %d in flight", leftover)
        self.stop()

    def readiness(self) -> tuple[bool, dict]:
        """Readiness for k8s probes, distinct from the always-ok
        liveness endpoints: this operator pod is ready only when every
        model that should be warm (min_replicas > 0) has at least one
        ready endpoint — until then, routing traffic here just queues
        requests behind cold pods. Models at min_replicas == 0 don't
        gate readiness (scale-from-zero blocking is their contract)."""
        if self.draining.is_set():
            return False, {"status": "draining"}
        cold = []
        try:
            for m in self.model_client.list_all_models():
                if (m.spec.min_replicas or 0) > 0:
                    if not self.proxy.lb.get_all_addresses(m.meta.name):
                        cold.append(m.meta.name)
        except Exception as e:  # store hiccup: fail closed with a reason
            return False, {"status": "not ready", "error": str(e)[:200]}
        if cold:
            return False, {"status": "not ready", "cold_models": sorted(cold)}
        return True, {"status": "ok"}

    def list_models(self, selectors: dict[str, str]) -> list[dict]:
        """Models + adapter-expanded ids (ref: models.go:13-109)."""
        out = []
        for m in self.model_client.list_all_models():
            if selectors and not all(m.meta.labels.get(k) == v for k, v in selectors.items()):
                continue
            features = [
                k[len(mt.LABEL_FEATURE_PREFIX) :]
                for k in m.meta.labels
                if k.startswith(mt.LABEL_FEATURE_PREFIX)
            ]
            out.append(
                {
                    "id": m.meta.name,
                    "object": "model",
                    "owned_by": m.spec.owner or "kubeai-tpu",
                    "features": sorted(features),
                }
            )
            for a in m.spec.adapters:
                out.append(
                    {
                        "id": f"{m.meta.name}_{a.name}",
                        "object": "model",
                        "owned_by": m.spec.owner or "kubeai-tpu",
                        "parent": m.meta.name,
                    }
                )
        return out


def _make_handler(srv: OpenAIServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _json(self, code: int, obj, rid: str = "", headers: dict | None = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if rid:
                self.send_header("X-Request-ID", rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _api_error(self, e: APIError, rid: str = ""):
            if e.code == 429:
                etype = "rate_limit_error"
            elif e.code < 500:
                etype = "invalid_request_error"
            elif e.code == 504:
                etype = "timeout_error"
            else:
                etype = "internal_error"
            self._json(
                e.code, {"error": {"message": e.message, "type": etype}},
                rid=rid, headers=e.headers,
            )

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path in ("/healthz", "/health"):
                self._json(200, {"status": "ok"})
            elif path == "/readyz":
                ready, info = srv.readiness()
                self._json(200 if ready else 503, info)
            elif path == "/debug/endpoints":
                # Passive-health visibility: per-model breaker states.
                self._json(200, {"models": srv.proxy.lb.breaker_snapshot()})
            elif path == "/debug/routing":
                # Routing visibility: CHWBL ring snapshot (vnodes, load
                # factors) + recent pick distribution per model, so
                # PrefixHash-vs-LeastLoad behavior is inspectable live.
                self._json(200, {"models": srv.proxy.lb.routing_snapshot()})
            elif path == "/debug/health":
                # Gray-failure visibility: per-endpoint latency evidence
                # (p95/EWMA), pick weights, slow-start ramp state, and
                # the scoring config — including whether the max-eject
                # fraction disabled scoring (docs/robustness.md).
                self._json(200, {"models": srv.proxy.lb.health_snapshot()})
            elif path == "/debug/autoscaler":
                # Scaling decision audit: why the autoscaler did what it
                # did, one record per tick per model.
                if srv.decision_log is None:
                    return self._json(
                        404, {"error": {"message": "no autoscaler attached"}}
                    )
                q = parse_qs(query or "")
                try:
                    limit = int(q["limit"][0])
                except (KeyError, ValueError, IndexError):
                    limit = 100
                if limit <= 0:  # 0/negative: not "everything", the default page
                    limit = 100
                model = (q.get("model") or [None])[0]
                self._json(
                    200,
                    {
                        # False = this replica's autoscaler is leader-
                        # gated and idle; the lease holder has the log.
                        "active": (
                            srv.election is None
                            or srv.election.is_leader.is_set()
                        ),
                        "decisions": srv.decision_log.snapshot(
                            limit=limit, model=model
                        ),
                    },
                )
            elif path == "/debug/fleet":
                # Fleet saturation: per-endpoint scrapes + per-model
                # aggregates/headroom, reusing the autoscaler tick's
                # scrape when fresh.
                if srv.fleet is None:
                    return self._json(
                        404, {"error": {"message": "no fleet collector attached"}}
                    )
                try:
                    models = [m.meta.name for m in srv.model_client.list_all_models()]
                    self._json(200, srv.fleet.debug_view(models))
                except Exception as e:
                    self._json(500, {"error": {"message": str(e)[:300]}})
            elif path == "/debug/slo":
                if srv.slo is None:
                    return self._json(
                        404, {"error": {"message": "no SLO monitor attached"}}
                    )
                self._json(200, srv.slo.report())
            elif path in ("/debug", "/debug/"):
                # Discoverability: every debug surface this server
                # mounts, with one-line descriptions.
                code, ctype, body = debug_index_response()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path.startswith("/debug/"):
                resp = (
                    handle_faults_request(path, query)
                    or handle_incident_request(path, query)
                    or handle_canary_request(path, query)
                    or handle_tenant_request(path, query)
                    # QoS: operator-side class counters (an in-process
                    # stack also carries the engine queue breakdown).
                    or handle_qos_request(path, query)
                    or handle_history_request(path, query)
                    or handle_forecast_request(path, query)
                    or handle_logs_request(path, query)
                    or handle_debug_request(path, query)
                )
                if resp is None:
                    return self._json(404, {"error": {"message": f"no route {path}"}})
                code, ctype, body = resp
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/metrics":
                body = default_registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/openai/v1/models":
                try:
                    sel = parse_label_selector(self.headers.get("X-Label-Selector"))
                    self._json(200, {"object": "list", "data": srv.list_models(sel)})
                except APIError as e:
                    self._api_error(e)
            else:
                self._json(404, {"error": {"message": f"no route {path}"}})

        def do_POST(self):
            path = self.path.split("?")[0]
            if path not in INFERENCE_PATHS:
                return self._json(404, {"error": {"message": f"no route {path}"}})
            # Read the body BEFORE any early return: on a keep-alive
            # connection, unread body bytes would be parsed as the next
            # request line.
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            if srv.draining.is_set():
                # Drain admission stop (mirror of the engine's): clients
                # retry elsewhere after Retry-After instead of hammering
                # a pod that is about to disappear.
                from kubeai_tpu_torch.proxy.handler import RETRY_AFTER_HINT

                return self._api_error(
                    APIError(
                        503, "server is draining",
                        headers={"Retry-After": RETRY_AFTER_HINT},
                    ),
                )
            cancelled = threading.Event()
            # Fix the correlation id HERE so even proxy-originated error
            # responses (400/404/502) echo it — sanitized, since it goes
            # into headers and log lines.
            rid = sanitize_request_id(self.headers.get("X-Request-ID", "")) or uuid.uuid4().hex
            # The canary exclusion marker is trusted only from the
            # IN-PROCESS prober (which calls proxy.handle directly and
            # never passes through this server): an external client
            # carrying it would opt itself out of tenant accounting and
            # flood detection — strip it at the boundary, like the
            # internal tenant header the proxy strips itself.
            headers = {
                k: v for k, v in self.headers.items()
                if k.lower() not in ("x-request-id", "x-kubeai-canary")
            }
            headers["X-Request-ID"] = rid
            srv._track(1)
            try:
                try:
                    result = srv.proxy.handle(raw, path, headers, cancelled)
                except APIError as e:
                    return self._api_error(e, rid=rid)
                except Exception as e:  # pragma: no cover
                    log.exception("proxy failure")
                    return self._json(500, {"error": {"message": str(e)}}, rid=rid)

                self.send_response(result.status)
                passthrough = {
                    "content-type", "cache-control", "x-request-id", "retry-after",
                }
                for k, v in result.headers:
                    if k.lower() in passthrough:
                        self.send_header(k, v)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in result.body_iter:
                        self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    cancelled.set()
                    result.body_iter.close()
                except Exception:
                    # Upstream died mid-stream (body_iter raised): the
                    # chunked response is unterminated — close the
                    # connection so the client sees truncation, not a
                    # valid-looking short body.
                    log.exception("upstream stream failed mid-body")
                    cancelled.set()
                    self.close_connection = True
            finally:
                srv._track(-1)

    return Handler
