"""OpenAI-compatible HTTP server over the port's engine (port of
kubeai_tpu/engine/server.py).

    GET  /health /healthz        liveness (+ engine readiness, role; a parked
                                 replica's ``parked`` and ``attach`` state)
    GET  /readyz                 readiness: 200 once the engine runs, 503
                                 "draining" from the start of a drain, 503
                                 "parked" until an attach has finished
    GET  /metrics                Prometheus text (the JAX engine's families)
    GET  /debug                  index of the debug routes below
    GET  /debug/requests         request timelines (?limit=&id=&tenant=)
    GET  /debug/engine           scheduler step records (?limit=)
    GET  /debug/trace            Chrome trace-event JSON (?limit=)
    GET  /debug/faults           failpoints (?set=NAME=SPEC, ?clear=NAME|all)
    GET  /debug/pipeline         stall attribution, MFU, roofline
    GET  /debug/profile          torch.profiler trace (?seconds=)
    GET  /debug/qos              the QoS queue's classes and lanes
    GET  /debug/tenants          per-tenant cost: slot- and KV-page-seconds
    GET  /debug/history          metric history (?series=&since=&step=)
    GET  /debug/logs             recent WARNING+ records (?level=&since=&trace=)
    GET  /v1/models              the served model + loaded adapters
    GET  /v1/kv/<key>            a parked request's KV blob (peer transfer)
    POST /v1/completions         (+ SSE streaming; n from 1 to 16)
    POST /v1/chat/completions    (+ SSE streaming; n from 1 to 16)
    POST /v1/embeddings          mean-pooled, normalised hidden states
    POST /v1/load_lora_adapter   {lora_name, lora_path}
    POST /v1/unload_lora_adapter {lora_name}
    POST /v1/attach              {args} (+ model, served_model_name): a
                                 parked replica loads that model (202, or
                                 409 when attached or attaching)

Responses keep the JAX server's shapes: the same ``usage`` block, the
completions ``logprobs`` object (tokens / token_logprobs / top_logprobs)
and the chat ``logprobs.content`` list. A request whose ``model`` names a
loaded adapter runs with it; any other ``model`` serves the base model,
as in the JAX server. ``n`` > 1 submits one engine request per choice
(the prefix cache shares the prompt; choice i samples with ``seed + i``).

The engine's side of the operator's contracts, as the JAX server speaks
them: ``X-Request-Deadline`` (seconds left) becomes the request's
deadline and a spent one answers 504; SIGTERM drains (``--drain-grace``:
``/readyz`` turns 503, new ``/v1/*`` work gets 429, requests in flight
finish or are failed at the grace's end); ``X-Request-ID`` and
``traceparent`` join the engine's timeline to the proxy's; chaos drills
arm ``engine.*`` failpoints over ``/debug/faults`` (``KUBEAI_DEBUG_FAULTS=1``).
``X-Priority``, ``X-Preemptible`` and the tenant header place a request
in the QoS queue (a shed request gets 429 with a Retry-After scaled by
its class's backlog); ``--role prefill --handoff-budget N`` caps a
stream the proxy planned to hand off (``X-Handoff-Planned: 1``) at N
tokens and finishes it ``"handoff"``; a preempted or handed-off stream
parks its KV and carries the offer on its marker chunk as
``kubeai_kv``; a resume (``X-Resume-Tokens``) carrying the ``X-KV-*``
offer imports the blob (from this replica's park store, or fetched from
the source's ``/v1/kv/<key>``) instead of re-running the prefill.

A parked replica (``--parked``, the JAX operator's ``ParkedPool``) starts
with no model: its HTTP surface is up, ``/readyz`` answers 503 "parked",
and a POST ``/v1/attach`` with the desired pod's arguments starts the
model on a worker thread (states ``parked``, ``attaching``, ``attached``,
``failed: ...``; a failed attach may be retried). With ``--park-config``
(default ``KUBEAI_PARK_CONFIG``) it warms in the background at park time
(engine/coldstart.py ``park``): the config's kernel libraries are built
and loaded, and an engine over zero weights at its shapes warms up,
capturing the decode graph. An attach whose configuration equals the park
config's adopts that engine and copies its weights in place; any other
builds afresh. ``KUBEAI_COMPILE_CACHE`` names a library directory every
replica shares. Every start stamps its phases (``/debug/engine``'s
``cold_start``, ``kubeai_engine_cold_start_seconds``).

Tensor parallelism (``--tensor-parallel-size N``): N ranks, one process
each, each holding its shard of the model (parallel/sharding.py). On a
multi-host gang the controller stamps ``TPU_WORKER_HOSTNAMES``,
``TPU_WORKER_ID``, ``TPU_COORDINATOR_PORT``, ``KUBEAI_GANG_SECRET`` and
``KUBEAI_GANG_PORT`` (the JAX server's contract); each host runs
N / hosts ranks, rank = host * (N / hosts) + local rank, and the pod's
process starts its host's other local ranks itself. Without that
environment, N > 1 starts N - 1 local ranks over loopback with a secret
it generates. The ranks meet at a TCPStore on host 0's coordinator port
(parallel/group.py; nccl when every rank has a card, gloo when they
share one or on the CPU). Rank 0 alone binds the API port and serves
inference; it publishes every dispatch to the others (engine/gang.py).
Each other rank answers ``/health``, ``/readyz``, ``/metrics`` and
``/debug/gang`` on ``--port`` plus its local rank, and nothing else.
``--parked`` and ``test:`` models are refused on a gang, as in the JAX
server.

Telemetry, as the JAX engine server has it: each tenanted request's
slot- and KV-page-seconds go into obs/tenants.py's accountant
(``/debug/tenants``, ``kubeai_tenant_*``); ``start()`` installs a history
store under ``<KUBEAI_HISTORY_DIR>/engine`` with a registry sampler
(``/debug/history``) unless the process has one, and an OTLP exporter when
``KUBEAI_OTLP_ENDPOINT`` is set; ``stop()`` removes what it installed. A
gang follower rank installs none of them and answers ``/debug/tenants``
and ``/debug/history`` 404, as the JAX server's ``run_follower`` does. The
operator-side surfaces (``/debug/incidents``, ``/canary``, ``/forecast``)
answer 404 "not installed", as on a JAX engine.

Run: ``python -m kubeai_tpu_torch.engine.server --model preset:llama-3.1-8b``
(on the card; ``--device cpu --model test:tiny`` for a CPU smoke run).
The presets, random weights at published widths: ``llama-3.1-8b``,
``qwen2.5-7b``, ``gemma-2b``, ``gemma2-2b`` and ``mixtral-8x7b``
(Mixtral's 32 bf16 layers need more than one 80 GB card; chip_smoke.py
serves 16 of them through ``build_engine(..., num_layers=16)``).
``--model <dir>`` serves an HF-format checkpoint directory
(engine/weights.py) with its own ``tokenizer.json`` and chat template
where it has them (engine/tokenizer.py), and ``--quantization int8`` serves a preset, a
checkpoint or test:tiny with int8 weights through the W8A16 kernels.
``--kv-cache-dtype fp8|int8`` stores the paged KV pool at one byte per
element; the paged kernels dequantize it; ``--kv-pages`` sizes the pool.
``--warmup`` (default on with KUBEAI_ENGINE_WARMUP=1, as in the JAX
server) runs every step shape, the decode chunk's CUDA graph capture
included, before serving.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import gc
import json
import os
import queue
import re
import secrets
import signal
import socket
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from kubeai_tpu_torch import resolve_device
from kubeai_tpu_torch.engine import kvstate
from kubeai_tpu_torch.engine.coldstart import (
    BackgroundWarm,
    ColdStartTimeline,
    StartSpec,
    park,
    setup_compile_cache,
    start_engine,
    start_spec,
)
from kubeai_tpu_torch.engine.core import (
    TEST_PREFILL_BUCKETS,
    Engine,
    EngineConfig,
    build_test_engine,
    preset_config,
    preset_params,
)
from kubeai_tpu_torch.engine.gang import DEFAULT_GANG_PORT
from kubeai_tpu_torch.engine.lora import stage_remote
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import load_engine_from_path
from kubeai_tpu_torch.faults import FaultError, fault, handle_faults_request, set_thread_scope
from kubeai_tpu_torch.metrics import default_registry, set_build_info
from kubeai_tpu_torch.obs.history import (
    HistoryStore,
    RegistrySampler,
    handle_history_request,
    history_dir_default,
    install_history,
    installed_history,
    uninstall_history,
)
from kubeai_tpu_torch.obs.logs import (
    bind_log_context,
    get_logger,
    handle_logs_request,
    install_log_ring,
    set_log_context,
    setup_logging,
)
from kubeai_tpu_torch.obs.otel import maybe_start_exporter, uninstall_exporter
from kubeai_tpu_torch.obs.perf import handle_perf_request
from kubeai_tpu_torch.obs.recorder import (
    debug_index_response,
    handle_debug_request,
    handle_operator_side_request,
)
from kubeai_tpu_torch.obs.tenants import TENANT_HEADER, handle_tenant_request, sanitize_tenant
from kubeai_tpu_torch.obs.trace import extract_context, sanitize_request_id
from kubeai_tpu_torch.parallel.group import (
    DEFAULT_COORDINATOR_PORT,
    choose_backend,
    init_tp_group,
)
from kubeai_tpu_torch.qos import (
    DEFAULT_CLASS,
    PREEMPTIBLE_HEADER,
    PRIORITY_HEADER,
    normalize_priority,
)
from kubeai_tpu_torch.qos.stats import handle_qos_request

log = get_logger("kubeai_tpu_torch.engine.server")

STREAM_WAIT_S = 600.0
# Retry-After (seconds) of a 429 that no class backlog scales (draining).
RETRY_AFTER_HINT = "1"

M_HANDOFF_CAPPED = default_registry.counter(
    "kubeai_engine_handoff_capped_total",
    "streamed generations a prefill-role replica capped at its handoff "
    "budget (finish_reason rewritten to 'handoff' for the proxy cutover)",
)
M_RESUMED = default_registry.counter(
    "kubeai_engine_resumed_requests_total",
    "requests arriving with X-Resume-Tokens (decode-side of a handoff, "
    "or a mid-stream crash replay): the deterministic prefix is "
    "regenerated here and the proxy suppresses it",
)


class EngineServer:
    def __init__(self, engine: Engine | None, model_name: str, host: str = "0.0.0.0",
                 port: int = 8000, role: str = "", handoff_budget: int = 0,
                 drain_grace: float = 30.0, device: str | None = None):
        # engine=None is a PARKED replica: HTTP up, no weights, /readyz 503
        # until a POST /v1/attach starts a model (scale-from-zero attaches
        # to a parked pod instead of spawning a process).
        self.engine = engine
        self.model_name = model_name
        self._attach_lock = threading.Lock()
        self._attach_state = "parked" if engine is None else "attached"
        # The park-time warm in flight (coldstart.BackgroundWarm): an attach
        # joins it first, and adopts the engine it leaves in park_engine
        # when the configurations match.
        self.park_warm: BackgroundWarm | None = None
        self.park_engine: Engine | None = None
        self.park_timeline: ColdStartTimeline | None = None
        # The device an attach runs on unless its args name one (the
        # parked process's own --device).
        self.device = device
        # Disaggregated role ("prefill" | "decode" | "" unified): a prefill
        # replica caps planned handoff streams at handoff_budget tokens.
        self.role = role
        self.handoff_budget = handoff_budget if role == "prefill" else 0
        # Graceful drain: once set, /readyz answers 503 (routing stops),
        # new /v1/* work gets 429 + Retry-After, and requests in flight get
        # up to drain_grace seconds before the hard stop fails the rest.
        self.draining = threading.Event()
        self.drain_grace = drain_grace
        self._stop_lock = threading.Lock()
        self._stopped = False
        self.stopped_event = threading.Event()  # set once stop() is done
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_port
        # The address peers fetch parked KV from (GET /v1/kv/<key>): a
        # wildcard bind falls back to loopback; pods set
        # KUBEAI_KV_ADVERTISE to their own address.
        host_adv = os.environ.get("KUBEAI_KV_ADVERTISE", "") or (
            "127.0.0.1" if host in ("", "0.0.0.0", "::") else host)
        self.kv_advertise = f"{host_adv}:{self.port}"
        self._thread: threading.Thread | None = None
        self.adapters: dict[str, str] = {}  # name -> path
        self._adapters_lock = threading.Lock()
        # The telemetry start() installed (stop() removes only that).
        self._history: HistoryStore | None = None
        self._history_sampler: RegistrySampler | None = None
        self._otel = None

    def start(self) -> None:
        set_build_info("engine")
        # The WARNING+ ring from the start, so /debug/logs holds early
        # failures.
        install_log_ring()
        self._otel = maybe_start_exporter("kubeai-engine")
        if installed_history() is None:
            self._history = HistoryStore(history_dir=os.path.join(history_dir_default(), "engine"))
            self._history_sampler = RegistrySampler(self._history)
            install_history(self._history)
            self._history_sampler.start()
        if self.engine is not None:
            self._start_engine(self.engine)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        tl = getattr(self.engine, "cold_start_timeline", None)
        if tl is not None:
            tl.ready()
        log.info("engine server for %s on :%d", self.model_name, self.port)

    def _start_engine(self, engine: Engine) -> None:
        engine.kv_advertise = self.kv_advertise
        # The scheduler thread's failpoint scope: engine.step@PORT etc.
        engine.fault_scope = str(self.port)
        engine.start()

    def start_park_warm(self, path: str, engine_args: list[str]) -> None:
        """Warm for *path* under *engine_args* in the background
        (coldstart.park): registered before the server accepts attaches,
        so an early attach joins it instead of racing its builds."""
        self.park_timeline = ColdStartTimeline().install()

        def run():
            stats, self.park_engine = park(path, engine_args, timeline=self.park_timeline)
            return stats

        self.park_warm = BackgroundWarm(run)

    def attach(self, args_list: list[str], warmup: bool | None = None) -> tuple[bool, str]:
        """Attach a model to a parked replica: parse engine-server args
        (the Model's pod args; ``--host``/``--port`` are this process's and
        ignored, unknown args logged), start the engine on a worker thread
        and flip /readyz. Returns (accepted, message); readiness is the
        completion signal, and a failure leaves ``failed: ...`` in
        /readyz and /health (retryable)."""
        with self._attach_lock:
            if self.engine is not None:
                return False, f"model {self.model_name!r} already attached"
            if self._attach_state == "attaching":
                return False, "attach already in progress"
            self._attach_state = "attaching"
        if warmup is None:
            # Warm up by default: the parked pod exists to make ready mean
            # ready (an adopted park engine warmed up at park time).
            warmup = os.environ.get("KUBEAI_ATTACH_WARMUP", "1") == "1"

        def run():
            taken = None  # the park engine, until adopted or freed
            try:
                if self.park_warm is not None:
                    # The park's builds land before this start reads them.
                    self.park_warm.join()
                parser = make_arg_parser(require_model=True)
                parser.set_defaults(device=self.device)
                a, unknown = parser.parse_known_args(args_list)
                if unknown:
                    log.info("attach ignoring unknown args: %s", unknown)
                if a.model is None:
                    raise ValueError("attach args must include --model")
                taken, self.park_engine = self.park_engine, None
                had_park = taken is not None
                if taken is not None and (
                        start_spec(a.model, args_list, device=self.device)[0].key()
                        != taken.park_key):
                    # Another model: free the park engine before building.
                    taken = None
                    gc.collect()
                    if torch.cuda.is_available():
                        torch.cuda.empty_cache()
                engine, name = build_engine_from_args(a, warmup=warmup, park_engine=taken)
                taken = None
                self._start_engine(engine)
                with self._attach_lock:
                    self.model_name = name
                    self.engine = engine
                    self._attach_state = "attached"
                tl = getattr(engine, "cold_start_timeline", None)
                if tl is not None:
                    if had_park:
                        tl.attrs.setdefault("adopted_park_engine", False)
                    tl.ready()
                log.info("parked replica attached model %s", name)
            except (Exception, SystemExit) as e:  # argparse's SystemExit too
                log.exception("attach failed")
                if taken is not None:
                    # load_params_ checks before it writes: still a park
                    # engine, which a retry may adopt.
                    self.park_engine = taken
                with self._attach_lock:
                    # Retryable: the pod stays not-ready, and the operator's
                    # pool deletes it or a caller attaches again.
                    self._attach_state = f"failed: {e}"

        threading.Thread(target=run, name="engine-attach", daemon=True).start()
        return True, "attaching"

    def stop(self) -> None:
        """Idempotent hard stop: admission first (the draining flag),
        then the engine (requests in flight get terminal events, so their
        handlers finish), then the HTTP server, in a finally."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self.draining.set()
        try:
            if self.engine is not None:
                self.engine.stop()
        finally:
            if self._history_sampler is not None:
                self._history_sampler.stop()  # the last flush
                self._history_sampler = None
            if self._history is not None:
                uninstall_history(self._history)
                self._history = None
            if self._otel is not None:
                self._otel.stop()
                uninstall_exporter(self._otel)
                self._otel = None
            self.httpd.shutdown()
            self.httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=10)
            self.stopped_event.set()

    def drain(self, grace: float | None = None) -> None:
        """The SIGTERM path: stop admission, let the requests in flight
        finish within *grace* seconds (``drain_grace`` by default), then
        stop(), which fails what remains."""
        grace = self.drain_grace if grace is None else grace
        self.draining.set()
        if self.engine is None:
            return self.stop()  # parked: nothing in flight
        log.info("engine draining: %d active slots, %d queued, grace %.1fs",
                 self.engine.active_slots(), self.engine.queue_depth(), grace)
        deadline = time.monotonic() + grace
        # requests_in_system(), not queue + slots: those miss a request
        # between the queue and its slot.
        while self.engine.requests_in_system() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        leftover = self.engine.requests_in_system()
        if leftover:
            log.warning("drain budget expired with %d requests in flight", leftover)
        self.stop()

    def install_signal_handlers(self) -> None:
        """SIGTERM drains instead of killing streams mid-flight. Main
        thread only (the signal module's rule); the drain runs on a
        thread of its own so the handler returns at once."""

        def on_term(signum, frame):
            threading.Thread(target=self.drain, daemon=True).start()

        signal.signal(signal.SIGTERM, on_term)

    _ADAPTER_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,128}$")

    def load_adapter(self, name: str, path: str) -> tuple[bool, str]:
        """(ok, status) of loading adapter *name* from *path* (the JAX
        server's route: a name loaded from another path is refused, a
        failed load forgets the name)."""
        if not self._ADAPTER_NAME_RE.match(name or ""):
            return False, f"invalid adapter name {name!r}"
        with self._adapters_lock:
            if name in self.adapters and self.adapters[name] != path:
                return False, f"adapter {name} already loaded from {self.adapters[name]}"
            self.adapters[name] = path
        try:
            self.engine.load_adapter(name, path)
        except Exception as e:  # reported to the caller
            with self._adapters_lock:
                self.adapters.pop(name, None)
            return False, str(e)
        return True, "ok"

    def unload_adapter(self, name: str) -> tuple[bool, str]:
        """Idempotent, as the reference's client expects."""
        with self._adapters_lock:
            existed = self.adapters.pop(name, None) is not None
        if existed:
            self.engine.unload_adapter(name)
        return True, "ok" if existed else "adapter was not loaded"


def _cancel_all(reqs) -> None:
    for r in reqs:
        r.cancelled.set()


def _make_handler(srv: EngineServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, code: int, obj, headers: dict | None = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str, etype: str = "invalid_request_error", headers=None):
            self._json(code, {"error": {"message": msg, "type": etype}}, headers=headers)

        def _raw(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _saturated(self, msg: str, retry_after: int | None = None):
            """429 + Retry-After: load, not failure (SDKs back off)."""
            return self._error(
                429, msg + "; retry after backoff", "rate_limit_error",
                headers={"Retry-After": str(retry_after) if retry_after else RETRY_AFTER_HINT})

        def do_GET(self):
            # Failpoints fired on this thread also fire their @PORT twins.
            set_thread_scope(srv.port)
            path, _, query = self.path.partition("?")
            if path in ("/health", "/healthz"):
                if srv.engine is None:
                    # Parked (or mid-attach): alive, serving nothing.
                    return self._json(200, {"status": "ok", "model": srv.model_name,
                                            "parked": True, "attach": srv._attach_state})
                ready = srv.engine.is_ready()
                body = {"status": "ok" if ready else "engine not ready",
                        "model": srv.model_name}
                if srv.role:
                    body["role"] = srv.role
                self._json(200 if ready else 503, body)
            elif path == "/readyz":
                # 503 from the start of a drain, so routing stops before
                # the pod goes away.
                if srv.engine is None:
                    self._json(503, {"status": "parked", "attach": srv._attach_state})
                elif srv.draining.is_set():
                    self._json(503, {"status": "draining", "model": srv.model_name})
                elif srv.engine.is_ready():
                    body = {"status": "ok", "model": srv.model_name}
                    if srv.role:
                        body["role"] = srv.role
                    self._json(200, body)
                else:
                    self._json(503, {"status": "engine not ready", "model": srv.model_name})
            elif path in ("/debug", "/debug/"):
                self._raw(*debug_index_response())
            elif path.startswith("/debug/"):
                resp = (handle_faults_request(path, query)
                        or handle_perf_request(path, query, engine=srv.engine)
                        or handle_tenant_request(path, query)
                        or handle_qos_request(path, query)
                        or handle_history_request(path, query)
                        or handle_logs_request(path, query)
                        or handle_debug_request(path, query)
                        or handle_operator_side_request(path))
                if resp is None:
                    return self._error(404, f"no route {path}")
                self._raw(*resp)
            elif path == "/metrics":
                self._raw(200, "text/plain; version=0.0.4", default_registry.render().encode())
            elif path.startswith("/v1/kv/"):
                # A peer pulls a parked request's blob; a miss is definitive
                # (the caller replays), so this never blocks or retries.
                key = path[len("/v1/kv/"):]
                entry = srv.engine.kv_park.get(key) if srv.engine is not None else None
                if entry is None:
                    return self._error(404, f"no parked KV under {key!r}")
                kvstate.M_KV_TRANSFER.inc(len(entry.blob), labels={"direction": "tx"})
                self._raw(200, "application/octet-stream", entry.blob)
            elif path == "/v1/models":
                models = [{"id": srv.model_name, "object": "model", "owned_by": "kubeai-tpu"}]
                for name in sorted(srv.adapters):
                    models.append({"id": name, "object": "model", "owned_by": "kubeai-tpu",
                                   "parent": srv.model_name})
                self._json(200, {"object": "list", "data": models})
            else:
                self._error(404, f"no route {path}")

        def do_POST(self):
            set_thread_scope(srv.port)
            path = self.path.split("?")[0]
            # The proxy's correlation id, sanitized (this port is reachable
            # without the proxy); the trace id derives from it when no
            # traceparent came, so both timelines join.
            rid = sanitize_request_id(self.headers.get("X-Request-ID", ""))
            trace_ctx = extract_context(self.headers, fallback_request_id=rid)
            # One request per handler thread: replace the log context.
            set_log_context(trace_id=trace_ctx.trace_id, span_id=trace_ctx.span_id,
                            request_id=rid, model=srv.model_name)
            if rid and path.startswith("/v1/"):
                log.info("request id=%s engine=%s path=%s", rid, srv.model_name, path)
            # The proxy's remaining budget in seconds, made an absolute
            # deadline here, so queue wait counts against it.
            deadline = None
            dl_hdr = self.headers.get("X-Request-Deadline", "")
            if dl_hdr:
                try:
                    deadline = time.monotonic() + max(float(dl_hdr), 0.0)
                except ValueError:
                    pass  # an unparseable deadline is no deadline
            # The proxy's stamps (it strips client copies): tenant lane,
            # class (an unknown value serves as standard), and whether the
            # slot may be seized, never together with a planned handoff.
            tenant = sanitize_tenant(self.headers.get(TENANT_HEADER, ""))
            priority = normalize_priority(self.headers.get(PRIORITY_HEADER, "")) or DEFAULT_CLASS
            bind_log_context(tenant=tenant, qos_class=priority)
            preemptible = (self.headers.get(PREEMPTIBLE_HEADER) == "1"
                           and self.headers.get("X-Handoff-Planned") != "1")
            resume_tokens = 0
            try:
                resume_tokens = max(int(self.headers.get("X-Resume-Tokens", "") or 0), 0)
            except ValueError:
                pass
            if resume_tokens:
                M_RESUMED.inc()
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._error(400, f"invalid JSON: {e}")
            if not isinstance(body, dict):
                return self._error(400, "request body must be a JSON object")
            if srv.draining.is_set() and path.startswith("/v1/") and path != "/v1/models":
                # In-flight work finishes; new work goes elsewhere (the
                # proxy retries another replica).
                return self._saturated("server is draining")
            if path == "/v1/attach":
                # The pod's args (Model.spec.args included); model and
                # served_model_name are conveniences for an attach by hand.
                args_list = [str(x) for x in (body.get("args") or [])]
                if body.get("model") and "--model" not in args_list:
                    args_list = ["--model", str(body["model"])] + args_list
                if body.get("served_model_name") and "--served-model-name" not in args_list:
                    args_list += ["--served-model-name", str(body["served_model_name"])]
                ok, msg = srv.attach(args_list)
                return self._json(202 if ok else 409, {"status": msg})
            if srv.engine is None and path.startswith("/v1/"):
                return self._error(503, "no model attached (parked replica)",
                                   "service_unavailable")
            ctx = dict(trace_ctx=trace_ctx, deadline=deadline, tenant=tenant,
                       priority=priority, preemptible=preemptible, resume_tokens=resume_tokens)
            try:
                if path == "/v1/completions":
                    self._completions(body, chat=False, **ctx)
                elif path == "/v1/chat/completions":
                    self._completions(body, chat=True, **ctx)
                elif path == "/v1/embeddings":
                    self._embeddings(body)
                elif path == "/v1/load_lora_adapter":
                    ok, msg = srv.load_adapter(str(body.get("lora_name", "")),
                                               str(body.get("lora_path", "")))
                    self._json(200 if ok else 400, {"status": msg})
                elif path == "/v1/unload_lora_adapter":
                    ok, msg = srv.unload_adapter(str(body.get("lora_name", "")))
                    self._json(200, {"status": msg})
                else:
                    self._error(404, f"no route {path}")
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as e:  # the handler thread must answer
                log.exception("request failed")
                try:
                    self._error(500, str(e), "internal_error")
                except OSError:
                    pass

        def _embeddings(self, body: dict):
            """The JAX route: a string, strings, a token array or token
            arrays; ``encoding_format`` float or base64 (little-endian
            float32)."""
            inputs = body.get("input")
            if inputs is None:
                return self._error(400, "input is required")
            if isinstance(inputs, str):
                inputs = [inputs]
            if not isinstance(inputs, list) or not inputs:
                return self._error(400, "input must be a string or list of strings")
            tok = srv.engine.tokenizer
            if all(isinstance(x, int) for x in inputs):
                prompts = [list(inputs)]  # one pre-tokenized input
            elif all(isinstance(x, str) for x in inputs):
                prompts = [tok.encode(t) for t in inputs]
            elif all(isinstance(x, list) and all(isinstance(i, int) for i in x) for x in inputs):
                prompts = [list(x) for x in inputs]  # a batch of token arrays
            else:
                return self._error(
                    400, "input must be a string, list of strings, or token array(s)")
            if any(not p for p in prompts):
                return self._error(400, "input entries must be non-empty")
            try:
                vecs = srv.engine.embed(prompts)
            except ValueError as e:
                return self._error(400, str(e))
            fmt = body.get("encoding_format", "float")
            data = []
            for i, v in enumerate(vecs):
                if fmt == "base64":
                    emb = base64.b64encode(v.astype("<f4").tobytes()).decode()
                else:
                    emb = [float(x) for x in v]
                data.append({"object": "embedding", "index": i, "embedding": emb})
            n_tokens = sum(len(p) for p in prompts)
            self._json(200, {"object": "list", "data": data, "model": srv.model_name,
                             "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens}})

        # ---- request parsing ----

        def _params(self, body: dict, chat: bool):
            """(SamplingParams, top_n, want_logprobs) or None after an error."""
            eng = srv.engine

            def num(key, default):
                v = body.get(key)
                return default if v is None else v

            stop = body.get("stop") or ()
            if isinstance(stop, str):
                stop = (stop,)
            if not all(isinstance(s, str) for s in stop):
                return self._error(400, "stop must be a string or list of strings")
            max_tokens = body.get("max_tokens", body.get("max_completion_tokens"))
            if max_tokens is None:
                max_tokens = 16 if not chat else eng.cfg.default_max_tokens
            elif not isinstance(max_tokens, int) or isinstance(max_tokens, bool) or max_tokens < 1:
                return self._error(400, "max_tokens must be a positive integer")
            # A prefill-role replica caps a stream the proxy planned to hand
            # off at the handoff budget; the capped finish becomes
            # "handoff", the proxy's cutover marker. A stream that ends
            # within the budget, and any other request, serves whole.
            handoff_cap = False
            if (srv.handoff_budget > 0 and body.get("stream")
                    and self.headers.get("X-Handoff-Planned") == "1"
                    and max_tokens > srv.handoff_budget):
                max_tokens = srv.handoff_budget
                handoff_cap = True
            bias_raw = body.get("logit_bias") or {}
            if not isinstance(bias_raw, dict):
                return self._error(400, "logit_bias must be an object")
            if len(bias_raw) > eng.cfg.max_logit_bias:
                return self._error(
                    400, f"logit_bias supports at most {eng.cfg.max_logit_bias} entries"
                )
            logit_bias = []
            for k, v in bias_raw.items():
                try:
                    tok_id, val = int(k), float(v)
                except (TypeError, ValueError):
                    return self._error(400, "logit_bias keys must be token ids, values numbers")
                if tok_id < 0 or tok_id >= eng.model_config.vocab_size or val != val \
                        or val in (float("inf"), float("-inf")):
                    return self._error(400, "logit_bias requires valid token ids and finite values")
                logit_bias.append((tok_id, max(-100.0, min(100.0, val))))
            lp_field = body.get("logprobs")
            want_logprobs = lp_field is not None and lp_field is not False
            if chat:
                top_n = body.get("top_logprobs") or 0
                if top_n and not want_logprobs:
                    return self._error(400, "logprobs must be set to true if top_logprobs is used")
            else:
                top_n = lp_field if isinstance(lp_field, int) and not isinstance(lp_field, bool) else 0
            if not isinstance(top_n, int) or isinstance(top_n, bool) or top_n < 0:
                return self._error(400, "top_logprobs must be a non-negative integer")
            if top_n > eng.cfg.top_logprobs_k:
                return self._error(
                    400, f"at most {eng.cfg.top_logprobs_k} alternative logprobs are supported"
                )
            seed = body.get("seed")
            if seed is not None and (not isinstance(seed, int) or isinstance(seed, bool)):
                return self._error(400, "seed must be an integer")
            try:
                params = SamplingParams(
                    temperature=float(num("temperature", 1.0)),
                    top_p=float(num("top_p", 1.0)),
                    top_k=int(num("top_k", 0)),
                    max_tokens=max_tokens,
                    stop=tuple(stop),
                    seed=seed,
                    logprobs=want_logprobs,
                    presence_penalty=float(num("presence_penalty", 0.0)),
                    frequency_penalty=float(num("frequency_penalty", 0.0)),
                    logit_bias=tuple(logit_bias),
                )
            except (TypeError, ValueError) as e:
                return self._error(400, f"invalid sampling parameter: {e}")
            return params, top_n, want_logprobs, handoff_cap

        def _prompt(self, body: dict, chat: bool):
            """(prompt_ids, prompt_text or None) or None after an error."""
            tok = srv.engine.tokenizer
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages or not all(
                    isinstance(m, dict) and isinstance(m.get("content"), str) for m in messages
                ):
                    return self._error(400, "messages is required")
                text = tok.apply_chat_template(messages, add_generation_prompt=True)
                return tok.encode(text), text
            prompt = body.get("prompt")
            if isinstance(prompt, list) and len(prompt) == 1 and not isinstance(prompt[0], int):
                prompt = prompt[0]
            if isinstance(prompt, str):
                return tok.encode(prompt), prompt
            if isinstance(prompt, list) and prompt and all(
                isinstance(x, int) and not isinstance(x, bool) for x in prompt
            ):
                return list(prompt), None
            return self._error(400, "prompt must be a string or a token id list")

        def _completions(self, body: dict, chat: bool, trace_ctx=None, deadline=None,
                         tenant: str = "", priority: str = DEFAULT_CLASS,
                         preemptible: bool = False, resume_tokens: int = 0):
            got = self._prompt(body, chat)
            if got is None:
                return
            prompt_ids, prompt_text = got
            got = self._params(body, chat)
            if got is None:
                return
            params, top_n, want_logprobs, handoff_cap = got
            # Preemption resumes through the stream's replay cursor: only
            # a stream may be seized.
            preemptible = preemptible and bool(body.get("stream"))
            # n > 1: one engine request per choice (the prefix cache
            # shares the prompt); a set seed gives choice i seed + i.
            n_choices = body.get("n")
            if n_choices is None:
                n_choices = 1
            if (not isinstance(n_choices, int) or isinstance(n_choices, bool)
                    or not 1 <= n_choices <= 16):
                return self._error(400, "n must be an integer between 1 and 16")
            # echo and stream_options are checked before any submit: a 400
            # after one would leave generations with no consumer.
            echo = body.get("echo")
            if echo is not None and not isinstance(echo, bool):
                return self._error(400, "echo must be a boolean")
            so = body.get("stream_options")
            if so is not None and (not isinstance(so, dict) or not body.get("stream")):
                return self._error(400, "stream_options must be an object and requires stream: true")
            if deadline is not None and time.monotonic() >= deadline:
                # The budget was spent before admission.
                return self._error(504, "deadline exceeded", "timeout_error")
            # A model field that names a loaded adapter runs with it.
            requested = str(body.get("model", ""))
            adapter = requested if requested in srv.adapters else None
            # A single-choice stream the proxy may preempt or hand off
            # parks its KV at the cut; a resume carrying the X-KV-* offer
            # imports it. Both are best-effort: any failure replays.
            park_kv, restore, restore_key = "", None, ""
            if body.get("stream") and n_choices == 1:
                park_kv = "handoff" if handoff_cap else "preempt" if preemptible else ""
                restore, restore_key = self._acquire_restore(prompt_ids, params, adapter)
            reqs = []
            try:
                for i in range(n_choices):
                    p_i = params
                    if i and params.seed is not None:
                        p_i = dataclasses.replace(params, seed=params.seed + i)
                    r = srv.engine.submit(prompt_ids, p_i, adapter=adapter, trace_ctx=trace_ctx,
                                          deadline=deadline, tenant=tenant, priority=priority,
                                          preemptible=preemptible, park_kv=park_kv,
                                          restore=restore, restore_key=restore_key)
                    r.trace.model = srv.model_name
                    if n_choices > 1:
                        r.trace.attrs["choice"] = i
                    if resume_tokens:
                        r.trace.attrs["resume_tokens"] = resume_tokens
                    reqs.append(r)
            except ValueError as e:
                _cancel_all(reqs)
                return self._error(400, str(e))
            except queue.Full:
                # Shed mid-loop (n > 1): the choices already submitted are
                # cancelled, or they would decode for nobody. Retry-After
                # scales with the backlog at or above the class.
                _cancel_all(reqs)
                return self._saturated("engine saturated",
                                       retry_after=srv.engine.qos_retry_after(priority))
            except FaultError:
                _cancel_all(reqs)
                raise
            except RuntimeError as e:
                _cancel_all(reqs)
                return self._error(503, str(e), "service_unavailable")
            except BaseException:
                _cancel_all(reqs)
                raise
            rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            echo_text = ""
            if not chat and echo:
                echo_text = prompt_text if prompt_text is not None else srv.engine.tokenizer.decode(prompt_ids)
            ctx = dict(rid=rid, created=int(time.time()), chat=chat,
                       want_logprobs=want_logprobs, top_n=top_n, echo_text=echo_text)
            try:
                if body.get("stream"):
                    self._stream(reqs, include_usage=bool((so or {}).get("include_usage")),
                                 prompt_tokens=len(prompt_ids), handoff_cap=handoff_cap, **ctx)
                else:
                    self._full(reqs, deadline=deadline, **ctx)
            finally:
                _cancel_all(reqs)  # a no-op for requests that finished

        def _acquire_restore(self, prompt_ids, params, adapter):
            """The proxy's X-KV-* offer as a decoded RestoreState and its
            park key, or (None, "") to replay. Every failure is soft."""
            eng = srv.engine
            key = self.headers.get(kvstate.KV_KEY_HEADER, "")
            if not key or not eng._kv_enabled():
                return None, ""
            source = self.headers.get(kvstate.KV_SOURCE_HEADER, "")
            try:
                tokens = int(self.headers.get(kvstate.KV_TOKENS_HEADER, "") or 0)
            except ValueError:
                tokens = 0
            t0 = time.monotonic()
            entry = eng.kv_park.get(key)
            blob = entry.blob if entry is not None else None
            if blob is None:
                if not source or source == eng.kv_advertise:
                    # A same-replica resume whose park expired or was evicted.
                    kvstate.M_KV_IMPORT.inc(labels={"outcome": "miss"})
                    return None, ""
                if tokens < kvstate.breakeven_tokens():
                    # Below break-even a replay costs less than the fetch and
                    # upload: a decision, not a miss.
                    return None, ""
                blob = kvstate.fetch_blob(source, key)
                if blob is None:
                    kvstate.M_KV_IMPORT.inc(labels={"outcome": "miss"})
                    return None, ""
            try:
                # The serving thread's leg of the import failpoint: corrupt
                # mangles the blob (the checksums must catch it), error
                # aborts the acquire.
                blob = fault("engine.kv_import", payload=blob)
                state = kvstate.decode_state(
                    blob, expect_model_fp=eng._kv_fp,
                    expect_request_fp=kvstate.request_fingerprint(prompt_ids, params, adapter))
            except FaultError:
                kvstate.M_KV_IMPORT.inc(labels={"outcome": "error"})
                return None, ""
            except kvstate.KVFormatError as e:
                kvstate.M_KV_IMPORT.inc(labels={"outcome": "corrupt"})
                log.warning("parked KV %s rejected (%s); resuming by replay", key, e)
                return None, ""
            dur = time.monotonic() - t0
            kvstate.M_KV_RESTORE_SECONDS.observe(dur, labels={"phase": "acquire"})
            eng.kv_log.append({"event": "acquire", "ms": dur * 1e3, "bytes": len(blob),
                               "fetched": entry is None})
            return state, key

        # ---- responses ----

        def _token_text(self, token_id: int) -> str:
            return srv.engine.tokenizer.decode([token_id])

        def _top_entries(self, top, top_n, chat):
            if not top_n or not top:
                return None
            pairs = top[:top_n]
            if chat:
                return [{"token": self._token_text(t), "logprob": lp} for t, lp in pairs]
            out = {}
            for t, lp in pairs:
                out.setdefault(self._token_text(t), lp)
            return out

        def _lp_completion(self, pieces, top_n):
            return {
                "tokens": [self._token_text(t) for t, _, _ in pieces],
                "token_logprobs": [lp for _, lp, _ in pieces],
                "top_logprobs": (
                    [self._top_entries(top, top_n, False) or {} for _, _, top in pieces]
                    if top_n else None
                ),
            }

        def _lp_chat(self, pieces, top_n):
            content = []
            for t, lp, top in pieces:
                entry = {"token": self._token_text(t), "logprob": lp}
                if top_n:
                    entry["top_logprobs"] = self._top_entries(top, top_n, True) or []
                content.append(entry)
            return {"content": content}

        def _full(self, reqs, rid, created, chat, want_logprobs, top_n, echo_text,
                  deadline=None):
            choices = []
            prompt_tokens = completion_tokens = 0
            for idx, req in enumerate(reqs):
                chunks, pieces = [], []
                while True:
                    wait = STREAM_WAIT_S
                    if deadline is not None:
                        # Wait no longer than the budget: the scheduler's
                        # sweep frees the slot, the answer must not outwait it.
                        wait = min(wait, max(deadline - time.monotonic(), 0.0) + 1.0)
                    try:
                        ev = req.out.get(timeout=wait)
                    except queue.Empty:
                        return self._error(504, "generation timed out", "timeout_error")
                    if ev[0] == "token":
                        chunks.append(ev[2])
                        if ev[1] >= 0 and ev[3] is not None:
                            pieces.append((ev[1], ev[3], ev[4]))
                    elif ev[0] == "done":
                        fin = ev[1]
                        break
                    elif ev[1] == Engine.DEADLINE_MSG:
                        return self._error(504, ev[1], "timeout_error")
                    else:
                        return self._error(500, ev[1], "internal_error")
                text = "".join(chunks)
                prompt_tokens = fin.prompt_tokens  # one prompt for every choice
                completion_tokens += fin.completion_tokens
                if chat:
                    choice = {"index": idx, "message": {"role": "assistant", "content": text},
                              "finish_reason": fin.reason}
                    if want_logprobs:
                        choice["logprobs"] = self._lp_chat(pieces, top_n)
                else:
                    choice = {"index": idx, "text": echo_text + text,
                              "finish_reason": fin.reason}
                    if want_logprobs:
                        choice["logprobs"] = self._lp_completion(pieces, top_n)
                choices.append(choice)
            self._json(200, {
                "id": rid, "object": "chat.completion" if chat else "text_completion",
                "created": created, "model": srv.model_name, "choices": choices,
                "usage": {
                    "prompt_tokens": prompt_tokens,
                    "completion_tokens": completion_tokens,
                    "total_tokens": prompt_tokens + completion_tokens,
                },
            })

        def _stream(self, reqs, rid, created, chat, want_logprobs, top_n, echo_text,
                    include_usage, prompt_tokens, handoff_cap=False):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            obj = "chat.completion.chunk" if chat else "text_completion"

            def send(payload: str):
                # Failpoint: error:1:skip=N severs the stream after N
                # events, as a replica dying mid-stream would.
                fault("engine.stream")
                data = f"data: {payload}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def chunk(choice, **extra):
                send(json.dumps({"id": rid, "object": obj, "created": created,
                                 "model": srv.model_name, "choices": [choice], **extra}))

            def close():
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            # n > 1 choices decode together; one pump per choice feeds a
            # merge queue, and each event goes out tagged with its index.
            merged: "queue.Queue[tuple[int, tuple]]" = queue.Queue()

            def pump(idx, r):
                # Short polls: a cancelled request frees its slot with no
                # terminal event, which a long get would wait out.
                waited = 0.0
                while True:
                    try:
                        ev = r.out.get(timeout=1.0)
                    except queue.Empty:
                        if r.cancelled.is_set():
                            return
                        waited += 1.0
                        if waited >= STREAM_WAIT_S:
                            merged.put((idx, ("error", "generation timed out")))
                            return
                        continue
                    waited = 0.0
                    merged.put((idx, ev))
                    if ev[0] in ("done", "error"):
                        return

            if len(reqs) > 1:
                for i, r in enumerate(reqs):
                    threading.Thread(target=pump, args=(i, r), daemon=True).start()
            remaining = len(reqs)
            done_prompt = completion = 0
            # Tokens so far of each choice still running: the usage an
            # error path reports.
            live: dict[int, int] = {}
            # A capped stream holds its text-only tail flush until the
            # finish: at a handoff the decode replica delivers those bytes
            # inside its own chunks, so flushing here would duplicate them.
            held: dict[int, str] = {}

            def usage_chunk():
                pt = done_prompt or prompt_tokens
                ct = completion + sum(live.values())
                send(json.dumps({"id": rid, "object": obj, "created": created,
                                 "model": srv.model_name, "choices": [],
                                 "usage": {"prompt_tokens": pt, "completion_tokens": ct,
                                           "total_tokens": pt + ct}}))

            try:
                for idx in range(len(reqs)):
                    if chat:
                        chunk({"index": idx, "delta": {"role": "assistant"},
                               "finish_reason": None})
                    elif echo_text:
                        chunk({"index": idx, "text": echo_text, "finish_reason": None})
                while remaining:
                    if len(reqs) == 1:
                        try:
                            idx, ev = 0, reqs[0].out.get(timeout=STREAM_WAIT_S)
                        except queue.Empty:
                            idx, ev = 0, ("error", "generation timed out")
                    else:
                        idx, ev = merged.get()
                    if ev[0] == "token":
                        if ev[1] >= 0:
                            live[idx] = live.get(idx, 0) + 1
                        has_lp = want_logprobs and ev[1] >= 0 and ev[3] is not None
                        if not ev[2] and not has_lp:
                            continue
                        if handoff_cap and ev[1] < 0:
                            held[idx] = held.get(idx, "") + ev[2]
                            continue
                        pieces = [(ev[1], ev[3], ev[4])] if has_lp else []
                        if chat:
                            choice = {"index": idx, "delta": {"content": ev[2]},
                                      "finish_reason": None}
                            if has_lp:
                                choice["logprobs"] = self._lp_chat(pieces, top_n)
                        else:
                            choice = {"index": idx, "text": ev[2], "finish_reason": None}
                            if has_lp:
                                choice["logprobs"] = self._lp_completion(pieces, top_n)
                        chunk(choice)
                    elif ev[0] == "done":
                        fin = ev[1]
                        remaining -= 1
                        done_prompt = fin.prompt_tokens
                        completion += fin.completion_tokens
                        live.pop(idx, None)  # the exact count landed
                        reason = fin.reason
                        if handoff_cap and reason == "length":
                            # The handoff budget ran out, not the client's.
                            reason = "handoff"
                            M_HANDOFF_CAPPED.inc()
                        tail = held.pop(idx, "")
                        if tail and reason != "handoff":
                            chunk({"index": idx, "delta": {"content": tail},
                                   "finish_reason": None}
                                  if chat else {"index": idx, "text": tail, "finish_reason": None})
                        # A parked-KV offer rides the marker chunk: the proxy
                        # stamps it on the resume; clients ignore the field.
                        chunk({"index": idx, "delta": {}, "finish_reason": reason} if chat
                              else {"index": idx, "text": "", "finish_reason": reason},
                              **({"kubeai_kv": fin.kv} if fin.kv else {}))
                        if remaining == 0:
                            if include_usage:
                                usage_chunk()
                            send("[DONE]")
                            return close()
                    else:
                        _cancel_all(reqs)
                        if include_usage:
                            # Every terminal path reports usage, partial here.
                            usage_chunk()
                        send(json.dumps({"error": {"message": ev[1]}}))
                        return close()
            except FaultError:
                # An injected death: sever the socket with the chunked
                # stream unterminated, as a crashed replica would.
                _cancel_all(reqs)
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.close_connection = True
            except (BrokenPipeError, ConnectionResetError):
                _cancel_all(reqs)

    return Handler


# ---------------------------------------------------------------------------
# CLI


def make_arg_parser(require_model: bool = True) -> argparse.ArgumentParser:
    """The engine's command line. Also parses a parked replica's attach
    args and the park config's (coldstart.start_spec), with
    *require_model* False for the latter: one parser, so a warm can never
    drift from the start it prepares."""
    p = argparse.ArgumentParser("kubeai-tpu-torch-engine")
    p.add_argument("--model", required=require_model, default=None,
                   help="an HF checkpoint dir, test:tiny, or preset:NAME (random weights; NAME "
                        "llama-3.1-8b, qwen2.5-7b, gemma-2b, gemma2-2b or mixtral-8x7b)")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="ranks the model is split over (one process each; see the module doc)")
    p.add_argument("--gang-local-rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--quantization", default="", choices=["", "int8"],
                   help="int8: weight-only int8 (W8A16 kernel on CUDA)")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=64, help="KV pool tokens per page")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="total KV pool pages (0 = auto: max_slots * max_seq_len/page_size + 1)")
    p.add_argument("--speculate-tokens", type=int, default=0,
                   help="draft tokens verified per decode step via n-gram prompt "
                        "lookup (greedy-exact; 0 disables)")
    p.add_argument("--decode-kernel", default="ragged", choices=["ragged", "dedicated", "auto"])
    p.add_argument("--kv-cache-dtype", default="", choices=["", "fp8", "int8"],
                   help="store the paged KV pool in fp8 (e4m3) or int8 (static scales, "
                        "kv_scale_k/v of the model config: 1.0 unless set there); "
                        "halves the pool's bytes")
    p.add_argument("--prefix-cache-min", type=int, default=16,
                   help="min shared-prefix tokens reused across slots (0 disables)")
    p.add_argument("--role", default="", choices=["", "prefill", "decode"],
                   help="disaggregated role: prefill replicas cap planned handoff streams at "
                        "the handoff budget and finish them 'handoff'; decode replicas serve "
                        "the resumes; empty = unified serving")
    p.add_argument("--handoff-budget", type=int,
                   default=int(os.environ.get("KUBEAI_HANDOFF_BUDGET", "8")),
                   help="max tokens a prefill-role replica streams before the 'handoff' "
                        "finish (ignored unless --role prefill)")
    p.add_argument("--drain-grace", type=float,
                   default=float(os.environ.get("KUBEAI_DRAIN_GRACE", "30")),
                   help="seconds SIGTERM lets in-flight generations finish before the hard "
                        "stop (keep below terminationGracePeriodSeconds)")
    p.add_argument("--warmup", action="store_true",
                   default=os.environ.get("KUBEAI_ENGINE_WARMUP", "0") == "1",
                   help="run every step shape (on CUDA: capture the decode chunk's graph) "
                        "before serving, so the first request pays for none")
    p.add_argument("--parked", action="store_true",
                   help="start with no model and wait for a POST /v1/attach (scale-from-zero "
                        "attaches to a parked pod instead of spawning a process)")
    p.add_argument("--park-config", default=os.environ.get("KUBEAI_PARK_CONFIG", ""),
                   help="the model (as --model takes it) a parked replica warms for at park "
                        "time: its kernel libraries, and an engine over zero weights whose "
                        "decode graph is captured; an attach with the same configuration "
                        "adopts that engine")
    return p


def engine_config_from_args(args) -> EngineConfig:
    """The EngineConfig of a parsed command line (test: models take the
    test buckets). Shared with the warm (coldstart.start_spec), so warmed
    shapes never drift from what a pod started with the same args runs."""
    ec = EngineConfig(
        max_slots=args.max_slots, max_seq_len=args.max_seq_len, page_size=args.page_size,
        num_pages=args.kv_pages, decode_kernel=args.decode_kernel,
        speculate_tokens=args.speculate_tokens, prefix_cache_min=args.prefix_cache_min,
        kv_cache_dtype=args.kv_cache_dtype,
    )
    if (args.model or "").startswith("test:"):
        ec.prefill_buckets = TEST_PREFILL_BUCKETS
    return ec


def build_engine_from_args(args, warmup: bool | None = None,
                           park_engine: Engine | None = None, tp_group=None,
                           publisher=None) -> tuple[Engine, str]:
    """The engine and served name of a command line. With *warmup* (None:
    ``--warmup``) the engine has run Engine.warmup (its result in
    ``engine.warmup_result``). A checkpoint or preset start stamps its
    phases on a ColdStartTimeline (``engine.cold_start_timeline``, at
    /debug/engine); a test: engine has none, as in the JAX server. A
    *park_engine* of the same configuration is adopted. A gang rank
    passes its *tp_group* (and rank 0 the gang's *publisher*)."""
    if warmup is None:
        warmup = getattr(args, "warmup", False)
    ec = engine_config_from_args(args)
    name = args.served_model_name or args.model
    if args.model.startswith("test:"):
        eng = build_test_engine(ec, seed=args.seed, device=args.device,
                                quantization=args.quantization)
        if warmup:
            eng.warmup()
        return eng, name
    timeline = ColdStartTimeline().install()
    if args.model.startswith("preset:"):
        mc = preset_config(args.model[len("preset:"):])
        dev = resolve_device(args.device)
        spec = StartSpec(mc, ec, args.quantization, ByteTokenizer(), dev)
        # A preset's load is its seeded init (a gang rank keeps its shard).
        return start_engine(spec, lambda: (preset_params(mc, dev, args.seed, args.quantization,
                                                         tp_group=tp_group), mc),
                            timeline, warmup=warmup, park_engine=park_engine,
                            tp_group=tp_group, publisher=publisher), name
    with timeline.phase("stage"):
        path = stage_remote(args.model)
    return load_engine_from_path(path, ec, tp=args.tensor_parallel_size,
                                 quantization=args.quantization, device=args.device,
                                 timeline=timeline, warmup=warmup,
                                 park_engine=park_engine, tp_group=tp_group,
                                 publisher=publisher), name


# ---------------------------------------------------------------------------
# The gang


def maybe_init_distributed() -> tuple[list[str], int] | None:
    """(gang hosts, this host's index) from the controller's stamps
    ``TPU_WORKER_HOSTNAMES`` and ``TPU_WORKER_ID``, or None for a
    single-host pod (fewer than two hosts)."""
    hosts = [h.strip() for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",")
             if h.strip()]
    if len(hosts) < 2:
        return None
    host_id = int(os.environ.get("TPU_WORKER_ID", "0"))
    log.info("joining slice: coordinator=%s:%s host %d/%d", hosts[0],
             os.environ.get("TPU_COORDINATOR_PORT", str(DEFAULT_COORDINATOR_PORT)), host_id,
             len(hosts))
    return hosts, host_id


def _gang_port() -> int:
    return int(os.environ.get("KUBEAI_GANG_PORT", str(DEFAULT_GANG_PORT)))


def _gang_secret() -> str:
    """The shared secret gang members authenticate with (stamped per
    gang by the controller). Required: the dispatch stream carries
    prompt tokens and adapter paths."""
    secret = os.environ.get("KUBEAI_GANG_SECRET", "")
    if not secret:
        raise SystemExit("KUBEAI_GANG_SECRET is required for multi-host gangs "
                         "(the controller stamps it on slice pods)")
    return secret


def _coordinator_port() -> int:
    return int(os.environ.get("TPU_COORDINATOR_PORT", str(DEFAULT_COORDINATOR_PORT)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(args, local: int, per_host: int) -> tuple[torch.device, str]:
    """(device, backend) of local rank *local* of *per_host*: card
    local % cards when --device names no index, nccl when the host's
    ranks each have a card, else gloo (ranks sharing a card, the CPU)."""
    base = resolve_device(args.device)
    if base.type != "cuda":
        return base, "gloo"
    if base.index is not None:
        return base, choose_backend(base, per_host, 1)
    cards = torch.cuda.device_count()
    return torch.device("cuda", local % cards), choose_backend(base, per_host, cards)


def _spawn_local_ranks(argv: list[str], per_host: int, port: int) -> list:
    """This host's local ranks 1 .. per_host-1 as child processes with the
    same arguments (they read the gang's ports and secret from the
    environment this process set) and ``--port`` port + local rank.
    Each dies with this process (PR_SET_PDEATHSIG)."""
    import subprocess

    def die_with_parent():
        try:
            import ctypes

            ctypes.CDLL("libc.so.6").prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
        except OSError:
            pass

    procs = []
    for local in range(1, per_host):
        cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server", *argv,
               "--gang-local-rank", str(local), "--port", str(port + local if port else 0)]
        procs.append(subprocess.Popen(cmd, env=dict(os.environ), preexec_fn=die_with_parent))
    log.info("started %d local gang rank(s)", len(procs))
    return procs


def _follower_http(host: str, port: int, name: str, engine: Engine) -> ThreadingHTTPServer:
    """A follower's HTTP surface: health, readiness, metrics and
    /debug/gang; every other path answers 404 (the balancer routes
    inference to rank 0 only)."""

    class FollowerHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            log.debug("%s " + fmt, self.address_string(), *a)

        def do_GET(self):
            path = self.path.split("?")[0]
            status, ctype = 200, "application/json"
            if path in ("/health", "/healthz", "/readyz"):
                body = json.dumps({"status": "ok", "model": name, "role": "follower"}).encode()
            elif path == "/metrics":
                body, ctype = default_registry.render().encode(), "text/plain; version=0.0.4"
            elif path == "/debug/gang":
                body = json.dumps(engine.gang_report()).encode()
            else:
                status = 404
                body = json.dumps(
                    {"error": {"message": "follower rank serves no inference"}}).encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer((host, port), FollowerHandler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, name="follower-http", daemon=True).start()
    return httpd


def serve_gang(args, argv: list[str], gang_hosts) -> None:
    """Serve as one rank of a tp gang (see the module doc): start this
    host's other local ranks (local rank 0 only), meet the others at the
    coordinator, build this rank's engine over its shard, then on rank 0
    publish and serve, elsewhere replay until rank 0 stops."""
    from kubeai_tpu_torch.engine.gang import GangFollower, GangPublisher

    hosts, host_id = gang_hosts or (["127.0.0.1"], 0)
    tp = args.tensor_parallel_size
    if tp <= 1:
        # Bare gang pods: span every card of the slice.
        tp = len(hosts) * max(1, torch.cuda.device_count())
        args.tensor_parallel_size = tp
    if tp % len(hosts):
        raise SystemExit(f"--tensor-parallel-size must be a multiple of the gang size "
                         f"(tp={tp}, processes={len(hosts)})")
    per_host = tp // len(hosts)
    local = args.gang_local_rank
    rank = host_id * per_host + local
    if gang_hosts is None and local == 0:
        # A one-host gang over loopback: its ports and a secret of its own,
        # handed to the local ranks through their environment.
        os.environ.setdefault("KUBEAI_GANG_SECRET", secrets.token_hex(16))
        os.environ.setdefault("KUBEAI_GANG_PORT", str(_free_port()))
        os.environ.setdefault("TPU_COORDINATOR_PORT", str(_free_port()))
    secret, gang_port = _gang_secret(), _gang_port()
    dev, backend = _rank_device(args, local, per_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    args.device = str(dev)
    children = _spawn_local_ranks(argv, per_host, args.port) if local == 0 else []
    publisher = None
    try:
        if rank == 0:
            # Handshakes run in the background from here on.
            publisher = GangPublisher(tp - 1, port=gang_port, secret=secret)
        group = init_tp_group(rank, tp, dev, backend, host=hosts[0], port=_coordinator_port())
        engine, name = build_engine_from_args(args, tp_group=group, publisher=publisher)
        if rank == 0:
            publisher.accept_all()  # a dispatch before the gang is whole strands it
            srv = EngineServer(engine, name, host=args.host, port=args.port, role=args.role,
                               handoff_budget=args.handoff_budget,
                               drain_grace=args.drain_grace)
            srv.install_signal_handlers()
            srv.start()
            log.info("serving %s as rank 0 of a tp=%d gang (%s)", name, tp, backend)
            try:
                while not srv.stopped_event.wait(3600):
                    pass
            except KeyboardInterrupt:
                srv.stop()
            return
        httpd = _follower_http(args.host, args.port, name, engine)
        # Connect once the engine is built: the first recv follows the
        # proof at once, so rank 0 never publishes to a rank still loading.
        follower = GangFollower(hosts[0], gang_port, secret=secret, rank=rank)
        log.info("rank %d of a tp=%d gang (%s) replaying rank 0's dispatches", rank, tp,
                 backend)
        try:
            engine.run_follower(follower)
        finally:
            follower.close()
            httpd.shutdown()
    finally:
        for p in children:
            try:
                p.wait(timeout=30)
            except Exception:
                p.kill()
                p.wait()


def main(argv=None) -> None:
    # The kernel-library cache (KUBEAI_COMPILE_CACHE): replicas that share
    # its mount read each other's builds.
    setup_compile_cache()
    gang_hosts = maybe_init_distributed()
    parser = make_arg_parser(require_model=False)
    raw = list(argv if argv is not None else sys.argv[1:])
    args = parser.parse_args(raw)
    if not args.parked and not args.model:
        parser.error("--model is required (unless --parked)")
    if args.tensor_parallel_size < 1:
        parser.error("--tensor-parallel-size must be >= 1")
    gang = gang_hosts is not None or args.tensor_parallel_size > 1
    if gang and args.parked:
        parser.error("--parked is not supported on multi-host gangs")
    if gang and args.model.startswith("test:"):
        # build_test_engine has no tp plumbing: rank 0 would serve
        # unsharded and never publish, stranding the others.
        parser.error("test: models cannot serve on a multi-host gang")
    setup_logging("engine")
    if gang:
        serve_gang(args, raw, gang_hosts)
        return
    if args.parked:
        srv = EngineServer(None, "(parked)", host=args.host, port=args.port,
                           drain_grace=args.drain_grace, device=args.device)
        if args.park_config:
            raw = argv if argv is not None else sys.argv[1:]
            srv.start_park_warm(args.park_config, [a for a in raw if a != "--parked"])
        srv.install_signal_handlers()
        srv.start()
        log.info("parked replica on :%d (awaiting /v1/attach)", srv.port)
    else:
        engine, name = build_engine_from_args(args)
        srv = EngineServer(engine, name, host=args.host, port=args.port, role=args.role,
                           handoff_budget=args.handoff_budget, drain_grace=args.drain_grace)
        srv.install_signal_handlers()
        srv.start()
    try:
        # A SIGTERM drain ends in stop(), which sets the event.
        while not srv.stopped_event.wait(3600):
            pass
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
