"""Retrying reverse proxy with request-triggered scale-from-zero.

Port of kubeai_tpu/proxy/handler.py: the JAX package's code,
its imports in this package.

Parity: internal/modelproxy/handler.go:36-172 — parse once, bump the
active-requests gauge (THE autoscaling signal), 0->1 scale, await an
endpoint, proxy with body replay and retries on {500,502,503,504} or
connection errors, re-entering endpoint selection each attempt.

Tracing: every request carries an id — inbound X-Request-ID if the
client sent one, else generated — that is logged in span-shaped lines
here, forwarded to the engine (which logs it too), and echoed in the
response headers, so one id greps across the whole path (the minimum
the reference gets from its otelhttp wiring,
ref: internal/manager/otel.go:16-80).
"""

from __future__ import annotations

import http.client
import threading
import time

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.disagg.handoff import is_handoff_event as _is_handoff_event
from kubeai_tpu_torch.engine.kvstate import (
    KV_KEY_HEADER,
    KV_SOURCE_HEADER,
    KV_TOKENS_HEADER,
    extract_kv_offer as _extract_kv_offer,
)
from kubeai_tpu_torch.faults import fault
from kubeai_tpu_torch.metrics import ACTIVE_REQUESTS, default_registry
from kubeai_tpu_torch.obs.trace import SpanBuilder, extract_context
from kubeai_tpu_torch.obs.logs import bind_log_context, get_logger, set_log_context
from kubeai_tpu_torch.obs.tenants import (
    CANARY_HEADER,
    TENANT_HEADER,
    RequestMeter,
    extract_tenant,
)
from kubeai_tpu_torch.proxy.apiutils import APIError, Request, parse_request
from kubeai_tpu_torch.qos import (
    DEFAULT_CLASS,
    PREEMPTIBLE_HEADER,
    PRIORITY_HEADER,
    acquire_resume_upstream,
    record_resolved,
    record_resume,
    resolve_priority,
)
from kubeai_tpu_torch.qos import is_preempt_event as _is_preempt_event
from kubeai_tpu_torch.proxy.recovery import (
    M_BUDGET_REMAINING,
    HedgeTracker,
    RetryBudget,
    hedging_enabled,
    is_token_event,
    replay_enabled,
    request_replayable,
    sse_events,
)

log = get_logger("kubeai_tpu_torch.proxy")

RETRYABLE_CODES = {500, 502, 503, 504}
# Retry-After hint (seconds) on backpressure responses: long enough to
# de-synchronize client retries, short enough that scale-up capacity
# gets traffic promptly.
RETRY_AFTER_HINT = "1"


class ProxyResult:
    def __init__(self, status: int, headers: list[tuple[str, str]], body_iter):
        self.status = status
        self.headers = headers
        self.body_iter = body_iter


def _chunk_reader(resp):
    """One-chunk-at-a-time reader for SSE re-framing. read1 (at most one
    chunk per call) over read: a bulk read(N) on a chunked response
    that died mid-stream raises IncompleteRead WITHOUT surfacing the
    chunks it already buffered — events the client could have had would
    vanish and the resume cursor would undercount."""
    read1 = getattr(resp, "read1", None)
    if read1 is not None:
        return lambda: read1(65536)
    return lambda: resp.read(65536)


class _HedgeFailed(Exception):
    """Every hedged connect attempt failed; cleanup (done callbacks,
    breaker feedback, failed-address bookkeeping) already happened
    inside the hedge — the retry loop must NOT repeat it."""

    def __init__(self, err: Exception):
        super().__init__(str(err))
        self.err = err


class ModelProxy:
    def __init__(
        self,
        model_client,
        load_balancer,
        max_retries: int = 3,
        await_timeout: float = 600.0,
        connect_timeout: float = 600.0,
        retry_budget: RetryBudget | None = None,
        hedge_tracker: HedgeTracker | None = None,
    ):
        self.model_client = model_client
        self.lb = load_balancer
        self.max_retries = max_retries
        self.await_timeout = await_timeout
        # Per-connection socket timeout (was hard-coded 600 s); a client
        # deadline tightens it further per attempt.
        self.connect_timeout = connect_timeout
        # Process-wide retry budget gating ALL extra attempts (failover
        # retries, mid-stream replays, latency hedges): under fleet-wide
        # failure the proxy degrades to fail-fast instead of multiplying
        # offered load by max_retries+1.
        self.budget = retry_budget or RetryBudget()
        M_BUDGET_REMAINING.set_callback(self.budget.remaining)
        # Latency hedging (opt-in, non-streaming only): second attempt
        # after a p95-based delay; first response wins.
        self.hedge = hedge_tracker or HedgeTracker()
        self.hedge_enabled: bool | None = None  # None = read env per request
        self.active = default_registry.gauge(
            ACTIVE_REQUESTS, "requests currently being served per model"
        )

    def handle(self, raw_body: bytes, path: str, headers: dict[str, str], cancelled: threading.Event | None = None):
        """Returns a ProxyResult; raises APIError for client errors."""
        # Trace context first (inbound traceparent, else derived from
        # X-Request-ID, else generated): even parse failures get a
        # recorded timeline.
        tb = SpanBuilder(extract_context(headers), component="proxy")
        # Log-context binding: this handler thread serves exactly one
        # request, so every record emitted below carries the ids
        # automatically. set (not bind) REPLACES any stale context left
        # by the thread's previous request.
        set_log_context(
            trace_id=tb.ctx.trace_id,
            span_id=tb.ctx.span_id,
            request_id=tb.ctx.request_id,
        )
        # Tenant attribution (obs/tenants.py): derived from credentials
        # BEFORE parsing so even a 400 is attributed; only the hash of
        # the credential survives this point. Canary probes carry the
        # trusted exclusion marker and are metered by the accountant as
        # excluded, never as traffic.
        tenant = extract_tenant(headers)
        bind_log_context(tenant=tenant)
        is_canary = any(k.lower() == CANARY_HEADER.lower() for k in headers)
        meter = RequestMeter(tenant, canary=is_canary)
        tb.attrs["tenant"] = tenant
        try:
            with tb.span("parse"):
                req = parse_request(self.model_client, raw_body, path, headers)
            req.tenant = tenant
            req.canary = is_canary
            req.meter = meter
            # QoS class (docs/qos.md): validated header > body field >
            # per-tenant default. Resolved ONCE here; an invalid
            # explicit value is a client error, and the inbound header
            # is stripped + restamped downstream exactly like the
            # tenant header so lanes can't be forged past the proxy.
            hdr_priority = next(
                (v for k, v in headers.items() if k.lower() == PRIORITY_HEADER.lower()),
                "",
            )
            try:
                req.priority = resolve_priority(hdr_priority, req.priority_hint, tenant)
            except ValueError as e:
                raise APIError(400, str(e))
            record_resolved(req.priority)
            tb.attrs["priority"] = req.priority
            # Honor an inbound correlation id; otherwise use the parsed id.
            from kubeai_tpu_torch.proxy.apiutils import sanitize_request_id

            inbound = sanitize_request_id(
                next((v for k, v in headers.items() if k.lower() == "x-request-id"), "")
            )
            if inbound:
                req.id = inbound
            # The timeline must be findable by the SAME id the response
            # echoes (req.id) — with no inbound X-Request-ID,
            # extract_context had only a placeholder.
            tb.ctx.request_id = req.id
            tb.model = req.model_name
            req.trace = tb
            bind_log_context(
                request_id=req.id, model=req.model_name, qos_class=req.priority
            )
            log.info("request accepted path=%s", path)

            labels = {"request_model": req.model_name, "request_type": "http"}
            self.active.add(1, labels=labels)
            release = lambda: self.active.add(-1, labels=labels)
        except APIError as e:
            meter.finish("error")
            tb.finish("error", status=e.code, error=e.message)
            raise

        try:
            with tb.span("scale_from_zero"):
                self.model_client.scale_at_least_one_replica(req.model_obj)
            return self._proxy_with_retries(req, path, headers, release, cancelled)
        except BaseException as e:
            release()
            meter.finish(
                "cancelled" if cancelled is not None and cancelled.is_set() else "error"
            )
            tb.finish(
                "error",
                status=getattr(e, "code", 0) or 500,
                error=str(e)[:200],
            )
            raise

    def _proxy_with_retries(self, req: Request, path: str, headers: dict[str, str], release, cancelled):
        # Token metering for streams: the usage block is the only exact
        # source of prompt/completion counts, but OpenAI only sends it
        # when the client asked (stream_options.include_usage). For our
        # own engine the proxy INJECTS the flag engine-ward and strips
        # the resulting usage chunk from the client stream unless the
        # client requested it — every streamed request gets exact
        # per-tenant token accounting with zero client-visible change.
        # Gated to TPUEngine models: a third-party engine image may
        # reject an option its build predates.
        meter: RequestMeter | None = req.meter
        if (
            meter is not None
            and req.body is not None
            and req.body.stream
            and req.raw_body is None
            and isinstance(req.body.data, dict)
            and req.model_obj is not None
            and getattr(req.model_obj.spec, "engine", "") == mt.ENGINE_TPU
        ):
            so = req.body.data.get("stream_options")
            # parse_request already 400'd non-dict stream_options; the
            # isinstance guard keeps direct callers safe too.
            if not (isinstance(so, dict) and so.get("include_usage")):
                req.body.data["stream_options"] = dict(
                    so if isinstance(so, dict) else {}, include_usage=True
                )
                meter.strip_usage = True
        body = req.body_bytes()
        t0 = time.monotonic()
        # Every handled request feeds the retry budget (the deposit side
        # of the ~10%-of-request-rate token bucket).
        self.budget.deposit()
        # End-to-end deadline: one budget spanning endpoint await, every
        # connect attempt, and the stream. None = no client deadline.
        deadline = None if req.timeout is None else t0 + req.timeout

        def remaining() -> float | None:
            return None if deadline is None else deadline - time.monotonic()

        # Mid-stream replay eligibility: a deterministic single-choice
        # streaming request can be seamlessly resumed on another
        # endpoint if its replica dies mid-stream.
        replayable = replay_enabled() and request_replayable(req.body)
        # Disaggregated routing: handoff-eligible requests (mirror of
        # replay eligibility — the handoff IS a planned replay) start on
        # the prefill pool and cut over at the engine's handoff marker;
        # everything else serves unified on the decode pool, whose
        # replicas are uncapped.
        handoff_planned = False
        dspec = (
            req.model_obj.spec.disaggregation
            if req.model_obj is not None
            and getattr(req.model_obj.spec, "disaggregation", None) is not None
            and req.model_obj.spec.disaggregation.enabled
            else None
        )
        if dspec is not None and not self._has_role_endpoints(req.model_name):
            # The spec ASKS for disaggregation but the deployment is
            # unified right now — multi-host gangs (controller ignores
            # the mode), a mode flip not yet rolled, or cold start with
            # no endpoints. Serve unified: planning a handoff no engine
            # will ever mark would misreport mode="handoff" forever and
            # pin a role preference nothing can satisfy. (Same
            # endpoint-labels-are-ground-truth rule as the autoscaler.)
            dspec = None
        if dspec is not None:
            from kubeai_tpu_torch.disagg import ROLE_DECODE, ROLE_PREFILL
            from kubeai_tpu_torch.disagg.handoff import M_DISAGG_REQUESTS

            if replayable:
                req.role = ROLE_PREFILL
                handoff_planned = True
                M_DISAGG_REQUESTS.inc(labels={"mode": "handoff"})
            else:
                req.role = ROLE_DECODE
                M_DISAGG_REQUESTS.inc(labels={"mode": "unified"})
            if req.trace is not None:
                req.trace.attrs["disagg_mode"] = "handoff" if replayable else "unified"
        # Latency hedging eligibility: opt-in, non-streaming JSON only
        # (a hedge re-issues the whole request; streams replay instead).
        hedge_on = (
            (hedging_enabled() if self.hedge_enabled is None else self.hedge_enabled)
            and req.body is not None
            and not req.body.stream
            and req.raw_body is None
        )

        tb: SpanBuilder | None = req.trace
        # Propagate downstream (dropping any case-variant inbound copy so
        # the engine never sees a duplicated header). The traceparent is
        # REWRITTEN, not forwarded: the engine's spans must parent onto
        # the proxy's span, not onto the client's.
        headers = {
            k: v for k, v in headers.items()
            if k.lower() not in (
                "x-request-id", "traceparent", "x-request-deadline",
                "x-handoff-planned", "x-kubeai-tenant",
                "x-priority", "x-preemptible",
                # Parked-KV resume offer: proxy-internal, stamped only
                # on resume dispatches — a client-forged offer could
                # point an engine at an arbitrary fetch target.
                "x-kv-key", "x-kv-source", "x-kv-tokens",
            )
        }
        headers["X-Request-ID"] = req.id
        # QoS hop: the VALIDATED class (inbound copies stripped above).
        headers[PRIORITY_HEADER] = req.priority or DEFAULT_CLASS
        # Preemptible stamp: batch streams the replay machinery can
        # resume — and never a flight with a planned handoff (one
        # resume dial per flight; handoff wins, it was planned first).
        preemptible = (
            req.priority == "batch" and replayable and not handoff_planned
        )
        if preemptible:
            headers[PREEMPTIBLE_HEADER] = "1"
        # Internal tenant hop: inbound copies were stripped above (an
        # external client must not choose its attribution bucket); the
        # engine's cost accounting keys on this header. Canary probes
        # stay un-attributed so engine-side slot/page-seconds exclude
        # synthetic traffic too (their X-KubeAI-Canary marker passes
        # through untouched).
        if req.tenant and not req.canary:
            headers[TENANT_HEADER] = req.tenant
        if handoff_planned:
            # Prefill replicas cap ONLY streams the proxy will actually
            # hand off: an ineligible stream that failed open onto the
            # prefill pool (decode pool ejected) must serve WHOLE — a
            # cap there would truncate the client at K tokens with a
            # marker nobody consumes.
            headers["X-Handoff-Planned"] = "1"
        if tb is not None:
            headers["traceparent"] = tb.child_traceparent()
        last_err: Exception | str | None = None
        attempts = self.max_retries + 1
        failed_addrs: set[str] = set()
        for attempt in range(attempts):
            rem = remaining()
            if rem is not None and rem <= 0:
                raise APIError(
                    504, f"deadline exceeded after {req.timeout:.3f}s "
                    f"(attempt {attempt + 1}; last error: {last_err})"
                )
            await_t = self.await_timeout if rem is None else min(self.await_timeout, rem)
            try:
                addr, done = self.lb.await_best_address(
                    req, timeout=await_t, cancelled=cancelled,
                    exclude=failed_addrs or None,
                )
            except TimeoutError as e:
                # handle()'s except clause performs the gauge release.
                if rem is not None and remaining() <= 0:
                    raise APIError(
                        504,
                        f"deadline exceeded awaiting endpoints for {req.model_name}",
                    )
                raise APIError(
                    503, f"no ready endpoints for {req.model_name}: {e}",
                    headers={"Retry-After": RETRY_AFTER_HINT},
                )
            t_conn = time.monotonic()
            # Forward the REMAINING budget (recomputed per attempt): the
            # engine aborts queued/mid-decode work whose deadline passed
            # instead of burning device time for a caller that gave up.
            rem = remaining()
            if rem is not None:
                headers["X-Request-Deadline"] = f"{max(rem, 0.001):.3f}"
            try:
                if hedge_on and attempt == 0:
                    resp, conn, addr, done, t_conn = self._connect_hedged(
                        req, addr, done, path, headers, body, rem,
                        failed_addrs, cancelled, tb,
                    )
                else:
                    resp, conn = self._connect(addr, path, headers, body, timeout=rem)
            except _HedgeFailed as e:
                # done()/breaker/failed_addrs handled inside the hedge.
                last_err = e.err
                if attempt < attempts - 1 and not self.budget.try_take("error"):
                    raise APIError(
                        502,
                        f"upstream unavailable and retry budget exhausted: {last_err}",
                    )
                continue
            except (ConnectionError, OSError, http.client.HTTPException) as e:
                done()
                self.lb.report_result(req.model_name, addr, ok=False)
                failed_addrs.add(addr)
                last_err = e
                if tb is not None:
                    tb.add_span(
                        "upstream", t_conn,
                        endpoint=addr, attempt=attempt + 1, error=str(e)[:200],
                    )
                log.info("connection to %s failed (%s); attempt %d", addr, e, attempt + 1)
                # The NEXT attempt is a retry: it must fit the budget.
                # Out of budget = fail fast (no retry amplification when
                # the whole fleet is down).
                if attempt < attempts - 1 and not self.budget.try_take("error"):
                    raise APIError(
                        502,
                        f"upstream unavailable and retry budget exhausted: {e}",
                    )
                continue
            # 429 (queue full / draining) fails over like a 5xx — another
            # replica may have capacity — but does NOT feed the breaker:
            # a saturated endpoint is alive and healthy, just busy. On
            # exhaustion (attempts OR retry budget) the client gets the
            # upstream's own response — budget exhaustion means fail
            # fast with the upstream's error, not silent extra load.
            if (
                resp.status in RETRYABLE_CODES or resp.status == 429
            ) and attempt < attempts - 1 and self.budget.try_take("error"):
                log.info(
                    "retrying %s after upstream %d (attempt %d)",
                    req.model_name, resp.status, attempt + 1,
                )
                if resp.status != 429:
                    self.lb.report_result(req.model_name, addr, ok=False)
                failed_addrs.add(addr)
                if tb is not None:
                    tb.add_span(
                        "upstream", t_conn,
                        endpoint=addr, attempt=attempt + 1, status=resp.status,
                    )
                try:
                    # Keep the upstream's own error: retry exhaustion must
                    # surface WHY the last attempt failed, not a generic
                    # "unavailable" (clients act on engine error bodies).
                    err_body = resp.read()
                    last_err = (
                        f"upstream status {resp.status}: "
                        f"{err_body[:300].decode('utf-8', 'replace')}"
                    )
                except Exception:
                    last_err = f"upstream status {resp.status}"
                finally:
                    conn.close()
                    done()
                continue
            log.info(
                "request id=%s model=%s upstream=%s status=%d attempt=%d dur_ms=%.0f",
                req.id, req.model_name, addr, resp.status, attempt + 1,
                (time.monotonic() - t0) * 1000,
            )
            resp_headers = [
                (k, v) for k, v in resp.getheaders() if k.lower() != "x-request-id"
            ] + [("X-Request-ID", req.id)]
            if tb is not None:
                tb.attrs.update(endpoint=addr, status=resp.status, attempts=attempt + 1)
            if resp.status >= 500:
                # Terminal 5xx (final attempt or non-retried): one failure
                # report; the body iter reports nothing further.
                self.lb.report_result(req.model_name, addr, ok=False)
                report = None
            else:
                if req.body is not None and not req.body.stream and resp.status < 400:
                    # Non-streaming SUCCESS headers latency feeds the
                    # hedge delay's p95 window (4xx excluded: fast 429s
                    # under saturation would shrink the delay and spawn
                    # more hedges exactly when the fleet is overloaded)
                    # and the gray-failure latency scorer.
                    self.hedge.record(time.monotonic() - t_conn)
                    self._observe_latency(
                        req.model_name, addr, time.monotonic() - t_conn
                    )
                # Success is reported at body EXHAUSTION: an endpoint that
                # returns 200 headers then dies mid-stream is failing, and
                # a half-open probe must not close the breaker until the
                # response actually completed. The attempt's start time
                # rides along so a success from a stream that began before
                # a later ejection cannot close the fresh breaker.
                def report(ok, _model=req.model_name, _addr=addr, _t=t_conn):
                    self.lb.report_result(_model, _addr, ok=ok, started_at=_t)
            if (
                replayable
                and resp.status == 200
                and (resp.getheader("Content-Type") or "").startswith(
                    "text/event-stream"
                )
            ):
                # Streaming + deterministic: mid-stream upstream death
                # resumes on another endpoint instead of truncating the
                # client's stream. Gated on the upstream ACTUALLY
                # answering SSE — re-framing a JSON body as events would
                # discard it.
                body_iter = self._stream_with_replay(
                    req, path, dict(headers), body, release, cancelled, tb,
                    resp, conn, done, addr, t_conn, failed_addrs, remaining,
                    handoff=dspec if handoff_planned else None, meter=meter,
                    preemptible=preemptible,
                )
            else:
                # Non-replayable SSE is still re-framed event-at-a-time
                # (recovery.sse_events, the repo's ONE SSE rule): the
                # meter needs whole events to spot the usage chunk, and
                # an injected usage chunk must be strippable here too.
                ctype = (resp.getheader("Content-Type") or "").lower()
                is_sse = resp.status == 200 and ctype.startswith("text/event-stream")
                # Buffer-for-usage only when a usage block can exist:
                # tee-ing every large non-JSON body (audio, base64
                # embedding matrices) would pin up to the parse cap per
                # in-flight request for nothing.
                # First-byte latency feed for the SSE passthrough path
                # (non-streaming responses were already observed at the
                # headers site above — don't double-count).
                observe = None
                if is_sse:
                    def observe(_m=req.model_name, _a=addr, _t=t_conn):
                        self._observe_latency(_m, _a, time.monotonic() - _t)
                body_iter = self._body_iter(
                    resp, conn, done, release, tb=tb, t_conn=t_conn,
                    cancelled=cancelled, report=report, meter=meter,
                    sse=is_sse,
                    parse_json=ctype.startswith("application/json"),
                    observe=observe,
                )
            return ProxyResult(resp.status, resp_headers, body_iter)
        # WARNING (not info): terminal failures land in the /debug/logs
        # ring and every incident snapshot, trace-correlated.
        log.warning(
            "request id=%s model=%s failed after %d attempts: %s",
            req.id, req.model_name, attempts, last_err,
        )
        raise APIError(502, f"upstream unavailable after {attempts} attempts: {last_err}")

    def _observe_latency(self, model_name: str, addr: str, seconds: float) -> None:
        """Gray-failure evidence feed: per-attempt TTFT/headers latency
        into the balancer's latency scorer. getattr-guarded — tests run
        the proxy against minimal fake balancers — and failures are
        swallowed: scoring must never break serving."""
        fn = getattr(self.lb, "observe_latency", None)
        if fn is None:
            return
        try:
            fn(model_name, addr, seconds)
        except Exception:
            log.debug("latency observation failed", exc_info=True)

    def _has_role_endpoints(self, model_name: str) -> bool:
        """Whether the model's deployment is actually role-planned: at
        least one endpoint carries a phase-role label (the ground truth
        of what the controller deployed, vs what the spec asks for)."""
        roles_fn = getattr(self.lb, "get_endpoint_roles", None)
        if not callable(roles_fn):
            return False
        try:
            return any(roles_fn(model_name).values())
        except Exception:
            return False

    def _connect(self, addr: str, path: str, headers: dict[str, str], body: bytes, timeout: float | None = None):
        # Failpoint: chaos tests inject connect errors/delays/hangs (and
        # body corruption) here without monkeypatching http.client.
        body = fault("proxy.connect", payload=body)
        sock_t = self.connect_timeout if timeout is None else max(
            min(self.connect_timeout, timeout), 0.001
        )
        host, _, port = addr.partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80), timeout=sock_t)
        # Strip hop-by-hop headers; body was rewritten (adapter names).
        fwd = {
            k: v
            for k, v in headers.items()
            if k.lower() not in ("host", "content-length", "connection", "transfer-encoding")
        }
        fwd["Content-Length"] = str(len(body))
        conn.request("POST", self._upstream_path(path), body=body, headers=fwd)
        return conn.getresponse(), conn

    def _connect_hedged(self, req, addr, done, path, headers, body, rem, failed_addrs, cancelled, tb):
        """First-attempt connect with an optional latency hedge: if the
        primary has produced no response headers within the p95-based
        hedge delay, a second identical request goes to a different
        endpoint (budget-gated); the first response wins and the loser
        is abandoned (connection closed — never double-answered).

        Returns (resp, conn, addr, done, t_conn) for the winner. Raises
        _HedgeFailed when every spawned attempt failed — with all
        cleanup (done callbacks, breaker feedback, failed_addrs)
        already performed."""
        import queue as _q

        results: "_q.Queue[tuple]" = _q.Queue()
        settled = threading.Event()
        lock = threading.Lock()

        def fetch(a, d, t_start):
            try:
                resp, conn = self._connect(a, path, dict(headers), body, timeout=rem)
            except Exception as e:
                with lock:
                    if not settled.is_set():
                        results.put(("err", a, d, e, t_start))
                        return
                d()  # settled without us: release the endpoint pick
                return
            with lock:
                if not settled.is_set():
                    results.put(("resp", a, d, resp, conn, t_start))
                    return
            # Lost the hedge: abandon quietly (no breaker feedback — the
            # endpoint answered, we just didn't wait).
            try:
                conn.close()
            finally:
                d()

        t0 = time.monotonic()
        threading.Thread(
            target=fetch, args=(addr, done, t0), daemon=True, name="proxy-hedge-0"
        ).start()
        outstanding = 1
        first = None
        try:
            first = results.get(timeout=max(self.hedge.delay(), 0.001))
        except _q.Empty:
            # Primary is slow. Hedge if a DIFFERENT endpoint exists
            # (hedging the same replica is pure load) and the budget
            # grants a token — checked in that order so the hedge
            # counter only counts hedges that actually launched.
            try:
                addr2, done2 = self.lb.await_best_address(
                    req, timeout=0.05, cancelled=cancelled,
                    exclude={addr} | failed_addrs,
                )
            except (TimeoutError, RuntimeError):
                addr2 = None
            if addr2 is not None and addr2 != addr and self.budget.try_take("hedge"):
                log.info(
                    "hedging %s after %.0fms against %s",
                    req.model_name, self.hedge.delay() * 1000, addr2,
                )
                if tb is not None:
                    tb.attrs["hedged"] = True
                threading.Thread(
                    target=fetch, args=(addr2, done2, time.monotonic()),
                    daemon=True, name="proxy-hedge-1",
                ).start()
                outstanding += 1
            elif addr2 is not None:
                done2()  # same endpoint (fail-open) or no budget
        winner = None
        first_err: Exception | None = None
        while outstanding:
            if first is not None:
                entry, first = first, None
            else:
                entry = results.get()
            outstanding -= 1
            if entry[0] == "resp":
                winner = entry
                break
            _, a, d, e, _t = entry
            d()
            self.lb.report_result(req.model_name, a, ok=False)
            failed_addrs.add(a)
            if first_err is None:
                first_err = e
        with lock:
            settled.set()
        # Drain results that landed before we settled (a late loser).
        while True:
            try:
                entry = results.get_nowait()
            except _q.Empty:
                break
            if entry[0] == "resp":
                _, a, d, resp, conn, _t = entry
                try:
                    conn.close()
                finally:
                    d()
            else:
                entry[2]()
        if winner is None:
            raise _HedgeFailed(first_err or ConnectionError("hedge: no result"))
        # No latency record here: the retry loop's success path records
        # the winner (status < 400 only — a fast 429 under saturation
        # must not drag the hedge delay down and spawn MORE hedges
        # exactly when the fleet is overloaded).
        _, a, d, resp, conn, t_start = winner
        return resp, conn, a, d, t_start

    def _stream_with_replay(self, req, path, base_headers, body, release, cancelled, tb, resp, conn, done, addr, t_conn, failed_addrs, remaining, handoff=None, meter=None, preemptible=False):
        """Stream an SSE body with mid-stream replay: events are
        forwarded whole (a half-event from a dying upstream never
        reaches the client); when the upstream dies after N delivered
        events, the request is re-dispatched to another endpoint with
        ``X-Resume-Tokens: N`` and the first N regenerated events are
        suppressed — the client sees one uninterrupted stream with zero
        duplicated and zero dropped events. Eligibility (deterministic,
        single-choice, streaming) was checked by the caller; attempts
        are bounded by max_retries, gated by the retry budget, and
        deadline-aware. When replay is impossible the original error
        propagates and the client sees the truncation, exactly as
        before.

        *handoff* (the model's Disaggregation spec, or None) arms the
        PLANNED variant of the same mechanism: the first upstream is a
        prefill replica whose budget-capped generation ends with a
        ``finish_reason: "handoff"`` marker chunk. The marker is
        withheld from the client; the stream cuts over to a decode
        replica carrying the same resume cursor a crash replay would,
        and a decode replica dying AFTER the cutover falls back to the
        ordinary replay path (req.role keeps routing to the decode
        pool).

        *preemptible* arms the third variant: the engine may seize this
        batch stream's slot mid-decode for a waiting interactive
        request, ending it with a ``finish_reason: "preempted"`` marker
        (docs/qos.md). Same mechanics as the handoff — marker withheld,
        re-dispatch with the resume cursor — except no endpoint is
        blacklisted (the preempting replica is healthy and is the
        natural resume target) and a flight can be preempted more than
        once."""
        forwarded = 0  # data events delivered to the client (excl. [DONE])
        suppress = 0  # data events to drop from the current (replayed) stream
        replays = 0
        completed = False
        awaiting_first = True  # per-upstream TTFT not yet observed

        try:
            while True:
                died: Exception | None = None
                cutover = False
                preempted = False
                try:
                    for ev in sse_events(_chunk_reader(resp)):
                        if awaiting_first:
                            # Per-UPSTREAM TTFT (reset on every replay/
                            # handoff/resume re-acquire): the latency
                            # scorer judges endpoints, so each upstream's
                            # first byte is its own evidence.
                            awaiting_first = False
                            self._observe_latency(
                                req.model_name, addr,
                                time.monotonic() - t_conn,
                            )
                        if handoff is not None and _is_handoff_event(ev):
                            # The prefill engine's budget-cap marker:
                            # never forwarded — the decode stream owns
                            # the real finish. Any parked-KV offer on
                            # the marker rides the resume dispatch so
                            # the decode replica can import instead of
                            # replaying the prefix.
                            req.kv_offer = _extract_kv_offer(ev)
                            cutover = True
                            break
                        if preemptible and _is_preempt_event(ev):
                            # The engine parked this batch stream to
                            # admit interactive work: never forwarded —
                            # the resumed stream owns the real finish.
                            req.kv_offer = _extract_kv_offer(ev)
                            preempted = True
                            break
                        if meter is not None and meter.observe_event(ev):
                            # Proxy-injected usage chunk: metered, then
                            # withheld — the client never asked for it,
                            # and it must not perturb the resume cursor.
                            continue
                        if is_token_event(ev):
                            if suppress:
                                suppress -= 1
                                continue
                            forwarded += 1
                        if meter is not None:
                            meter.first_byte()
                        yield ev
                except Exception as e:
                    died = e
                if cutover:
                    # The prefill upstream finished its whole job:
                    # clean success for the breaker, then the planned
                    # re-dispatch (conn/done nulled first — on a failed
                    # cutover the finally must not double-release).
                    self.lb.report_result(
                        req.model_name, addr, ok=True, started_at=t_conn
                    )
                    try:
                        conn.close()
                    finally:
                        done()
                    conn = None
                    done = None
                    resp, conn, done, addr, t_conn = self._handoff_to_decode(
                        req, path, base_headers, body, cancelled, tb,
                        addr, failed_addrs, remaining, forwarded,
                    )
                    handoff = None  # one planned cutover per request
                    suppress = forwarded
                    awaiting_first = True
                    continue
                if preempted:
                    # The replica shed this batch stream ON PURPOSE —
                    # clean success for the breaker — and stays
                    # routable: once its interactive burst drains it is
                    # the natural resume target (warm prefix cache).
                    self.lb.report_result(
                        req.model_name, addr, ok=True, started_at=t_conn
                    )
                    try:
                        conn.close()
                    finally:
                        done()
                    conn = None
                    done = None
                    if tb is not None:
                        tb.add_span(
                            "preempted", t_conn,
                            endpoint=addr, delivered_events=forwarded,
                        )
                    log.info(
                        "request id=%s preempted by %s after %d events; resuming",
                        req.id, addr, forwarded,
                    )
                    resp, conn, done, addr, t_conn = acquire_resume_upstream(
                        self, req, path, base_headers, body, cancelled,
                        remaining, forwarded,
                    )
                    record_resume()
                    suppress = forwarded
                    awaiting_first = True
                    log.info(
                        "request id=%s resumed on %s (resume at event %d)",
                        req.id, addr, forwarded,
                    )
                    continue
                if died is None:
                    expected = getattr(resp, "length", None)
                    if expected not in (None, 0):
                        # Content-Length truncation = mid-stream death.
                        died = http.client.IncompleteRead(b"", expected)
                if died is None:
                    # Clean exhaustion: success for the breaker.
                    self.lb.report_result(
                        req.model_name, addr, ok=True, started_at=t_conn
                    )
                    if tb is not None:
                        tb.add_span(
                            "upstream", t_conn,
                            endpoint=addr, status=resp.status, replays=replays,
                        )
                    completed = True
                    return
                # Upstream died mid-stream.
                self.lb.report_result(req.model_name, addr, ok=False)
                failed_addrs.add(addr)
                try:
                    conn.close()
                finally:
                    done()
                conn = None
                done = None
                if tb is not None:
                    tb.add_span(
                        "upstream", t_conn,
                        endpoint=addr, error=str(died)[:200],
                        delivered_events=forwarded,
                    )
                log.info(
                    "request id=%s upstream %s died mid-stream after %d events: %s",
                    req.id, addr, forwarded, died,
                )
                resp, conn, done, addr, t_conn, replays = (
                    self._acquire_replay_upstream(
                        req, path, base_headers, body, cancelled,
                        failed_addrs, remaining, forwarded, replays, died,
                    )
                )
                suppress = forwarded
                awaiting_first = True
                log.info(
                    "request id=%s replaying on %s (resume at event %d)",
                    req.id, addr, forwarded,
                )
        finally:
            if conn is not None:
                conn.close()
            if done is not None:
                done()
            release()
            if cancelled is not None and cancelled.is_set():
                outcome = "cancelled"
            elif completed:
                outcome = "ok"
            else:
                outcome = "error"
            if meter is not None:
                meter.finish(outcome)
            if tb is not None:
                tb.attrs["replays"] = replays
                tb.finish(outcome, status=200)

    def _handoff_to_decode(self, req, path, base_headers, body, cancelled, tb, prefill_addr, failed_addrs, remaining, forwarded):
        """Planned prefill→decode cutover (docs/disaggregation.md): flip
        the request's role to the decode pool, acquire a decode
        upstream carrying the resume cursor, and account the handoff
        (metrics + a trace record). The caller already released the
        prefill connection. On failure the raised HandoffError
        propagates out of the stream generator — the client sees the
        truncation, exactly like an exhausted replay."""
        from kubeai_tpu_torch.disagg import ROLE_DECODE
        from kubeai_tpu_torch.disagg.handoff import (
            M_HANDOFF_LATENCY,
            M_HANDOFFS,
            HandoffError,
            acquire_handoff_upstream,
        )

        t_hand = time.monotonic()
        req.role = ROLE_DECODE
        rem = remaining()
        if rem is not None and rem <= 0:
            M_HANDOFFS.inc(labels={"outcome": "deadline"})
            if tb is not None:
                tb.add_span(
                    "handoff", t_hand, source=prefill_addr,
                    events=forwarded, error="deadline",
                )
            raise HandoffError(
                f"deadline exceeded at handoff after {forwarded} events"
            )
        try:
            resp, conn, done, addr, t_conn = acquire_handoff_upstream(
                self, req, path, base_headers, body, cancelled,
                failed_addrs, remaining, forwarded,
            )
        except HandoffError as e:
            outcome = "deadline" if "deadline" in str(e) else "failed"
            M_HANDOFFS.inc(labels={"outcome": outcome})
            if tb is not None:
                tb.add_span(
                    "handoff", t_hand, source=prefill_addr,
                    events=forwarded, error=str(e)[:200],
                )
            log.info(
                "request id=%s handoff failed after %d events: %s",
                req.id, forwarded, e,
            )
            raise
        M_HANDOFF_LATENCY.observe(time.monotonic() - t_hand)
        M_HANDOFFS.inc(labels={"outcome": "ok"})
        if tb is not None:
            tb.add_span(
                "handoff", t_hand, source=prefill_addr, endpoint=addr,
                events=forwarded,
            )
        log.info(
            "request id=%s handed off %s -> %s at event %d",
            req.id, prefill_addr, addr, forwarded,
        )
        return resp, conn, done, addr, t_conn

    def _acquire_replay_upstream(self, req, path, base_headers, body, cancelled, failed_addrs, remaining, forwarded, replays, died):
        """Find and connect a fresh endpoint for a mid-stream replay.
        Each attempt (including connect failures and non-200 answers)
        consumes one replay slot and one retry-budget token. Raises the
        original *died* error when replay is not possible — the client
        then sees the truncated stream it would have seen without the
        recovery layer."""
        while True:
            rem = remaining()
            if (
                (cancelled is not None and cancelled.is_set())
                or replays >= self.max_retries
                or (rem is not None and rem <= 0)
                or not self.budget.try_take("replay")
            ):
                raise died
            replays += 1
            await_t = 5.0 if rem is None else min(5.0, max(rem, 0.001))
            try:
                addr, done = self.lb.await_best_address(
                    req, timeout=await_t, cancelled=cancelled,
                    exclude=failed_addrs or None,
                )
            except (TimeoutError, RuntimeError):
                raise died from None
            hdrs = dict(base_headers)
            # A replay keeps the planned-handoff intent only while the
            # request is still on its prefill leg: a post-cutover
            # replay that fails open onto the prefill replica must be
            # served whole, not budget-capped a second time.
            if getattr(req, "role", "") != "prefill":
                hdrs.pop("X-Handoff-Planned", None)
            resp, conn, t_conn, err = self._connect_resume_upstream(
                req, addr, done, path, hdrs, body, remaining(),
                failed_addrs, forwarded,
            )
            if resp is None:
                log.warning("replay to %s failed: %s", addr, err)
                continue
            return resp, conn, done, addr, t_conn, replays

    def _connect_resume_upstream(self, req, addr, done, path, hdrs, body, rem, failed_addrs, forwarded):
        """The shared connect-and-validate step for RESUMED dispatches —
        crash replays and planned handoffs both graft a fresh upstream
        into the client's open stream, so both must stamp the resume
        cursor + remaining deadline and accept only a 200 SSE answer.
        One implementation keeps the two legs from drifting.

        Returns ``(resp, conn, t_conn, None)`` on success, or
        ``(None, None, None, err)`` with ALL failure bookkeeping done
        (endpoint-pick release, breaker feedback, failed-address)."""
        # The resume cursor: how many stream events the client has
        # already received — the engine logs/records it; the proxy
        # suppresses exactly this many events of the fresh stream.
        hdrs["X-Resume-Tokens"] = str(forwarded)
        # Parked-KV offer captured at the preempt/handoff marker: stamp
        # it so the resume target can import the serialized pages
        # instead of replaying the prefix. Skipped when the offer's
        # source replica has since been marked dead — its park store
        # died with it, and the fetch would only burn resume latency.
        # Restore is strictly best-effort: a stale/missing/corrupt
        # offer degrades to plain replay engine-side.
        offer = getattr(req, "kv_offer", None)
        if offer is not None and offer["source"] not in failed_addrs:
            hdrs[KV_KEY_HEADER] = offer["key"]
            hdrs[KV_SOURCE_HEADER] = offer["source"]
            hdrs[KV_TOKENS_HEADER] = str(offer["tokens"])
        else:
            for h in (KV_KEY_HEADER, KV_SOURCE_HEADER, KV_TOKENS_HEADER):
                hdrs.pop(h, None)
        if rem is not None:
            hdrs["X-Request-Deadline"] = f"{max(rem, 0.001):.3f}"
        t_conn = time.monotonic()
        try:
            resp, conn = self._connect(addr, path, hdrs, body, timeout=rem)
        except (ConnectionError, OSError, http.client.HTTPException) as e:
            done()
            self.lb.report_result(req.model_name, addr, ok=False)
            failed_addrs.add(addr)
            return None, None, None, e
        if resp.status != 200 or not (
            resp.getheader("Content-Type") or ""
        ).startswith("text/event-stream"):
            # Only a fresh 200 SSE stream can be grafted into the open
            # stream. A saturated 429 is alive-but-busy: like the main
            # retry loop, only 5xx feeds the breaker.
            try:
                resp.read()
            except Exception:
                pass
            conn.close()
            done()
            if resp.status >= 500:
                self.lb.report_result(req.model_name, addr, ok=False)
            failed_addrs.add(addr)
            return None, None, None, f"resume upstream answered {resp.status}"
        return resp, conn, t_conn, None

    @staticmethod
    def _body_iter(resp, conn, done, release, tb=None, t_conn=None, cancelled=None, report=None, meter=None, sse=False, parse_json=False, observe=None):
        """Stream the upstream body; exactly-once cleanup on exhaustion or
        generator close (client disconnect). The proxy timeline closes
        HERE — the upstream span covers connect through last byte, so
        streaming time is attributed, not just headers latency.

        *report* (breaker feed) fires at most once: ok=True on clean
        exhaustion, ok=False when the UPSTREAM read dies mid-stream.
        Client disconnects (generator close) report nothing — they say
        nothing about endpoint health.

        *meter* (tenant accounting) gets first-byte TTFT, the buffered
        JSON body's usage block (non-SSE), and — with *sse* — each
        whole event, so a proxy-injected usage chunk can be metered and
        withheld. *sse* re-frames the body via recovery.sse_events: a
        half-event from a dying upstream is discarded, which is what
        the raw IncompleteRead delivered to the client anyway."""
        clean = False
        try:
            try:
                if sse:
                    # flush_tail: this is a passthrough (no resume
                    # cursor to protect) — a third-party stream whose
                    # final event lacks the terminating blank line
                    # still delivers every byte on clean EOF.
                    for ev in sse_events(_chunk_reader(resp), flush_tail=True):
                        if observe is not None:
                            # First event = this attempt's TTFT for the
                            # gray-failure latency scorer (fires once).
                            observe()
                            observe = None
                        if meter is not None:
                            if meter.observe_event(ev):
                                continue  # injected usage chunk: strip
                            meter.first_byte()
                        yield ev
                else:
                    while True:
                        chunk = resp.read(65536)
                        if not chunk:
                            break
                        if meter is not None:
                            meter.first_byte()
                            if parse_json:
                                meter.feed(chunk)
                        yield chunk
            except Exception:
                # Endpoint died mid-stream: passive health must see it
                # (this is exactly the "dead endpoint keeps receiving
                # fresh requests" window the breaker closes).
                if report is not None:
                    report(False)
                    report = None
                raise
            # http.client's bounded read() returns b"" on early EOF
            # instead of raising (CPython compat choice) — without this
            # check a Content-Length body truncated by endpoint death
            # would be forwarded as a complete, valid-looking response.
            expected = getattr(resp, "length", None)
            if expected not in (None, 0):
                if report is not None:
                    report(False)
                    report = None
                raise http.client.IncompleteRead(b"", expected)
            if meter is not None and parse_json:
                meter.parse_body()
            clean = True
            if report is not None:
                report(True)
                report = None
        finally:
            conn.close()
            done()
            release()
            if cancelled is not None and cancelled.is_set():
                outcome = "cancelled"
            elif not clean:
                outcome = "error"
            else:
                outcome = "ok" if resp.status < 400 else "error"
            if meter is not None:
                meter.finish(outcome)
            if tb is not None:
                if t_conn is not None:
                    tb.add_span(
                        "upstream", t_conn,
                        endpoint=tb.attrs.get("endpoint", ""),
                        status=resp.status,
                    )
                tb.finish(outcome, status=resp.status)

    @staticmethod
    def _upstream_path(path: str) -> str:
        """/openai/v1/... -> /v1/... (the engine serves /v1)."""
        idx = path.find("/v1/")
        return path[idx:] if idx >= 0 else path
