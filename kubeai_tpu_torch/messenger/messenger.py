"""Messenger: pub/sub request transport.

Port of kubeai_tpu/messenger/messenger.py: the JAX package's code,
its imports in this package.

Parity: internal/messenger/messenger.go:41-348 — a consumer loop with a
semaphore-bounded handler pool runs the same parse -> scale-from-zero ->
await-endpoint -> POST pipeline as the HTTP proxy, publishes responses
with status_code + correlation metadata, Acks handled messages, Nacks on
response-send failure, and throttles after consecutive errors.

Message format (parity: messenger.go:182-195):
    {"metadata": {...}, "path": "/v1/completions", "body": {...}}
Response:
    {"metadata": {...}, "status_code": 200, "body": {...}}
"""

from __future__ import annotations

import http.client
import json
import threading
import time

from kubeai_tpu_torch.messenger.drivers import open_subscription, open_topic
from kubeai_tpu_torch.metrics import ACTIVE_REQUESTS, default_registry
from kubeai_tpu_torch.obs.logs import get_logger
from kubeai_tpu_torch.proxy.apiutils import APIError, parse_request, sanitize_request_id

log = get_logger("kubeai_tpu_torch.messenger")


class Messenger:
    def __init__(
        self,
        requests_url: str,
        responses_url: str,
        model_client,
        lb,
        max_handlers: int = 1,
        error_max_backoff: float = 30.0,
        await_timeout: float = 600.0,
    ):
        self.requests_url = requests_url
        self.responses_url = responses_url
        self.model_client = model_client
        self.lb = lb
        self.max_handlers = max_handlers
        self.error_max_backoff = error_max_backoff
        self.await_timeout = await_timeout
        self._sem = threading.Semaphore(max_handlers)
        self._consecutive_errors = 0
        self._running = False
        self._thread: threading.Thread | None = None
        self.active = default_registry.gauge(ACTIVE_REQUESTS, "active requests")
        self._topic = None
        self._sub = None

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="messenger", daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    # -- consume loop (ref: messenger.go:82-170) ---------------------------

    def _loop(self):
        while self._running:
            try:
                if self._sub is None:
                    self._sub = open_subscription(self.requests_url)
                    self._topic = open_topic(self.responses_url)
                msg = self._sub.receive(timeout=0.2)
            except Exception as e:
                # Subscription self-heal with backoff
                # (ref: messenger.go:98-127).
                log.warning("subscription error: %s; recreating", e)
                self._sub = None
                time.sleep(min(2 ** min(self._consecutive_errors, 5), self.error_max_backoff))
                self._consecutive_errors += 1
                continue
            if msg is None:
                continue
            self._sem.acquire()
            threading.Thread(target=self._handle, args=(msg,), daemon=True).start()
            # Consecutive-error throttle (ref: messenger.go:150-160).
            if self._consecutive_errors > 0:
                time.sleep(min(0.1 * self._consecutive_errors, self.error_max_backoff))

    def _handle(self, msg):
        try:
            self._handle_request(msg)
            self._consecutive_errors = 0
        except Exception:
            log.exception("message handling failed")
            self._consecutive_errors += 1
        finally:
            self._sem.release()

    # -- pipeline (ref: handleRequest, messenger.go:180-236) ---------------

    def _handle_request(self, msg):
        try:
            envelope = json.loads(msg.body)
            metadata = envelope.get("metadata") or {}
            path = envelope["path"]
            body = json.dumps(envelope["body"]).encode()
        except (json.JSONDecodeError, KeyError) as e:
            log.warning("malformed message dropped: %s", e)
            msg.ack()  # poison messages must not loop forever
            return

        try:
            req = parse_request(self.model_client, body, path, {})
        except APIError as e:
            self._respond(msg, metadata, e.code, {"error": {"message": e.message}})
            return

        # Correlation id: a caller-supplied metadata request_id wins
        # (sanitized — it goes into headers and log lines), else the
        # parsed id; propagated to the engine via X-Request-ID and echoed
        # in the response metadata (same contract as the HTTP proxy).
        rid = sanitize_request_id(str(metadata.get("request_id") or "")) or req.id
        metadata = {**metadata, "request_id": rid}
        log.info("request id=%s model=%s path=%s transport=messenger", rid, req.model_name, path)

        labels = {"request_model": req.model_name, "request_type": "messenger"}
        self.active.add(1, labels=labels)
        try:
            self.model_client.scale_at_least_one_replica(req.model_obj)
            addr, done = self.lb.await_best_address(req, timeout=self.await_timeout)
            try:
                status, resp_body = self._send_backend(addr, path, req.body_bytes(), rid)
            finally:
                done()
        except TimeoutError:
            self._respond(msg, metadata, 503, {"error": {"message": "no ready endpoints"}})
            return
        except Exception as e:
            self._respond(msg, metadata, 502, {"error": {"message": str(e)}})
            return
        finally:
            self.active.add(-1, labels=labels)
        self._respond(msg, metadata, status, resp_body)

    def _send_backend(self, addr: str, path: str, body: bytes, rid: str = ""):
        """POST to the engine (ref: sendBackendRequest, messenger.go:285-306)."""
        host, _, port = addr.partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80), timeout=self.await_timeout)
        try:
            # parse_request already rejected paths without a /v1/ suffix;
            # guard anyway so a typo'd path can't become a garbage URL.
            idx = path.find("/v1/")
            if idx < 0:
                raise ValueError(f"unsupported inference path {path!r}")
            upstream = path[idx:]
            headers = {"Content-Type": "application/json"}
            if rid:
                headers["X-Request-ID"] = rid
            conn.request("POST", upstream, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                parsed = json.loads(data)
            except json.JSONDecodeError:
                parsed = {"raw": data.decode(errors="replace")}
            return resp.status, parsed
        finally:
            conn.close()

    def _respond(self, msg, metadata, status_code: int, body):
        """Publish the response; Nack the request if publishing fails
        (ref: sendResponse, messenger.go:308-348)."""
        payload = json.dumps(
            {"metadata": metadata, "status_code": status_code, "body": body}
        ).encode()
        try:
            self._topic.send(payload)
        except Exception:
            log.exception("failed to send response; nacking request")
            msg.nack()
            return
        msg.ack()
