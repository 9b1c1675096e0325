"""gcppubsub:// driver over the Pub/Sub REST API (no client library).

Port of kubeai_tpu/messenger/gcp_pubsub.py: the JAX package's code,
its imports in this package.

URL shapes follow gocloud's gcppubsub driver (ref:
internal/manager/run.go:50):

    topic:        gcppubsub://projects/P/topics/T
    subscription: gcppubsub://projects/P/subscriptions/S

Endpoint selection mirrors the official clients: when
$PUBSUB_EMULATOR_HOST is set, requests go to http://<host> with no
auth (this is also what the test fake serves); otherwise to
https://pubsub.googleapis.com with an OAuth2 bearer token from
google.auth application-default credentials.

Semantics: at-least-once. receive() pulls one message; ack()
acknowledges; nack() sets the ack deadline to 0, making the service
redeliver immediately.
"""

from __future__ import annotations

import base64
import os
import threading
import time

from kubeai_tpu_torch.messenger.drivers import Message, Subscription, Topic

_SCOPE = "https://www.googleapis.com/auth/pubsub"


class _Client:
    def __init__(self):
        import requests

        self._http = requests.Session()
        emulator = os.environ.get("PUBSUB_EMULATOR_HOST")
        if emulator:
            self.base = f"http://{emulator}/v1"
            self._creds = None
        else:
            import google.auth

            self.base = "https://pubsub.googleapis.com/v1"
            self._creds, _ = google.auth.default(scopes=[_SCOPE])
        self._lock = threading.Lock()

    def post(self, path: str, payload: dict, timeout: float = 30.0) -> dict:
        headers = {}
        if self._creds is not None:
            with self._lock:
                if not self._creds.valid:
                    import google.auth.transport.requests

                    self._creds.refresh(google.auth.transport.requests.Request())
                headers["Authorization"] = f"Bearer {self._creds.token}"
        resp = self._http.post(
            f"{self.base}/{path}", json=payload, headers=headers, timeout=timeout
        )
        if resp.status_code >= 400:
            raise RuntimeError(
                f"pubsub {path} -> {resp.status_code}: {resp.text[:300]}"
            )
        return resp.json() if resp.content else {}


class GcpPubSubTopic(Topic):
    def __init__(self, ref: str):
        # ref: projects/P/topics/T
        if "/topics/" not in ref:
            raise ValueError(f"gcppubsub topic url must be projects/P/topics/T, got {ref!r}")
        self.ref = ref
        self._client = _Client()

    def send(self, body: bytes) -> None:
        self._client.post(
            f"{self.ref}:publish",
            {"messages": [{"data": base64.b64encode(body).decode()}]},
        )


class GcpPubSubSubscription(Subscription):
    def __init__(self, ref: str):
        # ref: projects/P/subscriptions/S
        if "/subscriptions/" not in ref:
            raise ValueError(
                f"gcppubsub subscription url must be projects/P/subscriptions/S, got {ref!r}"
            )
        self.ref = ref
        self._client = _Client()

    def receive(self, timeout: float | None = None) -> Message | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            out = self._client.post(
                f"{self.ref}:pull", {"maxMessages": 1, "returnImmediately": True}
            )
            msgs = out.get("receivedMessages") or []
            if msgs:
                m = msgs[0]
                ack_id = m["ackId"]
                body = base64.b64decode(m["message"].get("data") or "")
                return Message(
                    body,
                    ack=lambda: self._client.post(
                        f"{self.ref}:acknowledge", {"ackIds": [ack_id]}
                    ),
                    # Deadline 0 = immediate redelivery (the standard
                    # Pub/Sub nack).
                    nack=lambda: self._client.post(
                        f"{self.ref}:modifyAckDeadline",
                        {"ackIds": [ack_id], "ackDeadlineSeconds": 0},
                    ),
                )
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.05)
