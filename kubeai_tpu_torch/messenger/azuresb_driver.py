"""Azure Service Bus pub/sub driver — from-scratch REST client.

Port of kubeai_tpu/messenger/azuresb_driver.py: the JAX package's code,
its imports in this package.

The reference rides gocloud.dev's azuresb driver
(ref: internal/manager/run.go:47-53). Service Bus exposes a plain HTTP
surface that covers everything the messenger needs (public API):

    send        POST   {endpoint}/{queue}/messages            → 201
    peek-lock   POST   {endpoint}/{queue}/messages/head?timeout=N
                       → 201 + BrokerProperties header (LockToken,
                         MessageId), 204 when empty
    complete    DELETE {endpoint}/{queue}/messages/{id}/{lock} (Ack)
    unlock      PUT    {endpoint}/{queue}/messages/{id}/{lock} (Nack →
                       immediate redelivery)

Auth is a SAS token (HMAC-SHA256 over the URL-encoded resource + expiry,
public recipe) built from SERVICEBUS_CONNECTION_STRING:
    Endpoint=sb://ns.servicebus.windows.net/;SharedAccessKeyName=K;SharedAccessKey=S
http:// endpoints (tests/emulator) skip TLS; a missing key skips auth.

URL form:  azuresb://QUEUE
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import time
import urllib.error
import urllib.parse
import urllib.request

from kubeai_tpu_torch.messenger.drivers import Message, Subscription, Topic


def _conn() -> tuple[str, str, str]:
    """Returns (http endpoint, key name, key) from the connection string."""
    cs = os.environ.get("SERVICEBUS_CONNECTION_STRING", "")
    if not cs:
        raise ValueError("SERVICEBUS_CONNECTION_STRING is not set")
    parts = dict(
        p.split("=", 1) for p in cs.rstrip(";").split(";") if "=" in p
    )
    endpoint = parts.get("Endpoint", "").rstrip("/")
    if endpoint.startswith("sb://"):
        endpoint = "https://" + endpoint[len("sb://") :]
    return endpoint, parts.get("SharedAccessKeyName", ""), parts.get("SharedAccessKey", "")


def _sas_token(uri: str, key_name: str, key: str, ttl: int = 300) -> str:
    expiry = str(int(time.time()) + ttl)
    resource = urllib.parse.quote_plus(uri)
    to_sign = f"{resource}\n{expiry}"
    sig = base64.b64encode(
        hmac.new(key.encode(), to_sign.encode(), hashlib.sha256).digest()
    ).decode()
    return (
        f"SharedAccessSignature sr={resource}&sig={urllib.parse.quote_plus(sig)}"
        f"&se={expiry}&skn={key_name}"
    )


class _SbClient:
    def __init__(self, queue: str):
        if not queue:
            raise ValueError("azuresb:// url needs a queue name")
        self.endpoint, self._key_name, self._key = _conn()
        self.queue = queue.split("?")[0]

    def request(self, method: str, path: str, body: bytes = b"", timeout: float = 70):
        url = f"{self.endpoint}/{self.queue}{path}"
        req = urllib.request.Request(url, data=body or None, method=method)
        if self._key:
            req.add_header(
                "Authorization", _sas_token(url.split("?")[0], self._key_name, self._key)
            )
        req.add_header("Content-Type", "application/octet-stream")
        try:
            resp = urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            raise RuntimeError(
                f"servicebus {method} {path or '/messages'} failed: "
                f"HTTP {e.code}: {e.read()[:200]!r}"
            ) from e
        with resp:
            return resp.status, dict(resp.headers), resp.read()


class AzureSbTopic(Topic):
    def __init__(self, ref: str):
        self._client = _SbClient(ref)

    def send(self, body: bytes) -> None:
        self._client.request("POST", "/messages", body)


class AzureSbSubscription(Subscription):
    def __init__(self, ref: str):
        self._client = _SbClient(ref)

    def receive(self, timeout: float | None = None) -> Message | None:
        wait = max(1, min(int(timeout or 20), 55))
        try:
            status, headers, body = self._client.request(
                "POST", f"/messages/head?timeout={wait}", timeout=wait + 15
            )
        except RuntimeError as e:
            if "HTTP 204" in str(e):
                return None
            raise
        if status == 204:
            return None
        import json

        props = json.loads(headers.get("BrokerProperties", "{}"))
        lock, mid = props.get("LockToken", ""), props.get("MessageId", "")

        def ack():
            self._client.request("DELETE", f"/messages/{mid}/{lock}")

        def nack():
            self._client.request("PUT", f"/messages/{mid}/{lock}")

        return Message(body, ack=ack, nack=nack)
