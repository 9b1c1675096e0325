"""NATS pub/sub driver — from-scratch core-protocol client.

Port of kubeai_tpu/messenger/nats_driver.py: the JAX package's code,
its imports in this package.

The reference rides gocloud.dev's natspubsub driver
(ref: internal/manager/run.go:47-53), which speaks CORE NATS: plain
subjects, queue-group subscriptions for competing consumers, and — by
protocol design — at-most-once delivery: core NATS has no acks, so
gocloud's driver treats Ack as a no-op and cannot Nack. This driver
matches those semantics exactly (Nack republishes the body to the
subject — the strongest redelivery core NATS can express; documented
divergence: a crash between receive and re-publish loses the message,
same as the reference).

Protocol (text, line-oriented; public spec):
    S->C  INFO {...}                 C->S  CONNECT {...}
    C->S  SUB <subject> [queue] <sid>
    C->S  PUB <subject> <#bytes>\r\n<payload>\r\n
    S->C  MSG <subject> <sid> [reply] <#bytes>\r\n<payload>\r\n
    both  PING / PONG

URL form:  nats://SUBJECT          (topic)
           nats://SUBJECT?queue=G  (subscription; queue group G)
Env:       NATS_URL  host:port of the server (default localhost:4222).
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading

from kubeai_tpu_torch.messenger.drivers import Message, Subscription, Topic


# Dead-connection marker for subscription queues. Distinct from b"" —
# an empty payload is a VALID core-NATS message.
_CLOSED = object()


def _server_addr() -> tuple[str, int]:
    url = os.environ.get("NATS_URL", "localhost:4222")
    url = url.removeprefix("nats://")
    host, _, port = url.partition(":")
    return host, int(port or 4222)


class _NatsConn:
    """One socket: handshake, then writer methods + a reader thread that
    routes MSG payloads to per-sid queues and answers PING."""

    def __init__(self):
        host, port = _server_addr()
        self._sock = socket.create_connection((host, port), timeout=10)
        self._sock.settimeout(None)  # reads block on the subscription stream
        self._file = self._sock.makefile("rb")
        info = self._file.readline()
        if not info.startswith(b"INFO "):
            raise ConnectionError(f"not a NATS server: {info[:80]!r}")
        self._wlock = threading.Lock()
        self._send(
            b"CONNECT "
            + json.dumps(
                {"verbose": False, "pedantic": False, "name": "kubeai-tpu"}
            ).encode()
            + b"\r\n"
        )
        self._subs: dict[str, "queue.Queue[bytes]"] = {}
        self._next_sid = 1
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _send(self, data: bytes) -> None:
        with self._wlock:
            self._sock.sendall(data)

    def _read_loop(self) -> None:
        try:
            while True:
                line = self._file.readline()
                if not line:
                    return
                if line.startswith(b"MSG "):
                    parts = line.decode().split()
                    # MSG <subject> <sid> [reply-to] <#bytes>
                    sid, nbytes = parts[2], int(parts[-1])
                    payload = self._file.read(nbytes)
                    self._file.read(2)  # trailing \r\n
                    q = self._subs.get(sid)
                    if q is not None:
                        q.put(payload)
                elif line.startswith(b"PING"):
                    self._send(b"PONG\r\n")
                # +OK / INFO updates / -ERR: -ERR surfaces as a dead conn
                elif line.startswith(b"-ERR"):
                    raise ConnectionError(line.decode().strip())
        except (OSError, ConnectionError):
            if not self._closed:
                for q in self._subs.values():
                    q.put(_CLOSED)  # wake blocked receivers

    def publish(self, subject: str, body: bytes) -> None:
        self._send(b"PUB %s %d\r\n%s\r\n" % (subject.encode(), len(body), body))

    def subscribe(self, subject: str, group: str | None) -> "queue.Queue[bytes]":
        sid = str(self._next_sid)
        self._next_sid += 1
        q: "queue.Queue[bytes]" = queue.Queue()
        self._subs[sid] = q
        g = f" {group}" if group else ""
        self._send(f"SUB {subject}{g} {sid}\r\n".encode())
        return q

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # reader holds a makefile ref
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class NatsTopic(Topic):
    def __init__(self, ref: str):
        self.subject = ref.split("?")[0]
        if not self.subject:
            raise ValueError("nats:// url needs a subject")
        self._conn = _NatsConn()

    def send(self, body: bytes) -> None:
        self._conn.publish(self.subject, body)

    def close(self) -> None:
        self._conn.close()


class NatsSubscription(Subscription):
    def __init__(self, ref: str):
        from urllib.parse import parse_qsl

        subject, _, query = ref.partition("?")
        if not subject:
            raise ValueError("nats:// url needs a subject")
        params = dict(parse_qsl(query))
        self.subject = subject
        self._conn = _NatsConn()
        self._q = self._conn.subscribe(subject, params.get("queue"))

    def receive(self, timeout: float | None = None) -> Message | None:
        try:
            body = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if body is _CLOSED:
            raise ConnectionError("nats connection closed")
        # Core NATS is at-most-once: Ack is a no-op (matches gocloud's
        # natspubsub); Nack re-publishes for a redelivery attempt.
        return Message(
            body, nack=lambda: self._conn.publish(self.subject, body)
        )

    def close(self) -> None:
        self._conn.close()
