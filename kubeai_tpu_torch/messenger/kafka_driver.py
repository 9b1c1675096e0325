"""kafka:// pub/sub driver over the wire protocol (no client library).

Port of kubeai_tpu/messenger/kafka_driver.py: the JAX package's code,
its imports in this package.

URL shapes follow gocloud's kafkapubsub driver (ref:
internal/manager/run.go:51):

    topic:        kafka://TOPIC
    subscription: kafka://GROUP?topic=TOPIC

Brokers come from $KAFKA_BROKERS (comma-separated host:port). The
driver pins one partition (0) per topic — the messenger tier is a
request queue, not a firehose; scale-out is replica-count on the
consuming side, matching the reference's semantics of competing
consumers in one group.

Semantics:
- publish: Produce acks=-1 to partition 0's leader.
- receive: Fetch from the next offset (resuming from the group's
  committed offset via OffsetFetch at open).
- ack: offsets commit only as a contiguous prefix (classic watermark):
  an unacked or nacked message blocks the commit watermark, so a crash
  redelivers it — at-least-once.
- nack: the offset is queued for local redelivery AND stays uncommitted.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from collections import deque

from kubeai_tpu_torch.messenger import kafka_proto as kp
from kubeai_tpu_torch.messenger.drivers import Message, Subscription, Topic


def _brokers() -> list[tuple[str, int]]:
    raw = os.environ.get("KAFKA_BROKERS", "localhost:9092")
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host or "localhost", int(port)))
    if not out:
        raise ValueError("KAFKA_BROKERS is empty")
    return out


class _Conn:
    """One blocking connection: sequential request/response correlation."""

    def __init__(self, host: str, port: int, client_id: str, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def call(self, api_key: int, api_version: int, body: bytes, timeout: float | None = None) -> kp.Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            if timeout is not None:
                self.sock.settimeout(timeout)
            self.sock.sendall(
                kp.encode_request(api_key, api_version, corr, self.client_id, body)
            )
            size = struct.unpack(">i", self._read_n(4))[0]
            payload = self._read_n(size)
        r = kp.Reader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            raise RuntimeError(f"kafka correlation mismatch: {got_corr} != {corr}")
        return r

    def _read_n(self, n: int) -> bytes:
        chunks = []
        while n:
            c = self.sock.recv(n)
            if not c:
                raise ConnectionError("kafka connection closed")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _leader_conn(topic: str, client_id: str) -> "_Conn":
    """Connect to any bootstrap broker, locate partition 0's leader via
    Metadata, and return a connection to it."""
    last_err: Exception | None = None
    for host, port in _brokers():
        try:
            conn = _Conn(host, port, client_id)
        except OSError as e:
            last_err = e
            continue
        try:
            r = conn.call(kp.API_METADATA, 1, kp.encode_metadata_request_v1([topic]))
            brokers, topics = kp.decode_metadata_response_v1(r)
            by_id = {b.node_id: b for b in brokers}
            for t in topics:
                if t.name != topic:
                    continue
                for p in t.partitions:
                    if p.partition == 0 and p.leader in by_id:
                        leader = by_id[p.leader]
                        if (leader.host, leader.port) == (host, port):
                            return conn
                        conn.close()
                        return _Conn(leader.host, leader.port, client_id)
            # Topic unknown to this broker (auto-create may kick in on
            # first produce/fetch): just use this broker.
            return conn
        except Exception as e:
            conn.close()
            last_err = e
    raise ConnectionError(f"no reachable kafka broker: {last_err}")


class KafkaTopic(Topic):
    def __init__(self, topic: str):
        self.topic = topic
        self._conn: _Conn | None = None

    def send(self, body: bytes) -> None:
        if self._conn is None:
            self._conn = _leader_conn(self.topic, "kubeai-producer")
        record_set = kp.encode_record_batch(
            0, [(None, body)], timestamp_ms=int(time.time() * 1000)
        )
        try:
            r = self._conn.call(
                kp.API_PRODUCE, 3,
                kp.encode_produce_request_v3(self.topic, 0, record_set),
            )
        except (OSError, ConnectionError):
            # One reconnect attempt (leader moved / idle disconnect).
            self._conn.close()
            self._conn = _leader_conn(self.topic, "kubeai-producer")
            r = self._conn.call(
                kp.API_PRODUCE, 3,
                kp.encode_produce_request_v3(self.topic, 0, record_set),
            )
        error, _ = kp.decode_produce_response_v3(r)
        if error:
            raise RuntimeError(f"kafka produce error code {error}")

    def close(self) -> None:
        if self._conn:
            self._conn.close()


class KafkaSubscription(Subscription):
    def __init__(self, ref: str):
        # GROUP?topic=TOPIC
        from urllib.parse import parse_qs

        group, _, query = ref.partition("?")
        topic = (parse_qs(query).get("topic") or [""])[0]
        if not group or not topic:
            raise ValueError(
                f"kafka subscription needs kafka://GROUP?topic=TOPIC, got {ref!r}"
            )
        self.group = group
        self.topic = topic
        self._conn: _Conn | None = None
        self._coord: _Conn | None = None
        self._buffer: deque[kp.DecodedRecord] = deque()
        self._redeliver: deque[int] = deque()
        self._next_offset = 0  # next offset to fetch
        self._commit_next = 0  # watermark: everything below is committed
        self._acked: set[int] = set()
        self._lock = threading.Lock()

    # -- connections -------------------------------------------------------

    def _ensure(self):
        if self._conn is None:
            self._conn = _leader_conn(self.topic, f"kubeai-consumer-{self.group}")
            self._coord = self._find_coordinator()
            committed = kp.decode_offset_fetch_response_v3(
                self._coord.call(
                    kp.API_OFFSET_FETCH, 3,
                    kp.encode_offset_fetch_request_v3(self.group, self.topic, 0),
                )
            )
            self._next_offset = self._commit_next = max(committed, 0)
            self._acked.clear()

    def _find_coordinator(self) -> _Conn:
        r = self._conn.call(
            kp.API_FIND_COORDINATOR, 1,
            kp.encode_find_coordinator_request_v1(self.group),
        )
        _, host, port = kp.decode_find_coordinator_response_v1(r)
        sock_host, sock_port = self._conn.sock.getpeername()[:2]
        if (host, port) == (sock_host, sock_port):
            return self._conn
        return _Conn(host, port, f"kubeai-consumer-{self.group}")

    def _reset(self):
        for c in (self._conn, self._coord):
            if c is not None:
                c.close()
        self._conn = self._coord = None
        self._buffer.clear()

    # -- receive/ack/nack --------------------------------------------------

    def receive(self, timeout: float | None = None) -> Message | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            self._ensure()
            rec = self._next_record(deadline)
        except Exception:
            self._reset()
            raise
        if rec is None:
            return None
        off = rec.offset
        return Message(
            rec.value,
            ack=lambda: self._ack(off),
            nack=lambda: self._nack(off),
        )

    def _next_record(self, deadline: float | None) -> kp.DecodedRecord | None:
        with self._lock:
            redeliver = self._redeliver.popleft() if self._redeliver else None
        if redeliver is not None:
            recs = self._fetch(redeliver, wait_ms=500)
            for rec in recs:
                if rec.offset == redeliver:
                    return rec
            # Not found (compacted/expired): skip it in the watermark.
            self._ack(redeliver)

        while True:
            if self._buffer:
                return self._buffer.popleft()
            wait_ms = 200
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                wait_ms = max(int(remaining * 1000), 1)
            recs = [r for r in self._fetch(self._next_offset, wait_ms) if r.offset >= self._next_offset]
            if not recs:
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue
            self._next_offset = recs[-1].offset + 1
            self._buffer.extend(recs)

    def _fetch(self, offset: int, wait_ms: int) -> list[kp.DecodedRecord]:
        r = self._conn.call(
            kp.API_FETCH, 4,
            kp.encode_fetch_request_v4(self.topic, 0, offset, wait_ms),
            timeout=wait_ms / 1000 + 10,
        )
        error, _, record_set = kp.decode_fetch_response_v4(r)
        if error:
            raise RuntimeError(f"kafka fetch error code {error}")
        return kp.decode_record_batches(record_set)

    def _ack(self, offset: int) -> None:
        with self._lock:
            self._acked.add(offset)
            advanced = False
            while self._commit_next in self._acked:
                self._acked.discard(self._commit_next)
                self._commit_next += 1
                advanced = True
            commit_to = self._commit_next
        if advanced and self._coord is not None:
            try:
                err = kp.decode_offset_commit_response_v2(
                    self._coord.call(
                        kp.API_OFFSET_COMMIT, 2,
                        kp.encode_offset_commit_request_v2(
                            self.group, self.topic, 0, commit_to
                        ),
                    )
                )
                if err:
                    raise RuntimeError(f"kafka offset commit error code {err}")
            except Exception:
                # Commit failure is not message loss: the watermark
                # persists locally and recommits on the next ack; a crash
                # merely redelivers (at-least-once).
                pass

    def _nack(self, offset: int) -> None:
        with self._lock:
            self._redeliver.append(offset)

    def close(self) -> None:
        self._reset()
