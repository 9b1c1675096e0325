"""RabbitMQ pub/sub driver — from-scratch AMQP 0-9-1 wire client.

Port of kubeai_tpu/messenger/amqp_driver.py: the JAX package's code,
its imports in this package.

The reference rides gocloud.dev's rabbitpubsub driver
(ref: internal/manager/run.go:47-53). Here the protocol subset the
messenger actually needs is spoken directly (public AMQP 0-9-1 spec;
constants below are the published class/method ids):

    handshake   Connection.Start/StartOk(PLAIN)/Tune/TuneOk/Open/OpenOk
    channel     Channel.Open/OpenOk
    topology    Queue.Declare/DeclareOk (durable)
    produce     Basic.Publish + content header + body frames
    consume     Basic.Consume/ConsumeOk + Basic.Deliver stream
    ack/nack    Basic.Ack / Basic.Nack(requeue=1)  → at-least-once

Frames are `type u8 | channel u16 | size u32 | payload | 0xCE`.

URL form:  rabbit://QUEUE   (both topic and subscription; the default
           exchange routes by queue name, matching gocloud's model of
           one queue per subscription)
Env:       RABBIT_URL  host:port (default localhost:5672)
           RABBIT_USER / RABBIT_PASSWORD (default guest/guest)
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading

from kubeai_tpu_torch.messenger.drivers import Message, Subscription, Topic

FRAME_METHOD, FRAME_HEADER, FRAME_BODY, FRAME_HEARTBEAT = 1, 2, 3, 8
FRAME_END = 0xCE

CONNECTION, CHANNEL, QUEUE, BASIC = 10, 20, 50, 60
CONN_START, CONN_START_OK, CONN_TUNE, CONN_TUNE_OK = 10, 11, 30, 31
CONN_OPEN, CONN_OPEN_OK, CONN_CLOSE, CONN_CLOSE_OK = 40, 41, 50, 51
CH_OPEN, CH_OPEN_OK = 10, 11
Q_DECLARE, Q_DECLARE_OK = 10, 11
B_CONSUME, B_CONSUME_OK, B_PUBLISH, B_DELIVER = 20, 21, 40, 60
B_ACK, B_NACK = 80, 120


class Writer:
    def __init__(self):
        self._parts: list[bytes] = []

    def u8(self, v):
        self._parts.append(struct.pack(">B", v))
        return self

    def u16(self, v):
        self._parts.append(struct.pack(">H", v))
        return self

    def u32(self, v):
        self._parts.append(struct.pack(">I", v))
        return self

    def u64(self, v):
        self._parts.append(struct.pack(">Q", v))
        return self

    def shortstr(self, s: str):
        b = s.encode()
        if len(b) > 255:
            raise ValueError("shortstr too long")
        return self.u8(len(b)).raw(b)

    def longstr(self, b: bytes):
        return self.u32(len(b)).raw(b)

    def table(self, items: dict | None = None):
        # Empty / flat string tables only — all this subset needs.
        w = Writer()
        for k, v in (items or {}).items():
            w.shortstr(k)
            w.raw(b"S")
            w.longstr(str(v).encode())
        return self.longstr(w.build())

    def raw(self, b: bytes):
        self._parts.append(b)
        return self

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._o = 0

    def u8(self):
        (v,) = struct.unpack_from(">B", self._d, self._o)
        self._o += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from(">H", self._d, self._o)
        self._o += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from(">I", self._d, self._o)
        self._o += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from(">Q", self._d, self._o)
        self._o += 8
        return v

    def shortstr(self) -> str:
        n = self.u8()
        v = self._d[self._o : self._o + n]
        self._o += n
        return v.decode()

    def longstr(self) -> bytes:
        n = self.u32()
        v = self._d[self._o : self._o + n]
        self._o += n
        return v

    def table(self) -> bytes:
        return self.longstr()  # opaque; subset never reads entries


def write_frame(sock: socket.socket, ftype: int, channel: int, payload: bytes) -> None:
    sock.sendall(
        struct.pack(">BHI", ftype, channel, len(payload)) + payload + bytes([FRAME_END])
    )


def read_frame(f) -> tuple[int, int, bytes]:
    head = f.read(7)
    if len(head) < 7:
        raise ConnectionError("amqp stream closed")
    ftype, channel, size = struct.unpack(">BHI", head)
    payload = f.read(size)
    if f.read(1) != bytes([FRAME_END]):
        raise ConnectionError("bad AMQP frame end")
    return ftype, channel, payload


def method(cls: int, mth: int) -> Writer:
    return Writer().u16(cls).u16(mth)


class _AmqpConn:
    """One connection + one channel, queue declared; deliveries routed to
    an internal queue by a reader thread."""

    def __init__(self, qname: str, consume: bool):
        self.qname = qname
        url = os.environ.get("RABBIT_URL", "localhost:5672").removeprefix("amqp://")
        host, _, port = url.partition(":")
        self._sock = socket.create_connection((host, int(port or 5672)), timeout=10)
        # The connect timeout must not govern reads: consumers idle on
        # the delivery stream for arbitrarily long.
        self._sock.settimeout(None)
        self._file = self._sock.makefile("rb")
        self._wlock = threading.Lock()
        self._deliveries: "queue.Queue[tuple[int, bytes]]" = queue.Queue()
        self._closed = False

        self._sock.sendall(b"AMQP\x00\x00\x09\x01")
        self._expect(CONNECTION, CONN_START)
        user = os.environ.get("RABBIT_USER", "guest")
        pw = os.environ.get("RABBIT_PASSWORD", "guest")
        self._send_method(
            0,
            method(CONNECTION, CONN_START_OK)
            .table({})
            .shortstr("PLAIN")
            .longstr(b"\x00" + user.encode() + b"\x00" + pw.encode())
            .shortstr("en_US"),
        )
        tune = self._expect(CONNECTION, CONN_TUNE)
        tune.u16()  # channel-max
        server_frame_max = tune.u32()
        # Negotiate down from the server's proposal (0 = unlimited per
        # spec §1.4.2.6; cap at our default). TuneOk must echo a value
        # the server allows — and publish() must then respect it.
        self._frame_max = min(server_frame_max or 131072, 131072)
        self._send_method(
            0, method(CONNECTION, CONN_TUNE_OK).u16(0).u32(self._frame_max).u16(0)
        )
        self._send_method(
            0, method(CONNECTION, CONN_OPEN).shortstr("/").shortstr("").u8(0)
        )
        self._expect(CONNECTION, CONN_OPEN_OK)
        self._send_method(1, method(CHANNEL, CH_OPEN).shortstr(""))
        self._expect(CHANNEL, CH_OPEN_OK)
        # durable=1, other bits 0.
        self._send_method(
            1, method(QUEUE, Q_DECLARE).u16(0).shortstr(qname).u8(0b00010).table({})
        )
        self._expect(QUEUE, Q_DECLARE_OK)
        if consume:
            self._send_method(
                1,
                method(BASIC, B_CONSUME).u16(0).shortstr(qname).shortstr("")
                .u8(0)  # no-local=0, no-ack=0 (explicit acks), bits packed
                .table({}),
            )
            self._expect(BASIC, B_CONSUME_OK)
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _send_method(self, channel: int, w: Writer) -> None:
        with self._wlock:
            write_frame(self._sock, FRAME_METHOD, channel, w.build())

    def _expect(self, cls: int, mth: int) -> Reader:
        while True:
            ftype, _, payload = read_frame(self._file)
            if ftype == FRAME_HEARTBEAT:
                continue
            if ftype != FRAME_METHOD:
                raise ConnectionError(f"expected method frame, got type {ftype}")
            r = Reader(payload)
            got_cls, got_mth = r.u16(), r.u16()
            if (got_cls, got_mth) != (cls, mth):
                raise ConnectionError(
                    f"expected method {cls}.{mth}, got {got_cls}.{got_mth}"
                )
            return r

    def _read_loop(self) -> None:
        try:
            while True:
                ftype, _, payload = read_frame(self._file)
                if ftype == FRAME_HEARTBEAT:
                    with self._wlock:
                        write_frame(self._sock, FRAME_HEARTBEAT, 0, b"")
                    continue
                if ftype != FRAME_METHOD:
                    continue
                r = Reader(payload)
                cls, mth = r.u16(), r.u16()
                if (cls, mth) == (BASIC, B_DELIVER):
                    r.shortstr()  # consumer tag
                    tag = r.u64()
                    r.u8()  # redelivered
                    r.shortstr()  # exchange
                    r.shortstr()  # routing key
                    _, _, hdr = read_frame(self._file)
                    hr = Reader(hdr)
                    hr.u16()  # class
                    hr.u16()  # weight
                    size = hr.u64()
                    body = b""
                    while len(body) < size:
                        _, _, chunk = read_frame(self._file)
                        body += chunk
                    self._deliveries.put((tag, body))
                elif (cls, mth) == (CONNECTION, CONN_CLOSE):
                    self._send_method(0, method(CONNECTION, CONN_CLOSE_OK))
                    return
        except (OSError, ConnectionError):
            if not self._closed:
                self._deliveries.put((-1, b""))  # closed marker

    def publish(self, body: bytes) -> None:
        # Default exchange "" routes by queue name. ALL frames under one
        # lock hold: the messenger publishes responses from concurrent
        # handler threads, and an interleaved method frame mid-content is
        # an AMQP protocol violation (UNEXPECTED_FRAME connection close).
        # Bodies are split into BODY frames of at most frame_max-8 bytes
        # (7-byte frame header + frame-end octet): one oversized frame —
        # e.g. a large completion or embedding-response JSON — is itself
        # a framing violation the broker answers by closing the
        # connection (advisor r3; the read side already reassembles
        # multi-frame bodies).
        chunk_max = self._frame_max - 8
        with self._wlock:
            write_frame(
                self._sock, FRAME_METHOD, 1,
                method(BASIC, B_PUBLISH).u16(0).shortstr("").shortstr(self.qname).u8(0).build(),
            )
            write_frame(
                self._sock, FRAME_HEADER, 1,
                Writer().u16(BASIC).u16(0).u64(len(body)).u16(0).build(),
            )
            for off in range(0, len(body), chunk_max):
                write_frame(self._sock, FRAME_BODY, 1, body[off : off + chunk_max])

    def ack(self, tag: int) -> None:
        self._send_method(1, method(BASIC, B_ACK).u64(tag).u8(0))

    def nack(self, tag: int) -> None:
        # requeue=1 (bit 1 of the packed bits after `multiple`).
        self._send_method(1, method(BASIC, B_NACK).u64(tag).u8(0b10))

    def close(self) -> None:
        self._closed = True
        try:
            # shutdown() actually terminates the TCP stream: the reader
            # thread's makefile handle keeps the fd refcounted, so a bare
            # close() would leave the connection (and the broker's view
            # of our unacked deliveries) alive indefinitely.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class AmqpTopic(Topic):
    def __init__(self, ref: str):
        if not ref:
            raise ValueError("rabbit:// url needs a queue name")
        self._conn = _AmqpConn(ref, consume=False)

    def send(self, body: bytes) -> None:
        self._conn.publish(body)

    def close(self) -> None:
        self._conn.close()


class AmqpSubscription(Subscription):
    def __init__(self, ref: str):
        if not ref:
            raise ValueError("rabbit:// url needs a queue name")
        self._conn = _AmqpConn(ref, consume=True)

    def receive(self, timeout: float | None = None) -> Message | None:
        try:
            tag, body = self._conn._deliveries.get(timeout=timeout)
        except queue.Empty:
            return None
        if tag < 0:
            raise ConnectionError("amqp connection closed")
        return Message(
            body,
            ack=lambda: self._conn.ack(tag),
            nack=lambda: self._conn.nack(tag),
        )

    def close(self) -> None:
        self._conn.close()
