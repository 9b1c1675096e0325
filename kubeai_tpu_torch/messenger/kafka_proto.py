"""Kafka wire-protocol codec (the subset the driver needs).

Port of kubeai_tpu/messenger/kafka_proto.py: the JAX package's code,
its imports in this package.

The reference gets Kafka via gocloud.dev's kafkapubsub driver
(ref: internal/manager/run.go:51); no Kafka client library is available
here, so the driver speaks the protocol directly. This module holds the
shared primitives: big-endian ints, STRING/BYTES/ARRAY, varint-zigzag,
CRC32C (Castagnoli), and the magic-2 RecordBatch format — plus the
encode/decode pairs for the six APIs the driver uses, pinned to
versions every post-0.11 broker serves:

    Metadata v1, Produce v3, Fetch v4, FindCoordinator v1,
    OffsetCommit v2, OffsetFetch v3

Layouts follow the public Kafka protocol guide
(kafka.apache.org/protocol). The in-repo fake broker
(tests/kafka_fake.py) decodes with these same helpers; the RecordBatch
codec additionally carries golden-byte tests so a symmetric
encode/decode bug can't hide.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

API_PRODUCE = 0
API_FETCH = 1
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10


# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) -------------------------

_CRC32C_TABLE = []


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        _CRC32C_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- primitive writers/readers ----------------------------------------------


class Writer:
    def __init__(self):
        self._parts: list[bytes] = []

    def raw(self, b: bytes):
        self._parts.append(b)
        return self

    def i8(self, v):
        return self.raw(struct.pack(">b", v))

    def i16(self, v):
        return self.raw(struct.pack(">h", v))

    def i32(self, v):
        return self.raw(struct.pack(">i", v))

    def i64(self, v):
        return self.raw(struct.pack(">q", v))

    def u32(self, v):
        return self.raw(struct.pack(">I", v))

    def string(self, s: str | None):
        if s is None:
            return self.i16(-1)
        b = s.encode()
        return self.i16(len(b)).raw(b)

    def bytes_(self, b: bytes | None):
        if b is None:
            return self.i32(-1)
        return self.i32(len(b)).raw(b)

    def array(self, items, encode_item):
        self.i32(len(items))
        for it in items:
            encode_item(self, it)
        return self

    def varint(self, v: int):
        """Zigzag varint (Kafka record fields)."""
        z = (v << 1) ^ (v >> 63)
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                self.raw(bytes([b | 0x80]))
            else:
                self.raw(bytes([b]))
                return self

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def raw(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError(f"kafka frame truncated at {self.pos}+{n}")
        self.pos += n
        return b

    def i8(self):
        return struct.unpack(">b", self.raw(1))[0]

    def i16(self):
        return struct.unpack(">h", self.raw(2))[0]

    def i32(self):
        return struct.unpack(">i", self.raw(4))[0]

    def i64(self):
        return struct.unpack(">q", self.raw(8))[0]

    def u32(self):
        return struct.unpack(">I", self.raw(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self.raw(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.raw(n)

    def array(self, decode_item) -> list:
        n = self.i32()
        return [decode_item(self) for _ in range(max(n, 0))]

    def varint(self) -> int:
        z = shift = 0
        while True:
            b = self.raw(1)[0]
            z |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        return (z >> 1) ^ -(z & 1)

    def remaining(self) -> int:
        return len(self.data) - self.pos


# -- request/response framing -----------------------------------------------


def encode_request(api_key: int, api_version: int, correlation_id: int, client_id: str, body: bytes) -> bytes:
    w = Writer()
    w.i16(api_key).i16(api_version).i32(correlation_id).string(client_id).raw(body)
    payload = w.build()
    return struct.pack(">i", len(payload)) + payload


def decode_request_header(r: Reader) -> tuple[int, int, int, str | None]:
    return r.i16(), r.i16(), r.i32(), r.string()


def encode_response(correlation_id: int, body: bytes) -> bytes:
    payload = struct.pack(">i", correlation_id) + body
    return struct.pack(">i", len(payload)) + payload


# -- RecordBatch (magic 2) ---------------------------------------------------


def encode_record_batch(base_offset: int, records: list[tuple[bytes | None, bytes]], timestamp_ms: int = 0) -> bytes:
    """records: [(key, value)]."""
    body = Writer()
    body.i16(0)  # attributes: no compression
    body.i32(len(records) - 1)  # lastOffsetDelta
    body.i64(timestamp_ms)  # firstTimestamp
    body.i64(timestamp_ms)  # maxTimestamp
    body.i64(-1)  # producerId
    body.i16(-1)  # producerEpoch
    body.i32(-1)  # baseSequence
    body.i32(len(records))
    for i, (key, value) in enumerate(records):
        rec = Writer()
        rec.i8(0)  # attributes
        rec.varint(0)  # timestampDelta
        rec.varint(i)  # offsetDelta
        if key is None:
            rec.varint(-1)
        else:
            rec.varint(len(key)).raw(key)
        rec.varint(len(value)).raw(value)
        rec.varint(0)  # headers count
        rb = rec.build()
        body.varint(len(rb)).raw(rb)
    body_b = body.build()

    crc = crc32c(body_b)
    head = Writer()
    head.i32(-1)  # partitionLeaderEpoch
    head.i8(2)  # magic
    head.u32(crc)
    inner = head.build() + body_b

    out = Writer()
    out.i64(base_offset)
    out.i32(len(inner))
    out.raw(inner)
    return out.build()


@dataclass
class DecodedRecord:
    offset: int
    key: bytes | None
    value: bytes


def decode_record_batches(data: bytes) -> list[DecodedRecord]:
    """Decode a record_set (possibly several concatenated batches)."""
    out: list[DecodedRecord] = []
    r = Reader(data)
    while r.remaining() >= 12:
        base_offset = r.i64()
        batch_len = r.i32()
        if r.remaining() < batch_len:
            break  # partial batch at the end of a fetch — broker-legal
        batch = Reader(r.raw(batch_len))
        batch.i32()  # partitionLeaderEpoch
        magic = batch.i8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        want_crc = batch.u32()
        body = batch.data[batch.pos :]
        if crc32c(body) != want_crc:
            raise ValueError("record batch crc32c mismatch")
        batch.i16()  # attributes
        batch.i32()  # lastOffsetDelta
        batch.i64()  # firstTimestamp
        batch.i64()  # maxTimestamp
        batch.i64()  # producerId
        batch.i16()  # producerEpoch
        batch.i32()  # baseSequence
        n = batch.i32()
        for _ in range(n):
            rec_len = batch.varint()
            rec = Reader(batch.raw(rec_len))
            rec.i8()  # attributes
            rec.varint()  # timestampDelta
            off_delta = rec.varint()
            klen = rec.varint()
            key = None if klen < 0 else rec.raw(klen)
            vlen = rec.varint()
            value = b"" if vlen < 0 else rec.raw(vlen)
            out.append(DecodedRecord(base_offset + off_delta, key, value))
    return out


# -- API bodies --------------------------------------------------------------
# Encoders build request bodies (client) and response bodies (fake broker);
# decoders are the inverses. Only partition 0 is used by the driver, but the
# codecs are faithful to the general layouts.


@dataclass
class PartitionMeta:
    partition: int
    leader: int
    error: int = 0


@dataclass
class TopicMeta:
    name: str
    partitions: list[PartitionMeta] = field(default_factory=list)
    error: int = 0


@dataclass
class BrokerMeta:
    node_id: int
    host: str
    port: int


def encode_metadata_request_v1(topics: list[str] | None) -> bytes:
    w = Writer()
    if topics is None:
        w.i32(-1)
    else:
        w.array(topics, lambda w2, t: w2.string(t))
    return w.build()


def decode_metadata_request_v1(r: Reader) -> list[str] | None:
    n = r.i32()
    if n < 0:
        return None
    return [r.string() for _ in range(n)]


def encode_metadata_response_v1(brokers: list[BrokerMeta], controller_id: int, topics: list[TopicMeta]) -> bytes:
    w = Writer()
    w.array(brokers, lambda w2, b: (w2.i32(b.node_id), w2.string(b.host), w2.i32(b.port), w2.string(None)))
    w.i32(controller_id)

    def enc_topic(w2: Writer, t: TopicMeta):
        w2.i16(t.error).string(t.name).i8(0)
        w2.array(
            t.partitions,
            lambda w3, p: (
                w3.i16(p.error), w3.i32(p.partition), w3.i32(p.leader),
                w3.array([p.leader], lambda w4, x: w4.i32(x)),
                w3.array([p.leader], lambda w4, x: w4.i32(x)),
            ),
        )

    w.array(topics, enc_topic)
    return w.build()


def decode_metadata_response_v1(r: Reader) -> tuple[list[BrokerMeta], list[TopicMeta]]:
    def dec_broker(r2: Reader) -> BrokerMeta:
        node, host, port = r2.i32(), r2.string(), r2.i32()
        r2.string()  # rack
        return BrokerMeta(node, host, port)

    brokers = r.array(dec_broker)
    r.i32()  # controller id

    def dec_topic(r2: Reader) -> TopicMeta:
        err = r2.i16()
        name = r2.string()
        r2.i8()  # is_internal
        return TopicMeta(name, r2.array(_dec_partition), err)

    topics = r.array(dec_topic)
    return brokers, topics


def _dec_partition(r: Reader) -> PartitionMeta:
    err = r.i16()
    part = r.i32()
    leader = r.i32()
    r.array(lambda r2: r2.i32())  # replicas
    r.array(lambda r2: r2.i32())  # isr
    return PartitionMeta(part, leader, err)


def encode_produce_request_v3(topic: str, partition: int, record_set: bytes, acks: int = -1, timeout_ms: int = 10000) -> bytes:
    w = Writer()
    w.string(None)  # transactional_id
    w.i16(acks).i32(timeout_ms)
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array([partition], lambda w3, p: (w3.i32(p), w3.bytes_(record_set))),
        ),
    )
    return w.build()


def decode_produce_request_v3(r: Reader) -> tuple[str, int, bytes]:
    r.string()  # transactional_id
    r.i16()  # acks
    r.i32()  # timeout
    n_topics = r.i32()
    assert n_topics == 1
    topic = r.string()
    n_parts = r.i32()
    assert n_parts == 1
    partition = r.i32()
    record_set = r.bytes_() or b""
    return topic, partition, record_set


def encode_produce_response_v3(topic: str, partition: int, error: int, base_offset: int) -> bytes:
    w = Writer()
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array(
                [partition],
                lambda w3, p: (w3.i32(p), w3.i16(error), w3.i64(base_offset), w3.i64(-1)),
            ),
        ),
    )
    w.i32(0)  # throttle_time_ms
    return w.build()


def decode_produce_response_v3(r: Reader) -> tuple[int, int]:
    """Returns (error_code, base_offset) for the single partition."""
    n_topics = r.i32()
    assert n_topics == 1
    r.string()
    n_parts = r.i32()
    assert n_parts == 1
    r.i32()  # partition
    error = r.i16()
    base_offset = r.i64()
    r.i64()  # log_append_time
    r.i32()  # throttle
    return error, base_offset


def encode_fetch_request_v4(topic: str, partition: int, offset: int, max_wait_ms: int, max_bytes: int = 4 << 20) -> bytes:
    w = Writer()
    w.i32(-1)  # replica_id
    w.i32(max_wait_ms)
    w.i32(1)  # min_bytes
    w.i32(max_bytes)
    w.i8(0)  # isolation_level
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array(
                [partition],
                lambda w3, p: (w3.i32(p), w3.i64(offset), w3.i32(max_bytes)),
            ),
        ),
    )
    return w.build()


def decode_fetch_request_v4(r: Reader) -> tuple[str, int, int, int]:
    """Returns (topic, partition, offset, max_wait_ms)."""
    r.i32()  # replica_id
    max_wait = r.i32()
    r.i32()  # min_bytes
    r.i32()  # max_bytes
    r.i8()  # isolation
    n_topics = r.i32()
    assert n_topics == 1
    topic = r.string()
    n_parts = r.i32()
    assert n_parts == 1
    partition = r.i32()
    offset = r.i64()
    r.i32()  # partition max_bytes
    return topic, partition, offset, max_wait


def encode_fetch_response_v4(topic: str, partition: int, error: int, high_watermark: int, record_set: bytes) -> bytes:
    w = Writer()
    w.i32(0)  # throttle_time_ms
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array(
                [partition],
                lambda w3, p: (
                    w3.i32(p), w3.i16(error), w3.i64(high_watermark),
                    w3.i64(high_watermark),  # last_stable_offset
                    w3.i32(0),  # aborted_transactions: empty array
                    w3.bytes_(record_set),
                ),
            ),
        ),
    )
    return w.build()


def decode_fetch_response_v4(r: Reader) -> tuple[int, int, bytes]:
    """Returns (error_code, high_watermark, record_set)."""
    r.i32()  # throttle
    n_topics = r.i32()
    if n_topics < 1:
        return 0, 0, b""
    r.string()
    n_parts = r.i32()
    assert n_parts == 1
    r.i32()  # partition
    error = r.i16()
    hw = r.i64()
    r.i64()  # last_stable_offset
    n_aborted = r.i32()
    for _ in range(max(n_aborted, 0)):
        r.i64()
        r.i64()
    record_set = r.bytes_() or b""
    return error, hw, record_set


def encode_find_coordinator_request_v1(key: str, key_type: int = 0) -> bytes:
    return Writer().string(key).i8(key_type).build()


def decode_find_coordinator_request_v1(r: Reader) -> tuple[str, int]:
    return r.string(), r.i8()


def encode_find_coordinator_response_v1(node_id: int, host: str, port: int, error: int = 0) -> bytes:
    w = Writer()
    w.i32(0).i16(error).string(None).i32(node_id).string(host).i32(port)
    return w.build()


def decode_find_coordinator_response_v1(r: Reader) -> tuple[int, str, int]:
    """Returns (node_id, host, port); raises on error."""
    r.i32()  # throttle
    error = r.i16()
    msg = r.string()
    node, host, port = r.i32(), r.string(), r.i32()
    if error:
        raise RuntimeError(f"FindCoordinator error {error}: {msg}")
    return node, host, port


def encode_offset_commit_request_v2(group: str, topic: str, partition: int, offset: int) -> bytes:
    w = Writer()
    w.string(group)
    w.i32(-1)  # generation_id: simple consumer
    w.string("")  # member_id
    w.i64(-1)  # retention_time
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array(
                [partition],
                lambda w3, p: (w3.i32(p), w3.i64(offset), w3.string(None)),
            ),
        ),
    )
    return w.build()


def decode_offset_commit_request_v2(r: Reader) -> tuple[str, str, int, int]:
    """Returns (group, topic, partition, offset)."""
    group = r.string()
    r.i32()  # generation
    r.string()  # member
    r.i64()  # retention
    n_topics = r.i32()
    assert n_topics == 1
    topic = r.string()
    n_parts = r.i32()
    assert n_parts == 1
    partition = r.i32()
    offset = r.i64()
    r.string()  # metadata
    return group, topic, partition, offset


def encode_offset_commit_response_v2(topic: str, partition: int, error: int = 0) -> bytes:
    w = Writer()
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array([partition], lambda w3, p: (w3.i32(p), w3.i16(error))),
        ),
    )
    return w.build()


def decode_offset_commit_response_v2(r: Reader) -> int:
    n_topics = r.i32()
    assert n_topics == 1
    r.string()
    n_parts = r.i32()
    assert n_parts == 1
    r.i32()
    return r.i16()


def encode_offset_fetch_request_v3(group: str, topic: str, partition: int) -> bytes:
    w = Writer()
    w.string(group)
    w.array(
        [topic],
        lambda w2, t: (w2.string(t), w2.array([partition], lambda w3, p: w3.i32(p))),
    )
    return w.build()


def decode_offset_fetch_request_v3(r: Reader) -> tuple[str, str, int]:
    group = r.string()
    n_topics = r.i32()
    assert n_topics == 1
    topic = r.string()
    n_parts = r.i32()
    assert n_parts == 1
    return group, topic, r.i32()


def encode_offset_fetch_response_v3(topic: str, partition: int, offset: int, error: int = 0) -> bytes:
    w = Writer()
    w.i32(0)  # throttle
    w.array(
        [topic],
        lambda w2, t: (
            w2.string(t),
            w2.array(
                [partition],
                lambda w3, p: (w3.i32(p), w3.i64(offset), w3.string(None), w3.i16(error)),
            ),
        ),
    )
    w.i16(0)  # top-level error_code
    return w.build()


def decode_offset_fetch_response_v3(r: Reader) -> int:
    """Returns the committed offset (-1 = none)."""
    r.i32()  # throttle
    n_topics = r.i32()
    if n_topics < 1:
        return -1
    r.string()
    n_parts = r.i32()
    assert n_parts == 1
    r.i32()  # partition
    offset = r.i64()
    r.string()  # metadata
    err = r.i16()
    r.i16()  # top-level error
    if err:
        raise RuntimeError(f"OffsetFetch partition error {err}")
    return offset
