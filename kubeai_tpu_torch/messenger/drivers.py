"""Pub/sub drivers behind one Topic/Subscription interface.

Port of kubeai_tpu/messenger/drivers.py: the JAX package's code,
its imports in this package.

The reference rides gocloud.dev with AWS SNS/SQS, Azure SB, GCP Pub/Sub,
Kafka, NATS, RabbitMQ drivers (ref: internal/manager/run.go:47-53,
internal/messenger/messenger.go). Here the interface is the same shape
with two built-in drivers:

    mem://<name>    in-process queues (tests/dev; parity with the
                    reference integration tests' mem:// driver)
    file://<dir>    spool-directory queues (cross-process on one host)

Cloud drivers ship in-repo and load lazily on first use of their
scheme (keeping them out of the core's import path):

    gcppubsub://projects/P/{topics/T,subscriptions/S}   (gcp_pubsub.py)
    kafka://TOPIC  /  kafka://GROUP?topic=TOPIC          (kafka_driver.py)
    awssqs://sqs.REGION.amazonaws.com/ACCT/QUEUE         (sqs_driver.py)
    nats://SUBJECT  /  nats://SUBJECT?queue=GROUP        (nats_driver.py)
    rabbit://QUEUE                                       (amqp_driver.py)
    azuresb://QUEUE                                      (azuresb_driver.py)

— the reference's full six-bus matrix. Additional schemes register via
`register_driver`.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from urllib.parse import urlparse


class Message:
    def __init__(self, body: bytes, ack=None, nack=None):
        self.body = body
        self._ack = ack or (lambda: None)
        self._nack = nack or (lambda: None)

    def ack(self):
        self._ack()

    def nack(self):
        self._nack()


class Topic:
    def send(self, body: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Subscription:
    def receive(self, timeout: float | None = None) -> Message | None:
        raise NotImplementedError

    def close(self) -> None:
        pass


# -- mem:// -----------------------------------------------------------------

_mem_lock = threading.Lock()
_mem_queues: dict[str, "queue.Queue[bytes]"] = {}


def _mem_queue(name: str) -> "queue.Queue[bytes]":
    with _mem_lock:
        q = _mem_queues.get(name)
        if q is None:
            q = queue.Queue()
            _mem_queues[name] = q
        return q


class MemTopic(Topic):
    def __init__(self, name: str):
        self._q = _mem_queue(name)

    def send(self, body: bytes) -> None:
        self._q.put(body)


class MemSubscription(Subscription):
    def __init__(self, name: str):
        self._q = _mem_queue(name)

    def receive(self, timeout: float | None = None) -> Message | None:
        try:
            body = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        # Nack re-queues (at-least-once semantics).
        return Message(body, nack=lambda: self._q.put(body))


# -- file:// ----------------------------------------------------------------


class FileTopic(Topic):
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def send(self, body: bytes) -> None:
        name = f"{time.time_ns():020d}-{uuid.uuid4().hex[:8]}"
        tmp = os.path.join(self.dir, f".tmp-{name}")
        with open(tmp, "wb") as f:
            f.write(body)
        os.rename(tmp, os.path.join(self.dir, name + ".msg"))


class FileSubscription(Subscription):
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def receive(self, timeout: float | None = None) -> Message | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            for name in sorted(os.listdir(self.dir)):
                if not name.endswith(".msg"):
                    continue
                path = os.path.join(self.dir, name)
                claimed = path + ".claimed"
                try:
                    os.rename(path, claimed)  # atomic claim
                except OSError:
                    continue
                with open(claimed, "rb") as f:
                    body = f.read()

                def ack(p=claimed):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

                def nack(p=claimed, orig=path):
                    try:
                        os.rename(p, orig)
                    except OSError:
                        pass

                return Message(body, ack=ack, nack=nack)
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.05)


# -- registry ---------------------------------------------------------------

_DRIVERS: dict[str, tuple] = {}


def register_driver(scheme: str, topic_factory, subscription_factory):
    _DRIVERS[scheme] = (topic_factory, subscription_factory)


register_driver("mem", lambda ref: MemTopic(ref), lambda ref: MemSubscription(ref))
register_driver("file", lambda ref: FileTopic(ref), lambda ref: FileSubscription(ref))


def _split(url: str) -> tuple[str, str]:
    parsed = urlparse(url)
    if not parsed.scheme:
        raise ValueError(f"pubsub url missing scheme: {url!r}")
    if parsed.scheme == "file":
        # file://spool/q -> relative "spool/q"; file:///var/q -> "/var/q".
        ref = (parsed.netloc + parsed.path) if parsed.netloc else parsed.path
        if not ref:
            raise ValueError(f"file:// pubsub url needs a directory: {url!r}")
        return "file", ref
    ref = (parsed.netloc + parsed.path).rstrip("/")
    if parsed.query:
        # kafka://GROUP?topic=T carries the topic in the query string.
        ref = f"{ref}?{parsed.query}"
    return parsed.scheme, ref


def _load_cloud_driver(scheme: str) -> None:
    """Lazy registration of the in-repo cloud drivers."""
    if scheme == "gcppubsub":
        from kubeai_tpu_torch.messenger.gcp_pubsub import (
            GcpPubSubSubscription,
            GcpPubSubTopic,
        )

        register_driver("gcppubsub", GcpPubSubTopic, GcpPubSubSubscription)
    elif scheme == "kafka":
        from kubeai_tpu_torch.messenger.kafka_driver import KafkaSubscription, KafkaTopic

        register_driver("kafka", KafkaTopic, KafkaSubscription)
    elif scheme == "awssqs":
        from kubeai_tpu_torch.messenger.sqs_driver import SqsSubscription, SqsTopic

        register_driver("awssqs", SqsTopic, SqsSubscription)
    elif scheme == "nats":
        from kubeai_tpu_torch.messenger.nats_driver import NatsSubscription, NatsTopic

        register_driver("nats", NatsTopic, NatsSubscription)
    elif scheme == "rabbit":
        from kubeai_tpu_torch.messenger.amqp_driver import AmqpSubscription, AmqpTopic

        register_driver("rabbit", AmqpTopic, AmqpSubscription)
    elif scheme == "azuresb":
        from kubeai_tpu_torch.messenger.azuresb_driver import (
            AzureSbSubscription,
            AzureSbTopic,
        )

        register_driver("azuresb", AzureSbTopic, AzureSbSubscription)


def _driver(scheme: str) -> tuple:
    if scheme not in _DRIVERS:
        _load_cloud_driver(scheme)
    if scheme not in _DRIVERS:
        raise ValueError(f"no pubsub driver for scheme {scheme!r}")
    return _DRIVERS[scheme]


def open_topic(url: str) -> Topic:
    scheme, ref = _split(url)
    return _driver(scheme)[0](ref)


def open_subscription(url: str) -> Subscription:
    scheme, ref = _split(url)
    return _driver(scheme)[1](ref)
