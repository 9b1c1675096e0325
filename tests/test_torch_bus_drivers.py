"""The port's SQS, NATS, RabbitMQ and Azure Service Bus drivers
(kubeai_tpu_torch/messenger/{sqs,nats,amqp,azuresb}_driver.py) against
the in-repo fake brokers (tests/bus_fakes.py), beside the JAX package's,
on the CPU. tests/test_torch_cloud_drivers.py holds Kafka and Pub/Sub
alike.

- The cases of tests/test_bus_drivers.py run on the port (their clone:
  the same fakes, inputs and assertions): round-trip, nack redelivery,
  expiry redelivery after a lost consumer, send errors, SigV4 and SAS
  signing, AMQP bodies split into frames, and the full pipeline over each
  bus with the port's Messenger.
- On each bus a message published by the JAX driver is received by the
  port's, and the reverse, byte for byte.
"""

import time

import pytest

import test_bus_drivers as jtest_bus_drivers
from _torch_operator import jax_cases, port_clone, run_jax_case, to_port
# The JAX tests' fixtures (each starts one fake broker and points the
# driver's environment at it); the pipeline cases ask for them by name.
from test_bus_drivers import SQS_URL, azuresb, nats, rabbit, sqs  # noqa: F401

from kubeai_tpu.messenger import drivers as jdrivers
from kubeai_tpu_torch.messenger import drivers as tdrivers


@pytest.mark.parametrize("module,qual,params", jax_cases(jtest_bus_drivers))
def test_jax_bus_cases_on_the_port(module, qual, params, request, monkeypatch):
    run_jax_case(port_clone(module), qual, to_port(params), (), request, monkeypatch)


# bus: (the topic's URL, the subscription's URL)
BUSES = {
    "sqs": (SQS_URL, SQS_URL),
    "nats": ("nats://cross", "nats://cross"),
    "rabbit": ("rabbit://cross", "rabbit://cross"),
    "azuresb": ("azuresb://cross", "azuresb://cross"),
}
# Every byte value, larger than the AMQP fake's 4 KiB frame_max; and
# plain text (SQS sends it raw, binary as base64).
BODIES = [bytes(range(256)) * 24, b'{"path": "/v1/completions", "body": {}}']


@pytest.mark.parametrize("writer,reader", [(jdrivers, tdrivers), (tdrivers, jdrivers)],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("bus", list(BUSES))
def test_message_crosses_packages(bus, writer, reader, request):
    request.getfixturevalue(bus)
    topic_url, sub_url = BUSES[bus]
    # NATS delivers only to live subscriptions: subscribe first.
    sub = reader.open_subscription(sub_url)
    topic = writer.open_topic(topic_url)
    try:
        if bus == "nats":
            time.sleep(0.1)  # the SUB's registration races the PUB
        for body in BODIES:
            topic.send(body)
        got = []
        for _ in BODIES:
            m = sub.receive(timeout=5)
            assert m is not None, f"{bus}: a message was not delivered"
            got.append(m.body)
            m.ack()
        assert sorted(got) == sorted(BODIES)
    finally:
        sub.close()
        topic.close()
