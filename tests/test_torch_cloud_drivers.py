"""The port's Kafka and Pub/Sub drivers (kubeai_tpu_torch/messenger/
kafka_driver.py, gcp_pubsub.py) against the in-repo fakes
(tests/kafka_fake.py, tests/pubsub_fake.py), beside the JAX package's, on
the CPU.

- The driver cases of tests/test_cloud_drivers.py run on the port (their
  clone: the same fakes, inputs and assertions): round-trip and commit,
  nack redelivery, redelivery of unacked records to a restarted consumer,
  ack-deadline expiry, publish errors, URL refusals, and the full
  pipeline over each bus with the port's Messenger. The Kafka fake
  decodes through the JAX package's kafka_proto, so the port's Kafka
  driver is held to the JAX codec on the wire.
- On each bus a message published by the JAX driver is received by the
  port's, and the reverse, byte for byte.
"""

import pytest

import test_cloud_drivers as jtest_cloud_drivers
from _torch_operator import jax_cases, port_clone, run_jax_case, to_port
# The JAX tests' fixtures (each starts one fake and points the driver's
# environment at it); the pipeline cases ask for them by name.
from test_cloud_drivers import kafka, pubsub  # noqa: F401

from kubeai_tpu.messenger import drivers as jdrivers
from kubeai_tpu_torch.messenger import drivers as tdrivers

# Held by tests/test_torch_messenger.py with the rest of kafka_proto.
CODEC_CASES = ("test_request_header_golden_bytes", "test_record_batch_golden_header_and_roundtrip",
               "test_record_batch_crc_detects_corruption", "test_varint_zigzag_roundtrip")


@pytest.mark.parametrize(
    "module,qual,params",
    [c for c in jax_cases(jtest_cloud_drivers) if c.values[1] not in CODEC_CASES])
def test_jax_cloud_cases_on_the_port(module, qual, params, request, monkeypatch):
    run_jax_case(port_clone(module), qual, to_port(params), (), request, monkeypatch)


# bus: (the topic's URL, the subscription's URL)
BUSES = {
    "kafka": ("kafka://cross", "kafka://g-cross?topic=cross"),
    "pubsub": ("gcppubsub://projects/p/topics/reqs", "gcppubsub://projects/p/subscriptions/reqs"),
}
# Every byte value (Pub/Sub sends base64), and a plain envelope.
BODIES = [bytes(range(256)) * 24, b'{"path": "/v1/completions", "body": {}}']


@pytest.mark.parametrize("writer,reader", [(jdrivers, tdrivers), (tdrivers, jdrivers)],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("bus", list(BUSES))
def test_message_crosses_packages(bus, writer, reader, request):
    request.getfixturevalue(bus)
    topic_url, sub_url = BUSES[bus]
    sub = reader.open_subscription(sub_url)
    topic = writer.open_topic(topic_url)
    try:
        for body in BODIES:
            topic.send(body)
        got = []
        for _ in BODIES:
            m = sub.receive(timeout=5)
            assert m is not None, f"{bus}: a message was not delivered"
            got.append(m.body)
            m.ack()
        assert got == BODIES
    finally:
        sub.close()
        topic.close()
