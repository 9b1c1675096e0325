"""The port's messenger (kubeai_tpu_torch/messenger/messenger.py,
drivers.py, kafka_proto.py) against the JAX package's, on the CPU.

- The same envelopes go into the JAX Messenger and the port's, each over
  its own package's mem:// queues, with one fake model client and load
  balancer per package over one shared echo backend: the response
  envelopes (generated request ids apart), the ack/nack sequences, the
  scale-from-zero calls and the active gauge (1 while the request is
  handled, 0 after) must be equal.
- The cases of tests/test_messenger.py and the Kafka codec cases of
  tests/test_cloud_drivers.py run on the port (their clone: the same
  inputs and assertions).
- file:// spools written by one package are claimed, nacked and acked by
  the other; ``_split`` reads a table of URLs alike.
- Hypothesis-generated Kafka record batches and requests encode to the
  same bytes in both packages, and each decodes the other's; CRC32C
  agrees.
- ``load_system_config`` of YAML with ``messaging.streams`` gives both
  packages' Managers the same messengers.
"""

import importlib
import json
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import test_cloud_drivers as jtest_cloud_drivers
import test_messenger as jtest_messenger
from _torch_operator import jax_cases, obs_dirs, port_clone, run_jax_case, to_port  # noqa: F401

from kubeai_tpu.messenger import drivers as jdrivers
from kubeai_tpu.messenger import kafka_proto as jkp
from kubeai_tpu_torch.messenger import drivers as tdrivers
from kubeai_tpu_torch.messenger import kafka_proto as tkp


@pytest.fixture(autouse=True)
def no_canary(monkeypatch):
    # A Manager's canary probes would land in the windows these tests
    # count requests and launches in: off, as before the port had one.
    monkeypatch.setenv("KUBEAI_CANARY", "0")

PACKAGES = ("kubeai_tpu", "kubeai_tpu_torch")
CODEC_CASES = ("test_request_header_golden_bytes", "test_record_batch_golden_header_and_roundtrip",
               "test_record_batch_crc_detects_corruption", "test_varint_zigzag_roundtrip")


@pytest.mark.parametrize(
    "module,qual,params",
    jax_cases(jtest_messenger)
    + [c for c in jax_cases(jtest_cloud_drivers) if c.values[1] in CODEC_CASES])
def test_jax_cases_on_the_port(module, qual, params, request, monkeypatch):
    run_jax_case(port_clone(module), qual, to_port(params), (), request, monkeypatch)


# -- the same envelopes through both packages' Messengers --------------------


@pytest.fixture(scope="module")
def echo():
    """The shared backend: echoes the prompt, the model and X-Request-ID;
    the prompt "boom" answers 500."""

    class Echo(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n))
            code = 500 if body.get("prompt") == "boom" else 200
            payload = json.dumps({"echo": body.get("prompt"), "model": body.get("model"),
                                  "path": self.path,
                                  "rid": self.headers.get("X-Request-ID")}).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    httpd.server_close()


def _closed_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def _env(path="/v1/completions", model="m", prompt="hello", **meta):
    return json.dumps({"metadata": {"corr": "c1", **meta}, "path": path,
                       "body": {"model": model, "prompt": prompt, "max_tokens": 4}}).encode()


# case: (raw request, response topic fails its first send, the expected
# status code or None for no response, the expected ack/nack sequence)
ENVELOPES = {
    "good": (_env(), False, 200, ["ack"]),
    "good_caller_id": (_env(request_id="caller-7"), False, 200, ["ack"]),
    "malformed_json": (b"{not json", False, None, ["ack"]),
    "no_path": (json.dumps({"body": {"model": "m", "prompt": "x"}}).encode(), False, None,
                ["ack"]),
    "unknown_path": (_env(path="/v1/bogus"), False, 404, ["ack"]),
    "no_model_field": (json.dumps({"metadata": {"corr": "c1"}, "path": "/v1/completions",
                                   "body": {"prompt": "x"}}).encode(), False, 400, ["ack"]),
    "unknown_model": (_env(model="ghost"), False, 404, ["ack"]),
    "no_endpoint": (_env(model="noep"), False, 503, ["ack"]),
    "backend_500": (_env(prompt="boom"), False, 500, ["ack"]),
    "backend_refused": (_env(model="refused"), False, 502, ["ack"]),
    "hostile_request_id": (_env(request_id="evil\r\nX-Injected: 1 <script>"), False, 200,
                           ["ack"]),
    "response_send_fails": (_env(), True, 200, ["nack", "ack"]),
}


class _Stack:
    """One package's fake model client and load balancer: models "m",
    "noep" (no endpoint: TimeoutError) and "refused" (a closed port); each
    pick records the package's active gauge for its model."""

    def __init__(self, pkg, backend, dead):
        self.mt = importlib.import_module(f"{pkg}.api.model_types")
        self.apiutils = importlib.import_module(f"{pkg}.proxy.apiutils")
        metrics = importlib.import_module(f"{pkg}.metrics")
        self.gauge = metrics.default_registry.gauge("kubeai_inference_requests_active")
        self.backend, self.dead = backend, dead
        self.scaled, self.gauge_at_pick = [], []

    def active(self, name):
        return self.gauge.value({"request_model": name, "request_type": "messenger"})

    def lookup_model(self, name, adapter, selectors):
        if name not in ("m", "noep", "refused"):
            raise self.apiutils.APIError(404, f"model {name} not found")
        return self.mt.Model(meta=self.mt.ObjectMeta(name=name),
                             spec=self.mt.ModelSpec(url="hf://a/b"))

    def scale_at_least_one_replica(self, model):
        self.scaled.append(model.meta.name)

    def await_best_address(self, req, timeout=None):
        self.gauge_at_pick.append(self.active(req.model_name))
        if req.model_name == "noep":
            raise TimeoutError("no endpoints")
        return (self.dead if req.model_name == "refused" else self.backend), lambda: None


def _messenger_run(pkg, raw, send_fails, backend, dead, monkeypatch) -> dict:
    """*raw* through *pkg*'s Messenger over its own mem:// queues: the
    responses, the ack/nack sequence, the scale calls, the gauge at the
    pick and after."""
    drivers = importlib.import_module(f"{pkg}.messenger.drivers")
    Messenger = importlib.import_module(f"{pkg}.messenger.messenger").Messenger
    acks = []

    class Recorded(drivers.Subscription):
        def __init__(self, name):
            self.sub = drivers.MemSubscription(name)

        def receive(self, timeout=None):
            m = self.sub.receive(timeout)
            if m is None:
                return None
            return drivers.Message(m.body, ack=lambda: (acks.append("ack"), m.ack()),
                                   nack=lambda: (acks.append("nack"), m.nack()))

    class FailsOnce(drivers.MemTopic):
        failed = False

        def send(self, body):
            if not self.failed:
                self.failed = True
                raise OSError("bus down")
            super().send(body)

    monkeypatch.setitem(drivers._DRIVERS, "rec", (None, Recorded))
    monkeypatch.setitem(drivers._DRIVERS, "failsonce", (FailsOnce, None))
    tag = uuid.uuid4().hex[:8]
    stack = _Stack(pkg, backend, dead)
    before = {n: stack.active(n) for n in ("m", "noep", "refused")}
    msgr = Messenger(f"rec://req-{tag}", f"{'failsonce' if send_fails else 'mem'}://resp-{tag}",
                     model_client=stack, lb=stack, await_timeout=5)
    msgr.start()
    try:
        drivers.open_topic(f"mem://req-{tag}").send(raw)
        deadline = time.monotonic() + 10
        while acks[-1:] != ["ack"]:
            assert time.monotonic() < deadline, f"{pkg}: no ack within 10 s: {acks}"
            time.sleep(0.01)
        # A response is published before its request is acked.
        resp_sub = drivers.MemSubscription(f"resp-{tag}")
        responses = []
        while (r := resp_sub.receive(timeout=0.05)) is not None:
            responses.append(json.loads(r.body))
    finally:
        msgr.stop()
    return {"responses": responses, "acks": acks, "scaled": stack.scaled,
            "gauge_at_pick": stack.gauge_at_pick,
            "gauge_after": {n: stack.active(n) - v for n, v in before.items()}}


def _without_generated_ids(run, caller_id) -> dict:
    """Generated request ids (32 hex digits, one per package) as "<gen>";
    a caller's sanitized id stays."""
    for r in run["responses"]:
        rid = r["metadata"].get("request_id")
        if rid is None or caller_id:
            continue
        assert len(rid) == 32 and int(rid, 16) >= 0, rid
        r["metadata"]["request_id"] = "<gen>"
        if isinstance(r["body"], dict) and r["body"].get("rid") == rid:
            r["body"]["rid"] = "<gen>"
    return run


@pytest.mark.parametrize("case", list(ENVELOPES))
def test_envelopes_get_the_same_answers(case, echo, monkeypatch):
    raw, send_fails, status, acks = ENVELOPES[case]
    dead = _closed_port()
    caller_id = b"request_id" in raw
    jax, port = (_without_generated_ids(_messenger_run(pkg, raw, send_fails, echo, dead,
                                                       monkeypatch), caller_id)
                 for pkg in PACKAGES)
    assert port == jax
    assert port["acks"] == acks
    assert [r["status_code"] for r in port["responses"]] == ([] if status is None else [status])
    assert port["gauge_after"] == {"m": 0.0, "noep": 0.0, "refused": 0.0}
    reached_lb = status in (200, 500, 502, 503)
    assert port["gauge_at_pick"] == ([1.0] * len(acks) if reached_lb else [])
    assert port["scaled"] == ([json.loads(raw)["body"]["model"]] * len(acks) if reached_lb
                              else [])
    if status is not None:
        assert port["responses"][0]["metadata"]["corr"] == "c1"
    if case == "good":
        assert port["responses"][0]["body"] == {"echo": "hello", "model": "m",
                                                "path": "/v1/completions", "rid": "<gen>"}
    if case == "hostile_request_id":
        rid = port["responses"][0]["metadata"]["request_id"]
        assert rid and "\n" not in rid and "<" not in rid and port["responses"][0]["body"][
            "rid"] == rid


# -- file:// across packages, and the URL rules ----------------------------


@pytest.mark.parametrize("writer,reader", [(jdrivers, tdrivers), (tdrivers, jdrivers)],
                         ids=["jax_to_port", "port_to_jax"])
def test_file_spool_crosses_packages(writer, reader, tmp_path):
    spool = tmp_path / "spool"
    topic = writer.open_topic(f"file://{spool}")
    sub = reader.open_subscription(f"file://{spool}")
    assert isinstance(topic, writer.FileTopic) and isinstance(sub, reader.FileSubscription)
    binary = bytes(range(256)) * 4
    topic.send(b"one")
    topic.send(binary)
    first = sub.receive(timeout=1)
    assert first.body == b"one"
    first.nack()  # renamed back: claimed again
    again = sub.receive(timeout=1)
    assert again.body == b"one"
    again.ack()
    second = sub.receive(timeout=1)
    assert second.body == binary
    second.ack()
    assert sub.receive(timeout=0.1) is None
    assert list(spool.iterdir()) == []


SPLIT_URLS = [
    "mem://req", "mem://a/b/", "file://spool/q", "file:///var/spool/q", "file://", "file:///",
    "kafka://reqs", "kafka://g1?topic=reqs", "nats://reqs?queue=workers", "rabbit://reqs",
    "azuresb://reqs", "gcppubsub://projects/p/topics/t",
    "awssqs://sqs.us-east-2.amazonaws.com/1/q?region=us-east-2", "no-scheme", "",
]


def _split_or_error(drivers, url):
    try:
        return drivers._split(url)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("url", SPLIT_URLS)
def test_split_agrees(url):
    assert _split_or_error(tdrivers, url) == _split_or_error(jdrivers, url)


def test_unknown_scheme_refused_alike():
    for drivers in (jdrivers, tdrivers):
        with pytest.raises(ValueError, match="no pubsub driver for scheme 'bogus'"):
            drivers.open_topic("bogus://x")


# -- kafka_proto: the same bytes ------------------------------------------

records = st.lists(st.tuples(st.none() | st.binary(max_size=64), st.binary(max_size=256)),
                   min_size=1, max_size=8)
names = st.text(st.characters(min_codepoint=32, max_codepoint=0x2FF), min_size=1, max_size=20)
int32 = st.integers(0, 2**31 - 1)
int64 = st.integers(0, 2**62)


@settings(max_examples=60, deadline=None)
@given(records=records, base=int64, ts=int64)
def test_record_batches_encode_identically(records, base, ts):
    jb = jkp.encode_record_batch(base, records, timestamp_ms=ts)
    tb = tkp.encode_record_batch(base, records, timestamp_ms=ts)
    assert tb == jb
    want = [(base + i, k, v) for i, (k, v) in enumerate(records)]
    assert [(r.offset, r.key, r.value) for r in tkp.decode_record_batches(jb)] == want
    assert [(r.offset, r.key, r.value) for r in jkp.decode_record_batches(tb + jb)] == want * 2


@settings(max_examples=40, deadline=None)
@given(topic=names, group=names, partition=st.integers(0, 63), offset=int64,
       corr=int32, wait=st.integers(0, 30000), body=st.binary(max_size=64))
def test_requests_encode_identically(topic, group, partition, offset, corr, wait, body):
    for enc, args in [
        ("encode_request", (1, 4, corr, group, body)),
        ("encode_response", (corr, body)),
        ("encode_metadata_request_v1", ([topic, group],)),
        ("encode_produce_request_v3", (topic, partition, body)),
        ("encode_produce_response_v3", (topic, partition, 0, offset)),
        ("encode_fetch_request_v4", (topic, partition, offset, wait)),
        ("encode_fetch_response_v4", (topic, partition, 0, offset, body)),
        ("encode_find_coordinator_request_v1", (group,)),
        ("encode_find_coordinator_response_v1", (partition, topic, wait)),
        ("encode_offset_commit_request_v2", (group, topic, partition, offset)),
        ("encode_offset_commit_response_v2", (topic, partition)),
        ("encode_offset_fetch_request_v3", (group, topic, partition)),
        ("encode_offset_fetch_response_v3", (topic, partition, offset)),
    ]:
        jb, tb = getattr(jkp, enc)(*args), getattr(tkp, enc)(*args)
        assert tb == jb, enc
        dec = enc.replace("encode_", "decode_")
        if enc != "encode_request" and enc != "encode_response" and hasattr(tkp, dec):
            assert getattr(tkp, dec)(tkp.Reader(jb)) == getattr(jkp, dec)(jkp.Reader(tb)), dec


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=512), v=st.integers(-2**62, 2**62))
def test_crc32c_and_varints_agree(data, v):
    assert tkp.crc32c(data) == jkp.crc32c(data)
    assert tkp.Writer().varint(v).build() == jkp.Writer().varint(v).build()


# -- the Manager's messengers from YAML -------------------------------------

STREAMS_YAML = """
messaging:
  errorMaxBackoffSeconds: 7
  streams:
    - requestsURL: mem://yaml-req
      responsesURL: mem://yaml-resp
      maxHandlers: 8
    - requestsURL: file:///var/spool/req
      responsesURL: file:///var/spool/resp
      maxHandlers: 2
"""


def test_yaml_streams_give_the_same_messengers(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", str(tmp_path / "history"))
    cfg = tmp_path / "system.yaml"
    cfg.write_text(STREAMS_YAML)
    settings_of = {}
    for pkg in PACKAGES:
        system = importlib.import_module(f"{pkg}.config.system").load_system_config(str(cfg))
        store = importlib.import_module(f"{pkg}.runtime.store").Store()
        mgr = importlib.import_module(f"{pkg}.manager").Manager(system, store=store, port=0)
        try:
            settings_of[pkg] = [(m.requests_url, m.responses_url, m.max_handlers,
                                 m.error_max_backoff, m.await_timeout) for m in mgr.messengers]
            assert all(m.model_client is mgr.model_client and m.lb is mgr.lb
                       for m in mgr.messengers)
        finally:
            mgr.api.httpd.server_close()
            if pkg == "kubeai_tpu_torch":
                from kubeai_tpu_torch.obs.canary import uninstall_canary

                uninstall_canary(mgr.canary)
            if pkg == "kubeai_tpu":
                from kubeai_tpu.obs import (
                    uninstall_canary,
                    uninstall_forecaster,
                    uninstall_history,
                    uninstall_recorder,
                )

                # The never-started JAX Manager installed these
                # process-wide; later tests expect them absent.
                uninstall_canary(mgr.canary)
                uninstall_recorder(mgr.incidents)
                uninstall_history(mgr.history)
                uninstall_forecaster(mgr.forecaster)
    assert settings_of["kubeai_tpu_torch"] == settings_of["kubeai_tpu"] == [
        ("mem://yaml-req", "mem://yaml-resp", 8, 7.0, 600.0),
        ("file:///var/spool/req", "file:///var/spool/resp", 2, 7.0, 600.0)]
