"""The port's OTLP exporter (kubeai_tpu_torch/obs/otel.py) against the JAX
package's, on the CPU.

- ``timeline_to_spans``, ``registry_to_metrics`` and
  ``entry_to_log_record`` of both packages give equal payloads for the
  same timelines (a hand-made one and one the port engine recorded),
  registry contents (from a seed) and log entries.
- A port engine server with ``KUBEAI_OTLP_ENDPOINT`` at a loopback
  collector (benchmarks/otlp_stub.py) posts the spans of a completion
  under the trace id of its ``traceparent``, its metrics and a warning
  log record. The span names of one completion equal the JAX engine
  server's for the same request on the same weights (``engine``, then
  ``queue``, ``prefill`` and ``decode``): no difference to list.
- With the collector down the completion is served unchanged (the same
  greedy text as with it up) and the lost batches count in
  ``kubeai_otel_dropped_total{reason="send_error"}``; a full queue drops
  and counts ``queue_full`` without waiting. Waiting is counted, not
  timed (the suite shares a loaded CPU): every POST and every wait on
  the worker's wake-up event happen on the exporter's own thread, none
  on a request's or on the producer's, and 200 dropped enqueues cost
  under 0.5 s of the producer thread's CPU time.
"""

import threading

import json
import logging
import time
import urllib.request

import numpy as np
import pytest

from benchmarks.otlp_stub import StubCollector
from kubeai_tpu.engine.server import EngineServer as JServer
from kubeai_tpu.metrics.registry import Registry as JRegistry
from kubeai_tpu.obs import otel as jo
from kubeai_tpu_torch.engine.core import build_test_engine
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.metrics import Registry as TRegistry
from kubeai_tpu_torch.metrics import default_registry as treg
from kubeai_tpu_torch.obs import otel as to
from kubeai_tpu_torch.obs import tenants as tt
from kubeai_tpu_torch.obs.logs import get_logger
from kubeai_tpu_torch.obs.recorder import default_recorder

from _torch_parity import parity_engines
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", str(tmp_path))
    monkeypatch.setenv("KUBEAI_OTLP_FLUSH_INTERVAL", "0.05")
    tt.default_accountant.reset()
    yield


DOC = {
    "trace_id": "ab" * 16, "span_id": "cd" * 8, "request_id": "r1", "component": "engine",
    "model": "m1", "start_ms": 1000.25, "duration_ms": 5.5, "outcome": "ok",
    "attrs": {"tenant": "t1", "prompt_tokens": 7, "flag": True, "ratio": 0.5, "l": [1]},
    "phases": [
        {"name": "queue", "start_ms": 1000.25, "duration_ms": 1.0},
        {"name": "decode", "start_ms": 1001.0, "duration_ms": 4.0,
         "attrs": {"tokens": 8, "ignored": [1, 2], "tpot_ms_mean": 0.3}},
    ],
}


def _complete(port, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _recorded(request_id, timeout=10.0):
    """The recorder's timelines of *request_id*, waited for: the response
    can reach the client before the engine submits the finished trace to
    the recorder's thread, so one snapshot may not hold it yet."""
    deadline = time.monotonic() + timeout
    while True:
        got = [t for t in default_recorder.snapshot() if t["request_id"] == request_id]
        if got or time.monotonic() >= deadline:
            return got
        time.sleep(0.02)


def test_converters_equal_jax():
    for doc in (DOC, {**DOC, "outcome": "error", "phases": None}, {}):
        assert to.timeline_to_spans(doc) == jo.timeline_to_spans(doc)
    # A timeline the port's engine recorded.
    srv = EngineServer(build_test_engine(device="cpu"), "conv", host="127.0.0.1", port=0)
    srv.start()
    try:
        _complete(srv.port, {"prompt": "hi", "max_tokens": 4},
                  {"X-KubeAI-Tenant": "conv-t", "X-Request-ID": "conv-1"})
        (tl,) = _recorded("conv-1")
    finally:
        srv.stop()
    assert to.timeline_to_spans(tl) == jo.timeline_to_spans(tl)
    for entry in ({"ts": 12.5, "level": "ERROR", "logger": "kubeai_tpu_torch.x",
                   "message": "boom", "trace_id": "ff" * 16, "span_id": "aa" * 8,
                   "model": "m1", "n": 3},
                  {"ts": 1.0, "level": "NOTICE", "message": ""}, {}):
        assert to.entry_to_log_record(entry) == jo.entry_to_log_record(entry)
    g = np.random.default_rng(0)
    regs = (JRegistry(), TRegistry())
    for i in range(30):
        v = float(g.exponential(1.0))
        lab = {"outcome": str(g.choice(["ok", "error"]))}
        for reg in regs:
            reg.counter("t_total", "c").inc(v, labels=lab)
            reg.gauge("t_gauge", "g").set(v, labels={"k": str(i % 3)})
            reg.histogram("t_seconds", "h", buckets=[0.1, 1.0]).observe(v, labels=lab)
            reg.callback_gauge("t_cb", "cb", fn=lambda v=v: v)
            reg.counter("t_empty_total", "never incremented")
    assert to.registry_to_metrics(regs[1], 17) == jo.registry_to_metrics(regs[0], 17)
    names = {m["name"] for m in to.registry_to_metrics(treg, 1)}
    assert "kubeai_otel_exported_total" not in names and "kubeai_otel_dropped_total" not in names


def _spans_by_trace(stub, trace_id, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = [s for s in stub.spans() if s.get("traceId") == trace_id]
        if spans:
            return spans
        time.sleep(0.05)
    return []


GREEDY = {"prompt": "The sea", "max_tokens": 8, "temperature": 0}


def test_port_server_exports_spans_metrics_and_logs_like_the_jax_server(monkeypatch):
    """One collector, two servers on the same weights; each completion's
    spans under its own traceparent."""
    je, te = parity_engines()
    with StubCollector() as stub:
        monkeypatch.setenv("KUBEAI_OTLP_ENDPOINT", stub.endpoint)
        tsrv = EngineServer(te, "tiny", host="127.0.0.1", port=0)
        tsrv.start()
        exp = to.installed_exporter()
        jsrv = JServer(je, "tiny", host="127.0.0.1", port=0)
        jsrv.start()
        try:
            assert exp is not None and exp.endpoint == stub.endpoint
            tid, jid = "1a" * 16, "2b" * 16
            tout = _complete(tsrv.port, GREEDY, {"traceparent": f"00-{tid}-{'cd' * 8}-01"})
            jout = _complete(jsrv.port, GREEDY, {"traceparent": f"00-{jid}-{'cd' * 8}-01"})
            assert tout["choices"][0]["text"] == jout["choices"][0]["text"]
            get_logger("kubeai_tpu_torch.test_otel").warning("otel probe")
            exp.export_metrics()
            tspans, jspans = _spans_by_trace(stub, tid), _spans_by_trace(stub, jid)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not any(
                    r["body"]["stringValue"] == "otel probe" for r in stub.log_records()):
                time.sleep(0.05)
        finally:
            jsrv.stop()
            tsrv.stop()
    assert to.installed_exporter() is None
    assert tspans and [s["name"] for s in tspans] == [s["name"] for s in jspans] == \
        ["engine", "queue", "prefill", "decode"]
    root = tspans[0]
    assert root["kind"] == 2 and root["status"]["code"] == 1
    assert all(s["parentSpanId"] == root["spanId"] for s in tspans[1:])
    assert {"kubeai_engine_ttft_seconds", "kubeai_request_e2e_seconds"} <= stub.metric_names()
    assert any(r["body"]["stringValue"] == "otel probe" for r in stub.log_records())


def test_collector_down_serves_unchanged_and_counts_send_errors(monkeypatch, caplog):
    # INFO records flow to the exporter (a log POST follows the spans' in
    # a flush) whatever level an earlier test left the root logger at.
    caplog.set_level(logging.INFO, logger="kubeai_tpu_torch")

    def dropped(reason):
        return to.M_DROPPED.value(labels={"signal": "span", "reason": reason})

    eng = build_test_engine(device="cpu")
    srv = EngineServer(eng, "down", host="127.0.0.1", port=0)
    srv.start()
    try:
        ref = _complete(srv.port, GREEDY)["choices"][0]["text"]
    finally:
        srv.stop()
    stub = StubCollector(fail=True).start()
    monkeypatch.setenv("KUBEAI_OTLP_ENDPOINT", stub.endpoint)
    monkeypatch.setenv("KUBEAI_OTLP_TIMEOUT", "0.5")
    before = dropped("send_error")
    srv = EngineServer(build_test_engine(device="cpu"), "down", host="127.0.0.1", port=0)
    srv.start()
    try:
        exp = to.installed_exporter()
        # Who posts and who waits on the worker's wake-up event: the
        # exporter's thread only.
        waiters: list = []
        # Each POST's path, result and the error it left behind, read on
        # the exporter's thread as the POST returns: ``last_error`` is the
        # newest failure of any signal, and with INFO logs flowing (a
        # process whose root logger is at INFO) a failed /v1/logs POST
        # follows the spans' in the same flush.
        sends: list = []
        send, wake_wait = exp._send, exp._wake.wait

        def spy_send(path, *a, **k):
            waiters.append(("send", threading.current_thread()))
            ok = send(path, *a, **k)
            sends.append((path, ok, exp.last_error))
            return ok

        monkeypatch.setattr(exp, "_send", spy_send)
        monkeypatch.setattr(exp._wake, "wait", lambda *a, **k: (
            waiters.append(("wait", threading.current_thread())), wake_wait(*a, **k))[1])
        t0 = time.monotonic()
        got = _complete(srv.port, GREEDY)["choices"][0]["text"]
        served_s = time.monotonic() - t0
        deadline = time.monotonic() + 15
        while dropped("send_error") == before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert got == ref and dropped("send_error") > before
        assert exp.consecutive_failures > 0
        assert any(path == "/v1/traces" and not ok and err.startswith("/v1/traces")
                   for path, ok, err in sends), sends
        assert served_s < 10  # a hang guard: the waits are counted below
        assert any(kind == "send" for kind, _ in waiters)
        assert {t for _, t in waiters} == {exp._thread}, {t.name for _, t in waiters}
        # A full queue drops at once and counts queue_full.
        full = dropped("queue_full")
        exp.queue_max = 0
        n_waits = len(waiters)
        cpu0 = time.thread_time()
        for _ in range(200):
            exp.enqueue("span", DOC)
        cpu_s = time.thread_time() - cpu0
        assert dropped("queue_full") == full + 200
        assert threading.current_thread() not in {t for _, t in waiters[n_waits:]}
        assert cpu_s < 0.5, cpu_s
    finally:
        srv.stop()
        stub.stop()


def test_maybe_start_exporter_is_off_by_default(monkeypatch):
    monkeypatch.delenv("KUBEAI_OTLP_ENDPOINT", raising=False)
    assert to.maybe_start_exporter("test") is None
    monkeypatch.setenv("KUBEAI_OTLP_ENDPOINT", "http://127.0.0.1:9")
    monkeypatch.setenv("KUBEAI_OTLP_QUEUE_MAX", "7")
    exp = to.maybe_start_exporter("test")
    try:
        assert to.installed_exporter() is exp and (exp.queue_max, exp.service) == (7, "test")
    finally:
        exp.stop(drain=False)
        to.uninstall_exporter(exp)
    assert to.installed_exporter() is None
    # Leftovers at a stop without a drain count as shutdown drops.
    exp = to.OtelExporter("http://127.0.0.1:9", flush_interval=60.0, timeout=0.2, max_retries=0)
    exp.enqueue("log", {"ts": 0, "level": "INFO", "logger": "x", "message": "m"})
    before = to.M_DROPPED.value(labels={"signal": "log", "reason": "shutdown"})
    exp.stop(drain=False)
    assert to.M_DROPPED.value(labels={"signal": "log", "reason": "shutdown"}) == before + 1
    assert exp._handler not in logging.getLogger("kubeai_tpu_torch").handlers
