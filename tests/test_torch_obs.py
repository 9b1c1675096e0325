"""The port's failpoints, tracing, flight recorder, perf X-ray and metrics
against the JAX package's, on the CPU.

- ``faults.parse_spec`` and ``obs/trace.py``'s ``parse_traceparent`` /
  ``extract_context`` give the JAX modules' results on one table of specs
  and headers (and on generated header values);
- the port's failpoint sites are JAX sites (``kubeai_tpu.chaos.schedule.
  SUBSYSTEM_OF``), and ``/debug/faults`` arms one on a port server;
- ``obs/perf.py``: ``param_counts`` of the five catalog configs and the
  stall tracker's scripted fractions equal JAX's; ``pipeline_report``
  has the JAX engine's keys; ``/debug/profile`` answers 403, 400 and 409
  as JAX's does and captures a torch.profiler trace on the CPU;
- after the same requests, the port server's ``/metrics`` holds every
  family of the JAX engine server's page under the same name and type,
  except the listed families of modules the port does not have; TTFT and
  e2e counts equal the requests served;
- tests/test_tracing.py's request-id case through the JAX proxy: the
  id echoes to the client, reaches the port engine, and names its
  timeline, which joins the proxy's on one trace id.
"""

import dataclasses
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kubeai_tpu import faults as jfaults
from kubeai_tpu.chaos.schedule import SUBSYSTEM_OF
from kubeai_tpu.engine import core as jcore
from kubeai_tpu.engine.server import EngineServer as JServer
from kubeai_tpu.models.base import ModelConfig as JMC
from kubeai_tpu.obs import perf as jperf
from kubeai_tpu.obs import trace as jtrace
from kubeai_tpu_torch import faults as tfaults
from kubeai_tpu_torch.engine.core import build_test_engine
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.models.base import (
    gemma2_2b,
    gemma_2b,
    llama_3_1_8b,
    mixtral_8x7b,
    qwen2_5_7b,
)
from kubeai_tpu_torch.obs import perf as tperf
from kubeai_tpu_torch.obs import trace as ttrace
from kubeai_tpu_torch.obs.recorder import default_recorder

import test_proxy_integration as _pi
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

stack = _pi.stack  # the JAX proxy's in-process stack (fixture)

PORT_PKG = os.path.join(os.path.dirname(__file__), "..", "kubeai_tpu_torch")

SPECS = ["error", "error:2", "error:1:skip=2", "delay:0.05", "slow:5:3", "hang", "hang:max=1.5",
         "corrupt", "corrupt:2", "flap:2", "flap:2:0.25", "error:times=3", "",
         "bogus", "delay", "slow", "flap", "flap:0", "flap:1:1.5", "error:wat=1", "delay:x"]


def _spec(mod, spec):
    try:
        f = mod.parse_spec("site", spec)
    except ValueError:
        return "ValueError"
    return {**f.describe(), "max_s": f.max_s}


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    assert _spec(tfaults, spec) == _spec(jfaults, spec)


HEADERS = [
    {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"},
    {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-00", "X-Request-ID": "rid-1"},
    {"Traceparent": " 00-" + "AB" * 16 + "-" + "CD" * 8 + "-01 "},
    {"traceparent": "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01"},
    {"traceparent": "00-" + "0" * 32 + "-" + "cd" * 8 + "-01", "x-request-id": "r2"},
    {"X-Request-ID": "dirty id;<script>/../" + "x" * 200},
    {"traceparent": "garbage", "X-Request-ID": "rid-3"},
]


def _ctx(mod, headers):
    """The context's fields, where they are deterministic: a valid
    traceparent fixes the trace and span ids, an X-Request-ID the trace
    id; otherwise only their shapes."""
    c = mod.extract_context(headers)
    tp = next((v for k, v in headers.items() if k.lower() == "traceparent"), None)
    valid = mod.parse_traceparent(tp) is not None
    rid = any(k.lower() == "x-request-id" for k in headers)
    return (c.trace_id if valid or rid else len(c.trace_id),
            c.span_id if valid else len(c.span_id),
            c.request_id if valid or rid else len(c.request_id), c.sampled)


@pytest.mark.parametrize("headers", HEADERS, ids=range(len(HEADERS)))
def test_extract_context_matches_jax(headers):
    assert _ctx(ttrace, headers) == _ctx(jtrace, headers)
    assert ttrace.sanitize_request_id(headers.get("X-Request-ID", "")) == \
        jtrace.sanitize_request_id(headers.get("X-Request-ID", ""))


@settings(max_examples=100, deadline=None)
@given(st.one_of(st.text(max_size=60),
                 st.from_regex(r"[0-9a-fA-F]{2}-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}",
                               fullmatch=True)))
def test_parse_traceparent_matches_jax(header):
    t, j = ttrace.parse_traceparent(header), jtrace.parse_traceparent(header)
    assert (t is None) == (j is None)
    if t is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _port_sites() -> set:
    sites = set()
    for root, _, files in os.walk(PORT_PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    sites |= set(re.findall(r'\bfault\("([a-z_.]+)"', fh.read()))
    return sites


def test_fault_sites_are_jax_sites():
    sites = _port_sites()
    assert sites == {"engine.submit", "engine.step", "engine.stream", "engine.kv_export",
                     "engine.kv_import", "weights.load", "gang.publish", "gang.follower",
                     "history.disk", "incidents.disk", "proxy.connect", "balancer.reconcile"}
    assert sites <= set(SUBSYSTEM_OF)


def test_debug_faults_arms_a_port_server(monkeypatch):
    """Arming over HTTP reaches the port's registry (not the JAX one), is
    gated by KUBEAI_DEBUG_FAULTS, and a scoped twin fires on the server's
    own scheduler thread."""
    srv = EngineServer(build_test_engine(device="cpu"), "m", host="127.0.0.1", port=0)
    srv.start()

    def get(q):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/debug/faults{q}",
                                        timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        monkeypatch.delenv("KUBEAI_DEBUG_FAULTS", raising=False)
        assert get("?set=engine.step=delay:0.01")[0] == 403
        monkeypatch.setenv("KUBEAI_DEBUG_FAULTS", "1")
        code, body = get(f"?set=engine.step@{srv.port}=delay:0.01")
        assert code == 200 and body["faults"][0]["name"] == f"engine.step@{srv.port}"
        assert jfaults.list_faults() == []
        deadline = time.monotonic() + 10
        while not tfaults.list_faults()[0]["fired"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert tfaults.list_faults()[0]["fired"] >= 1
        assert get("?set=engine.step=bogus")[0] == 400
        assert get("?clear=all") == (200, {"faults": []})
    finally:
        tfaults.clear_all()
        srv.stop()


CATALOG = {"llama-3.1-8b": llama_3_1_8b, "qwen2.5-7b": qwen2_5_7b, "gemma-2b": gemma_2b,
           "gemma2-2b": gemma2_2b, "mixtral-8x7b": mixtral_8x7b}


@pytest.mark.parametrize("name", list(CATALOG))
def test_param_counts_match_jax(name):
    tc = CATALOG[name]()
    jc = JMC(**dataclasses.asdict(tc))
    assert tperf.param_counts(tc) == jperf.param_counts(jc)
    for q in ("", "int8"):
        assert dataclasses.asdict(tperf.PerfModel.from_model_config(tc, q)) == \
            dataclasses.asdict(jperf.PerfModel.from_model_config(jc, q))


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_stall_tracker_matches_jax():
    reports = []
    for mod in (tperf, jperf):
        clock = FakeClock()
        tr = mod.PipelineStallTracker(window=60.0, clock=clock)
        for i in range(10):
            tr.record_decode(dispatch_ms=1.0, host_overlap_ms=2.0 + i % 3,
                             fetch_wait_ms=6.0, emit_ms=1.0)
            clock.t += 1.0
        tr.record_prefill("prefill_group", 10.0)
        tr.record_kv_transfer(4.0)
        rep = tr.report()
        reports.append({k: v for k, v in rep.items() if k != "interpretation"})
    assert reports[0] == reports[1]
    assert reports[0]["dominant_cause"] == "fetch_wait"
    assert sum(c["fraction"] for c in reports[0]["causes"].values()) == pytest.approx(1.0, abs=1e-3)


def test_token_rate_window_matches_jax():
    rates = []
    for mod in (tperf, jperf):
        w = mod.TokenRateWindow(span=10.0, clock=FakeClock())
        out = []
        for i, (dt, n) in enumerate([(0, 8), (0.08, 8), (0.1, 16), (3, 8), (9, 24), (0.5, 0)]):
            w._clock.t += dt
            w.add(n)
            out.append(round(w.rate(), 9))
        w.reset()
        out.append((w.rate(), len(w)))
        rates.append(out)
    assert rates[0] == rates[1]


def test_device_constants():
    env = tperf.device_constants("NVIDIA H100 80GB HBM3")
    assert (env.peak_flops, env.hbm_gbps) == (989e12, 3350.0)
    cpu = tperf.detect_device("cpu")
    assert (cpu.kind, cpu.peak_flops, cpu.hbm_gbps) == ("cpu", None, None)
    assert tperf.PerfModel.from_model_config(llama_3_1_8b()).mfu(1000.0, None) == 0.0


def test_pipeline_report_keys_match_jax_engine():
    je = jcore.build_test_engine()
    te = build_test_engine(device="cpu")
    try:
        assert set(te.pipeline_report()) == set(je.pipeline_report())
        assert set(te._perf_debug_section()) == set(je._perf_debug_section())
        assert te._mfu() == 0.0 and te._roofline_fraction() == 0.0
    finally:
        je.stop()
        te.stop()


def test_profile_gates_and_capture(monkeypatch, tmp_path):
    monkeypatch.delenv("KUBEAI_DEBUG_PROFILE", raising=False)
    code, _, body = tperf.handle_perf_request("/debug/profile", "seconds=0.05")
    assert code == 403 and "KUBEAI_DEBUG_PROFILE" in json.loads(body)["error"]["message"]
    monkeypatch.setenv("KUBEAI_DEBUG_PROFILE", "1")
    monkeypatch.setattr(tperf.default_profiler, "root", str(tmp_path))
    assert tperf.handle_perf_request("/debug/profile", "seconds=banana")[0] == 400
    results = {}

    def first():
        results["first"] = tperf.handle_perf_request("/debug/profile", "seconds=0.8")

    t = threading.Thread(target=first, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not tperf.default_profiler._lock.locked() and time.monotonic() < deadline:
        time.sleep(0.005)
    code, _, _ = tperf.handle_perf_request("/debug/profile", "seconds=0.05")
    t.join(timeout=30)
    assert not t.is_alive() and code == 409
    code, _, body = results["first"]
    doc = json.loads(body)
    assert code == 200 and doc["trace_dir"].startswith(str(tmp_path))
    assert doc["files"] >= 1 and doc["bytes"] > 0 and doc["activities"] == ["cpu"]
    with open(doc["trace"]) as f:
        assert "traceEvents" in json.load(f)


# The JAX engine server's page also carries the families of operator-side
# modules its process imports (the proxy, the balancer, canary, SLOs...):
# the comparison takes the families of the engine side, and of those
# leaves out what the port does not have: jit recompiles (the port counts
# graph captures instead) and the proxy's QoS counters.
ENGINE_SIDE = re.compile(r"kubeai_(engine_|request_|kv_|qos_|log_|build_|gang_|tenant_)")
NOT_PORTED = re.compile(
    r"kubeai_(engine_jit_recompiles_total$"
    r"|qos_proxy_|qos_resumes_)")


def _families(port) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        text = r.read().decode()
    fams = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    counts = {m[0]: float(m[1]) for m in re.findall(
        r'^(kubeai_(?:engine_ttft_seconds|request_e2e_seconds)_count(?:\{[^}]*\})?) (\S+)$',
        text, re.M)}
    return fams, counts


def _complete(port, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_metrics_families_match_jax_engine():
    """One JAX and one port server (each engine built last in its
    package, so the callback gauges are theirs) serve the same three
    requests; the port's page then holds the JAX engine's families. A
    JAX checkpoint start imports engine/coldstart.py, whose
    kubeai_engine_cold_start_seconds the port's server always carries."""
    import kubeai_tpu.engine.coldstart  # noqa: F401  (the JAX cold-start family)

    jsrv = JServer(jcore.build_test_engine(), "m", host="127.0.0.1", port=0)
    tsrv = EngineServer(build_test_engine(device="cpu"), "m", host="127.0.0.1", port=0)
    jsrv.start()
    tsrv.start()
    try:
        _, before = _families(tsrv.port)
        for srv in (jsrv, tsrv):
            for body in ({"prompt": "hi", "max_tokens": 4},
                         {"prompt": "hello", "max_tokens": 3, "temperature": 0},
                         {"prompt": "x", "max_tokens": 2, "n": 1}):
                _complete(srv.port, body)
        jfams, _ = _families(jsrv.port)
        tfams, after = _families(tsrv.port)
    finally:
        jsrv.stop()
        tsrv.stop()
    want = {k: v for k, v in jfams.items() if ENGINE_SIDE.match(k) and not NOT_PORTED.match(k)}
    assert len(want) >= 45 and want["kubeai_engine_cold_start_seconds"] == "histogram"
    missing = {k: v for k, v in want.items() if tfams.get(k) != v}
    assert not missing, f"families missing or of another type: {missing}"
    assert "kubeai_engine_graph_captures_total" in tfams
    ttft = "kubeai_engine_ttft_seconds_count"
    e2e = 'kubeai_request_e2e_seconds_count{outcome="ok"}'
    assert after[ttft] - before.get(ttft, 0.0) == 3
    assert after[e2e] - before.get(e2e, 0.0) == 3


def test_request_id_reaches_the_port_engine_through_the_jax_proxy(stack):
    """tests/test_tracing.py's case over a port engine: the JAX proxy
    echoes X-Request-ID to the client and forwards it; the port engine's
    timeline carries it (queue, prefill and decode phases) and the
    proxy's trace id; a dirty id is sanitized as the JAX rule does."""
    from kubeai_tpu.api import model_types as mt
    from kubeai_tpu.obs import default_recorder as jrecorder

    store, rec, lb, mc, api, engines = stack
    srv = EngineServer(build_test_engine(device="cpu"), "m1", host="127.0.0.1", port=0)
    srv.start()
    engines.append(srv)
    store.create(mt.KIND_MODEL, _pi.mk_model("m1", min_replicas=1))
    pods = _pi.await_pods(store, "m1", 1)
    _pi.forge_ready(store, pods[0].meta.name, srv)
    for rid in ("trace-me-123", "dirty id;<x>"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{api.port}/openai/v1/completions",
            data=json.dumps({"model": "m1", "prompt": "hi", "max_tokens": 3}).encode(),
            headers={"Content-Type": "application/json", "X-Request-ID": rid})
        with urllib.request.urlopen(req, timeout=60) as r:
            r.read()
            echoed = r.headers.get("X-Request-ID")
        clean = jtrace.sanitize_request_id(rid)
        assert echoed == clean
        tls = [t for t in default_recorder.snapshot() if t["request_id"] == clean]
        assert tls and [p["name"] for p in tls[0]["phases"]] == ["queue", "prefill", "decode"]
        assert tls[0]["model"] == "m1" and tls[0]["outcome"] == "ok"
        ptl = [t for t in jrecorder.snapshot() if t["request_id"] == clean
               and t["component"] == "proxy"]
        assert ptl and ptl[0]["trace_id"] == tls[0]["trace_id"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/debug/requests?id={clean}", timeout=10) as r:
            assert json.loads(r.read())["requests"][0]["request_id"] == clean


def test_debug_index_and_routes():
    srv = EngineServer(build_test_engine(device="cpu"), "m", host="127.0.0.1", port=0)
    srv.start()

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, index = get("/debug")
        paths = [e["path"] for e in index["endpoints"]]
        assert code == 200 and index["server"] == "engine"
        for p in paths:
            if p != "/debug/profile":
                assert get(p)[0] == 200, p
        assert get("/debug/qos")[1]["queue"]["maxsize"] == srv.engine.cfg.max_queue
        assert "perf" in get("/debug/engine")[1]
        # As on the JAX engine: the tenant report and the history store
        # are listed and answer; the operator-side surfaces answer 404.
        assert {"/debug/tenants", "/debug/history"} <= set(paths)
        assert get("/debug/tenants")[1]["tenants"] is not None
        assert get("/debug/history")[1]["history_dir"].endswith("engine")
        for p in ("/debug/incidents", "/debug/canary", "/debug/forecast"):
            assert get(p)[0] == 404, p
        assert get("/debug/trace")[1]["displayTimeUnit"] == "ms"
        assert np.isfinite(get("/debug/pipeline")[1]["accounted_ms"])
    finally:
        srv.stop()
