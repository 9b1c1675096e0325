"""The operator's proxy, load balancer and reconciler (the JAX package's,
unchanged) driving port engine servers on the CPU: the engine's side of
the resume protocol is what the port serves them.

The fixtures are tests/test_disagg.py's ``disagg_stack`` and
tests/test_qos.py's ``qos_stack``, over port servers in place of the JAX
package's (``role_engines`` and ``qos_engine`` are redefined here):
- a disaggregated Model hands a stream off from a prefill-role port
  server to a decode-role one, importing the parked KV, and the client's
  stream equals a direct port engine's byte for byte;
- a preempted batch stream resumes byte-identical through the proxy;
- the autoscaler's engine-load scrape reads the port's /metrics;
- the proxy routes around a draining port replica (its 429 is load, not
  failure), and its deadline (a body ``timeout``, stamped as
  X-Request-Deadline) ends a slow generation on a port engine in a 504
  with the engine's slot and pages freed (tests/test_proxy_integration.py's
  ``stack``);
- a request with ``Authorization: Bearer k1`` reaches the port engine
  under the proxy's hashed tenant id, which the engine's /debug/tenants
  lists with that one request's slot- and page-seconds (the raw key
  appears nowhere on it).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import test_disagg as _disagg
import test_proxy_integration as _pi
import test_qos as _qos
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.api import model_types as mt
from kubeai_tpu.autoscaler.autoscaler import scrape_engine_load
from kubeai_tpu.disagg import ROLE_DECODE, ROLE_PREFILL
from kubeai_tpu.disagg.handoff import M_HANDOFFS
from kubeai_tpu.obs.tenants import hash_tenant_key
from kubeai_tpu.qos.stats import M_RESUMES
from kubeai_tpu_torch import faults
from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.metrics import default_registry as treg
from kubeai_tpu_torch.obs.tenants import default_accountant

disagg_stack = _disagg.disagg_stack
qos_stack = _qos.qos_stack
stack = _pi.stack


def count(name, **labels):
    return treg.get(name).value(labels=labels or None)


@pytest.fixture(scope="module")
def role_engines():
    """Port servers in test_disagg's roles: prefill (handoff budget 3) and
    decode, from the same seed."""
    ec = EngineConfig(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), decode_chunk=2)
    prefill = EngineServer(build_test_engine(ec, device="cpu"), "dz1", host="127.0.0.1",
                           port=0, role=ROLE_PREFILL, handoff_budget=3)
    decode = EngineServer(build_test_engine(ec, device="cpu"), "dz1", host="127.0.0.1",
                          port=0, role=ROLE_DECODE)
    prefill.start()
    decode.start()
    yield prefill, decode
    prefill.stop()
    decode.stop()


@pytest.fixture(scope="module")
def qos_engine():
    """A one-slot port server in test_qos's place."""
    eng = build_test_engine(EngineConfig(max_slots=1, max_seq_len=2048, prefill_buckets=(16, 32),
                                         decode_chunk=2, max_queue=16), device="cpu")
    srv = EngineServer(eng, "q1", host="127.0.0.1", port=0)
    srv.start()
    yield eng, srv
    srv.stop()


@pytest.mark.parametrize("breakeven", ["0", "256"], ids=["import", "replay"])
def test_handoff_through_the_proxy_equals_a_direct_stream(disagg_stack, role_engines,
                                                          monkeypatch, breakeven):
    """With the break-even at 0 the decode replica fetches the prefill
    replica's blob and imports it; at the default 256 this short prefix
    replays. The client's stream is the same either way."""
    monkeypatch.setenv("KUBEAI_KV_BREAKEVEN_TOKENS", breakeven)
    prefill, decode = role_engines
    _, _, _, api = disagg_stack
    body = _disagg.TestDisaggE2E.BODY
    reference, _ = _disagg.sse_post(decode.port, body, "/v1/completions")
    assert reference[-1] == "[DONE]" and len(reference) > 5
    ok_before = M_HANDOFFS.value(labels={"outcome": "ok"})
    capped_before = count("kubeai_engine_handoff_capped_total")
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    exp_before = count("kubeai_kv_export_total", outcome="ok")
    got, _ = _disagg.sse_post(api.port, body, "/openai/v1/completions", rid=f"torch-dz-{breakeven}")
    assert _disagg.shape(got) == _disagg.shape(reference)
    assert M_HANDOFFS.value(labels={"outcome": "ok"}) == ok_before + 1
    assert count("kubeai_engine_handoff_capped_total") == capped_before + 1
    assert count("kubeai_kv_export_total", outcome="ok") == exp_before + 1
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + (breakeven == "0")
    assert all("handoff" not in (fr or "") for t in _disagg.shape(got) if isinstance(t, tuple)
               for fr in [t[1]])


def test_preempted_batch_stream_resumes_through_the_proxy(qos_stack, qos_engine):
    eng, srv = qos_engine
    api = qos_stack
    body = dict(_qos.BATCH_BODY)
    path = "/openai/v1/completions"
    reference = _qos.sse_post(api.port, body, path=path, headers={"X-Priority": "batch"})
    assert reference[-1] == "[DONE]" and len(reference) > 5
    pre_before = count("kubeai_qos_preemptions_total")
    imp_before = count("kubeai_kv_import_total", outcome="ok")
    res_before = M_RESUMES.value()
    got: list = []

    def run():
        got.append(_qos.sse_post(api.port, body, path=path, headers={"X-Priority": "batch"},
                                 timeout=120))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _qos.await_cond(lambda: eng.active_slots() >= 1, msg="batch stream holding the slot")
    inter = _qos.sse_post(api.port, dict(body, prompt="quick question", max_tokens=4), path=path,
                          headers={"X-Priority": "interactive"})
    assert inter[-1] == "[DONE]"
    t.join(timeout=120)
    assert not t.is_alive() and got, "batch stream never completed"
    assert count("kubeai_qos_preemptions_total") == pre_before + 1
    assert M_RESUMES.value() >= res_before + 1
    assert count("kubeai_kv_import_total", outcome="ok") == imp_before + 1
    assert got[0] == reference


def test_engine_load_scrape_reads_the_port_metrics(qos_engine):
    eng, srv = qos_engine
    addr = f"127.0.0.1:{srv.port}"
    assert scrape_engine_load(addr) == 0
    occupier = eng.submit(eng.tokenizer.encode("hold the slot"),
                          SamplingParams(temperature=0.0, max_tokens=1600))
    queued = eng.submit(eng.tokenizer.encode("wait"), SamplingParams(max_tokens=2))
    try:
        _qos.await_cond(lambda: eng.active_slots() == 1, msg="occupier admitted")
        assert scrape_engine_load(addr) == 2  # one active slot, one queued
        with urllib.request.urlopen(f"http://{addr}/health", timeout=10) as r:
            assert json.load(r)["status"] == "ok"
    finally:
        occupier.cancelled.set()
        queued.cancelled.set()
        _qos.await_cond(lambda: eng.active_slots() == 0 and eng.queue_depth() == 0,
                        msg="engine drained")


def _proxy_post(api, body, timeout=60, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{api.port}/openai/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _port_replicas(stack, n, monkeypatch):
    """*n* port servers as the ready pods of Model m1 (round robin), each
    counting the engine submits it takes."""
    store, _, _, _, _, engines = stack
    ec = EngineConfig(max_slots=2, max_seq_len=256, prefill_buckets=(16, 32), decode_chunk=2)
    srvs = []
    for _ in range(n):
        srv = EngineServer(build_test_engine(ec, device="cpu"), "m1", host="127.0.0.1", port=0)
        srv.start()
        engines.append(srv)
        srv.submits = 0

        def counting(*a, _srv=srv, _submit=srv.engine.submit, **kw):
            _srv.submits += 1
            return _submit(*a, **kw)

        monkeypatch.setattr(srv.engine, "submit", counting)
        srvs.append(srv)
    store.create(mt.KIND_MODEL, _pi.mk_model(
        "m1", replicas=n, min_replicas=n, load_balancing=mt.LoadBalancing(strategy="RoundRobin")))
    for pod, srv in zip(_pi.await_pods(store, "m1", n), srvs):
        _pi.forge_ready(store, pod.meta.name, srv)
    return srvs


def test_the_proxy_routes_around_a_draining_replica(stack, monkeypatch):
    """A drains (a slowed request in flight holds its drain open): /readyz
    turns 503, and every request through the proxy is served by B."""
    api = stack[4]
    a, b = _port_replicas(stack, 2, monkeypatch)
    faults.arm_spec(f"engine.step@{a.port}", "delay:0.05")
    try:
        slow = a.engine.submit(a.engine.tokenizer.encode("slow"),
                               SamplingParams(temperature=0.0, max_tokens=40))
        drain = threading.Thread(target=a.drain, args=(30.0,), daemon=True)
        drain.start()
        _qos.await_cond(a.draining.is_set, msg="A draining")
        with urllib.request.urlopen(f"http://127.0.0.1:{a.port}/readyz", timeout=10) as r:
            pass
    except urllib.error.HTTPError as e:
        assert e.code == 503 and json.loads(e.read())["status"] == "draining"
    else:
        raise AssertionError("/readyz of a draining replica answered 200")
    a_before, b_before = a.submits, b.submits
    for i in range(6):
        status, body = _proxy_post(api, {"model": "m1", "prompt": f"r{i}", "max_tokens": 3})
        assert status == 200, body
    assert a.submits == a_before and b.submits == b_before + 6
    assert drain.is_alive(), "the drain waits for the request in flight"
    faults.clear_all()
    drain.join(timeout=30)
    assert not drain.is_alive() and a.stopped_event.is_set()
    events = []
    while not events or events[-1][0] not in ("done", "error"):
        events.append(slow.out.get(timeout=10))
    assert events[-1][0] == "done"


def test_a_proxy_deadline_ends_in_504_and_frees_the_engine(stack, monkeypatch):
    api = stack[4]
    (srv,) = _port_replicas(stack, 1, monkeypatch)
    eng = srv.engine
    cancelled = eng.m_requests.value(labels={"outcome": "cancelled"})
    faults.arm_spec(f"engine.step@{srv.port}", "delay:0.02")
    try:
        t0 = time.monotonic()
        status, body = _proxy_post(api, {"model": "m1", "prompt": "x", "max_tokens": 2000,
                                         "timeout": 0.3})
        assert status == 504, body
        assert time.monotonic() - t0 < 10
    finally:
        faults.clear_all()
    _qos.await_cond(lambda: eng.requests_in_system() == 0 and eng.active_slots() == 0,
                    msg="engine drained")
    assert eng._pool.used() == 0
    assert eng.m_requests.value(labels={"outcome": "cancelled"}) == cancelled + 1


def test_the_proxy_tenant_reaches_the_port_engine_hashed(stack, monkeypatch, tmp_path):
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", str(tmp_path))
    default_accountant.reset()
    api = stack[4]
    (srv,) = _port_replicas(stack, 1, monkeypatch)
    costs = []
    record = default_accountant.record_cost
    monkeypatch.setattr(default_accountant, "record_cost",
                        lambda t, s, p: (costs.append((t, s, p)), record(t, s, p)))
    try:
        status, body = _proxy_post(api, {"model": "m1", "prompt": "hi", "max_tokens": 4},
                                   headers={"Authorization": "Bearer k1"})
        assert status == 200, body
        _qos.await_cond(lambda: costs, msg="the engine's cost record")
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/debug/tenants",
                                    timeout=10) as r:
            raw = r.read().decode()
    finally:
        default_accountant.reset()
    tenant = hash_tenant_key("k1")
    ((t, slot_s, page_s),) = costs
    rows = json.loads(raw)["tenants"]
    assert t == tenant and [row["tenant"] for row in rows] == [tenant]
    assert rows[0]["cost"] == {"slot_seconds": round(slot_s, 4),
                               "kv_page_seconds": round(page_s, 4)}
    assert 0 < slot_s <= page_s
    assert "k1" not in raw.replace(tenant, "")
