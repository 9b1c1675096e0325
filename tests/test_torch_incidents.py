"""The port's incident black box (kubeai_tpu_torch/obs/incidents.py,
obs/incident_report.py) against the JAX package's, on the CPU.

- The recorder and breaker-to-incident cases of
  tests/test_incidents.py run on both packages: the JAX file, then its
  source with the JAX package's names spelled as the port's (its HTTP
  test helpers, package-free fakes, kept).
- With one clock, one wall and the same triggers, both recorders give
  equal debounce, suppression, documents and reports; from the same
  seeded remote pages the counter watch publishes the same triggers.
- A ring written by either package reads in the other (``get``,
  ``disk_index``, the CLI's ``--dir``, ``--list`` and ``--id``), and
  ``render_incident`` of the same documents is byte-equal.
- ``standard_sources`` over the port's balancer, fleet, history and
  forecaster captures every section, the ``engines`` one from a port
  engine server's step records; the engine answers the operator's
  routes 404.
- A Manager answers ``/debug/incidents`` and ``/debug/forecast`` 200,
  persists under ``KUBEAI_INCIDENT_DIR`` and ``KUBEAI_HISTORY_DIR``
  (``obs_dirs``: the test's own), writes nothing into its default
  directories (under a temporary directory of the test's own, so no
  other process's writes can reach them), and uninstalls what it
  installed at stop.
"""

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import test_incidents as jtest_incidents
from _torch_operator import jax_cases, obs_dirs, run_jax_case, to_port  # noqa: F401
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from kubeai_tpu.metrics import default_registry as jreg
from kubeai_tpu.obs import forecast as jf
from kubeai_tpu.obs import history as jh
from kubeai_tpu.obs import incident_report as jreport
from kubeai_tpu.obs import incidents as ji
from kubeai_tpu_torch.metrics import default_registry as treg
from kubeai_tpu_torch.obs import forecast as tf
from kubeai_tpu_torch.obs import history as th
from kubeai_tpu_torch.obs import incident_report as treport
from kubeai_tpu_torch.obs import incidents as ti

PKGS = {"jax": (ji, jreg, jreport), "port": (ti, treg, treport)}


def _port_module(module):
    """*module*'s source with the JAX package's names spelled as the
    port's; its imports of other test modules (HTTP fakes) stay."""
    name = "port_partial_" + module.__name__
    if name in sys.modules:
        return sys.modules[name]
    with open(module.__file__) as f:
        src = re.sub(r"\bkubeai_tpu\b(?!_torch)", "kubeai_tpu_torch", f.read())
    mod = types.ModuleType(name)
    mod.__file__ = module.__file__
    sys.modules[name] = mod
    exec(compile(src, module.__file__, "exec"), mod.__dict__)
    return mod


CLASSES = ("TestIncidentRecorder", "TestIncidentChaosE2E")
CASES = [c for c in jax_cases(jtest_incidents) if c.values[1].split(".")[0] in CLASSES]


@pytest.mark.parametrize("module,qual,params", CASES)
def test_jax_cases_on_both_packages(module, qual, params, request, monkeypatch,
                                    tmp_path_factory):
    run_jax_case(module, qual, params, (), request, monkeypatch)
    # The port's run gets a directory of its own (ids are epoch ms).
    clone = _port_module(module)
    cls, meth = qual.split(".")
    if "tmp_path" in getattr(getattr(clone, cls), meth).__code__.co_varnames:
        params = {**params, "tmp_path": tmp_path_factory.mktemp("port")}
    run_jax_case(clone, qual, to_port(params), (), request, monkeypatch)


class Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


class _Election:
    def __init__(self, leading=True):
        self.is_leader = threading.Event()
        if leading:
            self.is_leader.set()


def _recorder(mod, d, clock, wall, **kw):
    rec = mod.IncidentRecorder(
        sources={"probe": lambda: {"alive": True, "n": [1, 2.5, None]},
                 "broken": lambda: 1 / 0},
        incident_dir=d, clock=clock, wall=wall, election=kw.pop("election", _Election()), **kw)
    rec.settle = 0.0
    return rec


def _stable(doc):
    """A document less its capture's own seconds."""
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items() if k != "capture_seconds"}
    if isinstance(doc, list):
        return [_stable(x) for x in doc]
    return doc


SCRIPT = (  # (clock step, trigger, model, key)
    (0, "breaker_ejection", "m1", ""), (1, "breaker_ejection", "m1", ""),
    (1, "breaker_ejection", "m2", ""), (2, "canary_error", "m1", ""),
    (5, "slo_burn", "", "ttft"), (5, "slo_burn", "", "e2e"), (10, "slo_burn", "", "ttft"),
    (29, "breaker_ejection", "m1", ""), (31, "breaker_ejection", "m1", ""),
    (40, "autoscaler_hold", "m1", "m1#decode"), (60, "canary_error", "m1", ""),
    (200, "canary_error", "m1", ""), (400, "canary_error", "m1", ""),
    (1, "crash_loop", "m3", ""), (1, "gang_reform", "", ""), (1, "traffic_anomaly", "m1", ""),
)


def test_same_clock_and_triggers_give_equal_incidents(tmp_path):
    got = {}
    for pkg, (mod, _, _) in PKGS.items():
        d = str(tmp_path / pkg)
        clock, wall = Clock(1000.0), Clock(1_700_000_000.0)
        rec = _recorder(mod, d, clock, wall, capacity=10, max_disk=5)
        ids = []
        for step, trigger, model, key in SCRIPT:
            clock.t += step
            wall.t += step
            ids.append(rec.publish(trigger, model=model, detail={"step": step}, key=key))
            assert rec.wait_idle()
        rec.watch_tick()
        assert rec.wait_idle()
        rep = rec.report()
        rep.pop("incident_dir")
        files = sorted(os.listdir(d))
        docs = [json.load(open(os.path.join(d, f))) for f in files]
        got[pkg] = (ids, _stable(rep), files, _stable(docs),
                    [_stable(rec.get(i)) for i in ids if i],
                    rec.get("../x"), rec.get("nope"))
        rec.stop()
    assert got["port"] == got["jax"]
    ids, rep = got["port"][:2]
    assert sum(i is None for i in ids) >= 4  # suppressed repeats
    assert len(rep["incidents"]) == 10 and len(rep["disk"]) == 5  # both rings bounded
    assert any(i["suppressed_repeats"] for i in rep["incidents"])
    assert all(i["sections_ok"] == ["probe"] for i in rep["incidents"])


def _pages(g, addrs, totals):
    pages = {}
    for addr in addrs:
        t = totals.setdefault(addr, {"ok": 0.0, "error": 0.0, "cancelled": 0.0, "reforms": 0.0})
        for k in ("ok", "error", "cancelled"):
            t[k] += float(g.integers(0, 6 if k == "ok" else 4))
        t["reforms"] += float(g.random() < 0.1)
        pages[addr] = {
            "kubeai_engine_requests_total": [({"outcome": k}, t[k])
                                             for k in ("ok", "error", "cancelled")],
            "kubeai_gang_reforms_total": [({}, t["reforms"])],
        }
    return pages


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_watch_same_pages_same_triggers(seed, tmp_path):
    published = {}
    for pkg, (mod, reg, _) in PKGS.items():
        g = np.random.default_rng(seed)
        totals: dict = {}
        pages: dict = {}
        rec = _recorder(mod, "", Clock(0.0), Clock(1e9), remote_pages=lambda: pages)
        out = published[pkg] = []
        rec.publish = lambda trigger, model="", detail=None, key="", out=out: out.append(
            (trigger, model, detail, key))
        restarts = reg.counter("kubeai_pod_restarts_total", "pod restarts")
        for tick in range(25):
            addrs = ["e1:9100", "e2:9100", "e3:9100"]
            if tick % 7 == 3:
                addrs.remove("e2:9100")  # a failed scrape
            if tick > 15:
                addrs.append("e4:9100")  # a new endpoint
            pages.clear()
            pages.update(_pages(g, addrs, totals))
            if tick % 5 == 4:
                restarts.inc(float(g.integers(1, 3)), labels={"model": f"crash-{seed}"})
            rec.watch_tick()
    assert published["port"] == published["jax"]
    kinds = {p[0] for p in published["port"]}
    assert {"error_spike", "crash_loop"} <= kinds


def _capture(mod, d, wall, sources):
    rec = mod.IncidentRecorder(sources=sources, incident_dir=d, wall=wall, election=_Election(),
                               debounce_seconds=0.0)
    rec.settle = 0.0
    ids = [rec.publish(t, model=m, detail={"n": i}) for i, (t, m) in enumerate(
        (("breaker_ejection", "m1"), ("error_spike", ""), ("traffic_anomaly", "m2")))]
    assert rec.wait_idle()
    rec.stop()
    return ids


def _cli(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = mod.main(argv)
    return code, out.getvalue()


def _rich_sections():
    """Every section incident_report renders, from both packages' own
    producers where they have one (history, forecast) and seeded data."""
    wall = Clock(1_700_000_000.0)
    store = jh.HistoryStore(history_dir="", wall=wall)
    fc = jf.Forecaster(store, interval_seconds=5.0, season_seconds=800.0, bins=16,
                       horizon_seconds=400.0, lead_seconds=100.0, wall=wall, clock=wall)
    g = np.random.default_rng(4)
    t = wall.t - 2400.0
    while t < wall.t:
        store.record("kubeai_inference_requests_active{request_model=m1,request_type=http}",
                     float(5 + 4 * np.sin(t / 127.0) + g.normal(0, 0.2)), t=t)
        store.record("kubeai_engine_queue_depth", float(g.integers(0, 9)), t=t)
        store.record("fleet.m1.tokens_per_second", float(g.uniform(0, 900)), t=t)
        t += 10.0
    store.mark_gap("restart", since=wall.t - 300, t=wall.t - 200)
    for _ in range(5):
        wall.t += 25.0
        fc.tick()
    now = wall.t
    return {
        "autoscaler": lambda: {"decisions": [
            {"t": now - 5, "model": "m1", "desired": 2, "current": 1, "applied": True,
             "reason": "scale_up", "signal": {"requests": 3.5, "forecast": {"rate": 4}}},
            {"t": now - 2, "model": "m1", "pool": "decode", "desired": 1, "current": 1,
             "applied": False, "reason": "hold", "signal": 1.5}]},
        "endpoints": lambda: {"models": {"m1": [
            {"address": "10.0.0.1:8000", "state": "open", "opened_age_s": 1.5,
             "consecutive_failures": 3, "role": ""},
            {"address": "10.0.0.2:8000", "state": "closed"}]}},
        "requests": lambda: {"requests": [
            {"request_id": "canary-1", "start_ms": (now - 3) * 1000, "component": "proxy",
             "model": "m1", "outcome": "ok", "duration_ms": 40.0,
             "phases": [{"name": "upstream", "duration_ms": 38.0}]},
            {"request_id": "r2", "start_ms": (now - 1) * 1000, "component": "proxy",
             "model": "m1", "outcome": "error", "duration_ms": 12.0, "phases": []}]},
        "canary": lambda: {"models": {
            "m1": {"t": now - 4, "outcome": "ok", "e2e_s": 0.05, "ttft_s": 0.04},
            "m2": {"t": now - 3, "outcome": "corrupt", "fingerprint": "ab", "baseline": "cd",
                   "text": "x"},
            "m3": {"t": now - 2, "outcome": "error", "error": "http 502"}}},
        "slo": lambda: {"objectives": [
            {"name": "ttft", "attainment": 0.9, "burn_rate": 4.0, "requests": 20,
             "target": 0.99}, {"name": "e2e", "pending": True}]},
        "engines": lambda: {"m1": {
            "10.0.0.1:8000": {"pipeline": {"causes": {"dispatch": {"fraction": 0.7},
                                                      "fetch_wait": {"fraction": 0.3}},
                                           "interpretation": "host-bound"}},
            "10.0.0.2:8000": {"pipeline": {"error": "timed out"}}}},
        "fleet": lambda: {"models": {"m1": {"aggregate": {
            "endpoints": 2, "failed_endpoints": 1, "queue_depth": 3, "active_slots": 4,
            "slots_total": 16, "tokens_per_second": 410.5, "headroom_requests": 6,
            "prefix_hit_ratio": None}}}},
        "routing": lambda: {"m1": {"endpoints": [
            {"name": "10.0.0.1:8000", "load_factor": 1.7, "recent_picks": 9,
             "breaker_state": "open"}, {"name": "10.0.0.2:8000", "load_factor": 0.4}],
            "recent_picks": {"total": 11, "by_strategy": {"prefix_hash": 8, "least_load": 3}},
            "total_in_flight": 2}, "note": "not a model"},
        "tenants": lambda: {"tenants": [
            {"rank": 1, "tenant": "t-a", "share": 0.8, "requests": {"window": 40,
                                                                     "per_second": 1.3},
             "tokens": {"prompt": 900, "completion": 300},
             "latency": {"ttft_attainment": 0.95}, "cost": {"kv_page_seconds": 12.5}}]},
        "history": store.context_block,
        "forecast": lambda: fc.report(points=32),
        "logs": lambda: {"records": [
            {"ts": now - 2.5, "level": "WARNING", "logger": "kubeai.proxy",
             "message": "upstream failed", "trace_id": "abc", "model": "m1"}],
            "evicted": 3},
        "broken": lambda: 1 / 0,
    }, wall


def test_rings_and_rendering_cross_packages(tmp_path):
    sources, wall = _rich_sections()
    rendered = {}
    for writer, reader in (("jax", "port"), ("port", "jax")):
        d = str(tmp_path / f"by-{writer}")
        ids = _capture(PKGS[writer][0], d, Clock(wall.t), sources)
        reading = PKGS[reader][0].IncidentRecorder(incident_dir=d, election=_Election())
        writing = PKGS[writer][0].IncidentRecorder(incident_dir=d, election=_Election())
        assert reading.disk_index() == writing.disk_index() == sorted(ids, reverse=True)
        for i in ids:
            doc = reading.get(i)
            assert doc == writing.get(i) and doc["id"] == i
            assert doc["sections"]["broken"] == {"error": "division by zero"}
            texts = {p: PKGS[p][2].render_incident(doc) for p in PKGS}
            assert texts["port"] == texts["jax"]
            rendered[(writer, i)] = texts["port"]
        for argv in (["--dir", d], ["--dir", d, "--list"], ["--dir", d, "--id", ids[1]],
                     ["--dir", d, "--id", "missing"], ["--dir", d, "--json"],
                     ["--dir", str(tmp_path / "none")], ["--dir", str(tmp_path / "none"),
                                                         "--list"]):
            assert _cli(treport, argv) == _cli(jreport, argv), argv
        assert _cli(treport, ["--dir", d])[0] == 0
        assert _cli(treport, ["--dir", str(tmp_path / "none"), "--list"])[0] == 1
    text = rendered[("port", ids[2])]
    for what in ("TRIGGER", "autoscaler", "breaker", "request", "canary", "slo", "stall",
                 "fleet", "routing", "tenant", "history", "forecast", "log", "broken"):
        assert what in text, what


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_standard_sources_over_the_port_stack(tmp_path):
    from kubeai_tpu_torch.api import model_types as mt
    from kubeai_tpu_torch.api.core_types import KIND_POD
    from kubeai_tpu_torch.api.model_types import Model, ModelSpec
    from kubeai_tpu_torch.autoscaler.autoscaler import DecisionLog
    from kubeai_tpu_torch.autoscaler.fleet import FleetCollector
    from kubeai_tpu_torch.config.system import System
    from kubeai_tpu_torch.controller.controller import ModelReconciler
    from kubeai_tpu_torch.engine.core import build_test_engine
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.loadbalancer.balancer import LoadBalancer
    from kubeai_tpu_torch.proxy.modelclient import ModelClient
    from kubeai_tpu_torch.runtime.store import ObjectMeta, Store

    srv = EngineServer(build_test_engine(device="cpu"), "m1", host="127.0.0.1", port=0)
    srv.start()
    store = Store()
    system = System().default_and_validate()
    system.allow_pod_address_override = True
    rec_ = ModelReconciler(store, system)
    rec_.start()
    lb = LoadBalancer(store, allow_pod_address_override=True)
    lb.start()
    try:
        body = json.dumps({"prompt": "hello", "max_tokens": 4}).encode()
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"}), timeout=60).read()
        for p in ("/debug/incidents", "/debug/forecast"):
            assert _get(srv.port, p)[0] == 404
        store.create(mt.KIND_MODEL, Model(meta=ObjectMeta(name="m1"), spec=ModelSpec(
            url="hf://org/model", resource_profile="cpu:1", replicas=1, min_replicas=1)))
        deadline = time.monotonic() + 10
        while not store.list(KIND_POD, selector={mt.LABEL_MODEL: "m1"}):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        (pod,) = store.list(KIND_POD, selector={mt.LABEL_MODEL: "m1"})

        def forge(p):
            p.status.ready = True
            p.status.pod_ip = "127.0.0.1"
            p.meta.annotations[mt.ANNOTATION_MODEL_POD_IP] = "127.0.0.1"
            p.meta.annotations[mt.ANNOTATION_MODEL_POD_PORT] = str(srv.port)

        store.mutate(KIND_POD, pod.meta.name, forge)
        while not lb.get_all_addresses("m1"):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        fleet = FleetCollector(lb)
        history = th.HistoryStore(history_dir="")
        fleet.history = history
        fleet.collect(["m1"])
        forecaster = tf.Forecaster(history)
        decisions = DecisionLog()
        decisions.append({"t": time.time(), "model": "m1", "desired": 1, "current": 1})
        recorder = ti.IncidentRecorder(
            sources=ti.standard_sources(lb, ModelClient(store), fleet=fleet,
                                        decision_log=decisions, history=history,
                                        forecaster=forecaster),
            incident_dir=str(tmp_path), election=_Election())
        iid = recorder.publish("breaker_ejection", model="m1")
        assert recorder.wait_idle(10)
        recorder.stop()
        doc = json.load(open(tmp_path / f"incident-{iid}.json"))
    finally:
        lb.stop()
        rec_.stop()
        srv.stop()
    assert sorted(doc["sections_ok"]) == sorted(doc["sections"]) == sorted(
        ["endpoints", "requests", "engines", "tenants", "logs", "routing", "fleet",
         "autoscaler", "history", "forecast"])
    addr = f"127.0.0.1:{srv.port}"
    steps = doc["sections"]["engines"]["m1"][addr]["engine"]
    assert steps["steps"] and "pipeline" in doc["sections"]["engines"]["m1"][addr]
    assert any(n.startswith(f"fleet.m1.{addr}.") for n in doc["sections"]["history"]["series"])
    assert doc["sections"]["endpoints"]["models"]["m1"][0]["address"] == addr
    assert "lead_seconds" in doc["sections"]["forecast"]
    assert treport.render_incident(doc) == jreport.render_incident(doc)


def test_manager_serves_and_isolates_its_rings(obs_dirs, monkeypatch, tmp_path):
    from kubeai_tpu_torch.config.system import System
    from kubeai_tpu_torch.manager import Manager
    from kubeai_tpu_torch.obs import canary, history as hist

    monkeypatch.setenv("KUBEAI_CANARY", "0")
    monkeypatch.setenv("KUBEAI_INCIDENT_SETTLE", "0")
    # The default directories resolve through the temporary directory:
    # this test's own, which no other process writes.
    own_tmp = tmp_path / "tempdir"
    own_tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(own_tmp))
    defaults = [os.path.join(own_tmp, n) for n in ("kubeai-history", "kubeai-incidents")]
    # No loop ticks within the test: an SLO tick would leave its gauges in
    # the process's registry for the next test file on this worker.
    system = System()
    system.autoscaling.interval_seconds = 60.0
    mgr = Manager(system, host="127.0.0.1", port=0)
    mgr.start()
    try:
        deadline = time.monotonic() + 10
        while not mgr.election.is_leader.is_set():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        iid = ti.publish_trigger("breaker_ejection", model="m1")
        assert iid and mgr.incidents.wait_idle(10)
        code, listing = _get(mgr.api.port, "/debug/incidents")
        assert code == 200 and listing["active"] and listing["incidents"][0]["id"] == iid
        assert listing["incident_dir"] == obs_dirs["incidents"]
        code, doc = _get(mgr.api.port, f"/debug/incidents?id={iid}")
        assert code == 200 and {"endpoints", "history", "forecast", "autoscaler",
                                "engines"} <= set(doc["sections"])
        code, fc = _get(mgr.api.port, "/debug/forecast")
        assert code == 200 and fc["active"] and fc["lead_seconds"] > 0
        code, index = _get(mgr.api.port, "/debug")
        assert {"/debug/incidents", "/debug/forecast"} <= {e["path"] for e in index["endpoints"]}
        assert _get(mgr.api.port, "/debug/history")[0] == 200
    finally:
        mgr.stop()
    assert ti.installed_recorder() is None and tf.installed_forecaster() is None
    assert hist.installed_history() is None and canary._prober is None
    assert os.listdir(obs_dirs["incidents"]) == [f"incident-{iid}.json"]
    assert any(f.startswith("history-")
               for f in os.listdir(os.path.join(obs_dirs["history"], "operator")))
    assert not [(d, os.listdir(d)) for d in defaults if os.path.exists(d) and os.listdir(d)]
