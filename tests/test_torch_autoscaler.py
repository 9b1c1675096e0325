"""The port's control loops' signals and decisions (kubeai_tpu_torch/
autoscaler, disagg/signals.py, metrics.parse_prometheus_text) against the
JAX package's, on the CPU.

- The cases of tests/test_movingaverage.py, test_autoscaler.py,
  test_autoscaler_signal.py and the signal, fleet-role and per-pool
  autoscaling cases of test_disagg.py run on both packages
  (``run_jax_case_both``: the JAX test file, then its port clone).
"""

import pytest

import test_autoscaler as jtest_autoscaler
import test_autoscaler_signal as jtest_autoscaler_signal
import test_disagg as jtest_disagg
import test_movingaverage as jtest_movingaverage
from _torch_operator import jax_cases, obs_dirs, run_jax_case_both  # noqa: F401  (obs_dirs: autouse)
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def no_canary(monkeypatch):
    # A Manager's canary probes would land in the windows these tests
    # count requests and launches in: off, as before the port had one.
    monkeypatch.setenv("KUBEAI_CANARY", "0")

DISAGG_CLASSES = ("TestSignals", "TestFleetRoles", "TestPerPoolAutoscaling")

CASES = (
    jax_cases(jtest_movingaverage)
    + jax_cases(jtest_autoscaler)
    + jax_cases(jtest_autoscaler_signal)
    + [c for c in jax_cases(jtest_disagg) if c.values[1].split(".")[0] in DISAGG_CLASSES]
)


@pytest.mark.parametrize("module,qual,params", CASES)
def test_jax_cases_on_both_packages(module, qual, params, request, monkeypatch):
    run_jax_case_both(module, qual, params, request, monkeypatch)


# ---------------------------------------------------------------------------
# Scripted ticks on both packages

from kubeai_tpu.api import model_types as jmt  # noqa: E402
from kubeai_tpu.autoscaler import autoscaler as jasc  # noqa: E402
from kubeai_tpu.autoscaler import fleet as jfleet  # noqa: E402
from kubeai_tpu.autoscaler import leader as jleader  # noqa: E402
from kubeai_tpu.obs import incidents as jincidents  # noqa: E402
from kubeai_tpu.proxy import modelclient as jmc  # noqa: E402
from kubeai_tpu.runtime import store as js  # noqa: E402
from kubeai_tpu_torch.api import model_types as tmt  # noqa: E402
from kubeai_tpu_torch.autoscaler import autoscaler as tasc  # noqa: E402
from kubeai_tpu_torch.autoscaler import fleet as tfleet  # noqa: E402
from kubeai_tpu_torch.autoscaler import leader as tleader  # noqa: E402
from kubeai_tpu_torch.obs import incidents as tincidents  # noqa: E402
from kubeai_tpu_torch.proxy import modelclient as tmc  # noqa: E402
from kubeai_tpu_torch.runtime import store as ts  # noqa: E402

import json  # noqa: E402
import threading  # noqa: E402

from _torch_operator import plain  # noqa: E402

PKGS = {
    "jax": (jmt, jasc, jfleet, jleader, jincidents, jmc, js),
    "port": (tmt, tasc, tfleet, tleader, tincidents, tmc, ts),
}


def page(q=0, a=0, st=8, pu=0, pt=100, gen=0, ttft=(0.0, 0), qos=None):
    """An engine /metrics page with the series the fleet collector reads."""
    lines = [f"kubeai_engine_queue_depth {q}", f"kubeai_engine_active_slots {a}",
             f"kubeai_engine_slots_total {st}", f"kubeai_engine_kv_pages_used {pu}",
             f"kubeai_engine_kv_pages_cached {pu // 2}", f"kubeai_engine_kv_pages_total {pt}",
             f"kubeai_engine_generated_tokens_total {gen}",
             f"kubeai_engine_ttft_seconds_sum {ttft[0]}",
             f"kubeai_engine_ttft_seconds_count {ttft[1]}",
             "kubeai_engine_prefix_lookup_tokens_total 40",
             "kubeai_engine_prefix_cached_tokens_total 10"]
    lines += [f'kubeai_qos_queue_depth{{class="{c}"}} {v}' for c, v in (qos or {}).items()]
    return "\n".join(lines) + "\n"


def actives(**per_model):
    """An operator peer's /metrics page: the active-requests gauge."""
    return "".join(
        f'kubeai_inference_requests_active{{request_model="{m}",request_type="http"}} {n}\n'
        for m, n in per_model.items())


class World:
    """What the stubbed clients see on a tick: the operator peers' pages,
    the engine pages and each model's endpoints (address -> role). An
    Exception in place of a page is a failed scrape."""

    def __init__(self):
        self.peers, self.pages, self.endpoints = {}, {}, {}

    @staticmethod
    def _answer(v):
        if isinstance(v, Exception):
            raise v
        return v

    def fetch_peer(self, addr, timeout):
        return self._answer(self.peers[addr])

    def fetch_page(self, addr):
        return self._answer(self.pages[addr])


class StubLB:
    def __init__(self, world):
        self.world = world
        self.latency = []

    def get_self_ips(self):
        return []

    def get_all_addresses(self, model):
        return sorted(self.world.endpoints.get(model, {}))

    def get_endpoint_roles(self, model):
        return dict(self.world.endpoints.get(model, {}))

    def observe_latency(self, model, addr, seconds, count=1):
        self.latency.append((model, addr, round(seconds, 9), count))

    def breaker_snapshot(self):
        return {m: [{"address": a, "state": "closed"} for a in sorted(eps)]
                for m, eps in self.world.endpoints.items()}


class Leader:
    def __init__(self):
        self.is_leader = threading.Event()
        self.is_leader.set()


class TriggerLog:
    """A recorder on the incident seam: the triggers published."""

    def __init__(self):
        self.got = []

    def publish(self, trigger, model="", detail=None, key=""):
        self.got.append((trigger, model, detail, key))


class TickSide:
    def __init__(self, pkg, world, monkeypatch, window, required):
        (self.mt, self.asc_mod, self.fleet_mod, _, inc, mc_mod, st) = PKGS[pkg]
        self.pkg, self.world, self.window = pkg, world, window
        monkeypatch.setattr(self.asc_mod, "_fetch_metrics_text", world.fetch_peer)
        self.triggers = TriggerLog()
        inc.install_recorder(self.triggers)
        self.uninstall = lambda: inc.uninstall_recorder(self.triggers)
        self.store_mod, self.store = st, st.Store()
        self.mc = mc_mod.ModelClient(self.store, required_consecutive_scale_downs=lambda m: required)
        self.lb = StubLB(world)
        self.now = [1000.0]
        self.asc = self.new_autoscaler()

    def new_autoscaler(self):
        fleet = self.fleet_mod.FleetCollector(self.lb, clock=lambda: self.now[0],
                                              fetch=self.world.fetch_page)
        return self.asc_mod.Autoscaler(
            self.store, self.mc, self.lb, Leader(), average_window_count=self.window,
            fixed_self_metric_addrs=sorted(self.world.peers), fleet=fleet,
            clock=lambda: self.now[0])

    def model(self, name, **kw):
        kw.setdefault("url", "hf://org/model")
        kw.setdefault("resource_profile", "cpu:1")
        if "disaggregation" in kw:
            kw["disaggregation"] = self.mt.Disaggregation(**kw["disaggregation"])
        self.store.create(self.mt.KIND_MODEL, self.mt.Model(
            meta=self.store_mod.ObjectMeta(name=name), spec=self.mt.ModelSpec(**kw)))

    def state(self):
        """The Models' replicas and every decision record, timestamps
        masked, and the triggers published."""
        models = {m.meta.name: (m.spec.replicas, plain(m.spec.disaggregation))
                  for m in self.store.list(self.mt.KIND_MODEL)}
        decisions = [{**r, "t": None} for r in self.asc.decisions.snapshot()]
        return json.loads(json.dumps({"models": models, "decisions": decisions,
                                      "triggers": self.triggers.got}, default=str))


DZ = {"enabled": True, "handoff_tokens": 3, "prefill_target_queue": 4,
      "decode_target_occupancy_pct": 80}
DOWN = ConnectionError("connection refused")

# Each scenario: (models, window, required consecutive scale-downs, steps).
# A step is a dict of the world's changes for one tick, or "restart" (a
# fresh Autoscaler on the same store loads the saved averages).
TICK_SCENARIOS = {
    "scale_up": ([("m1", {"replicas": 1, "target_requests": 2, "max_replicas": 10})], 3, 2, [
        {"peers": {"p1:1": actives(m1=6), "p2:1": actives(m1=6)}}, {}, {}, {}]),
    "scale_down_after_consecutive": (
        [("m1", {"replicas": 4, "target_requests": 2, "min_replicas": 1})], 1, 2, [
            {"peers": {"p1:1": actives(m1=3)}}, {"peers": {"p1:1": actives()}}, {}, {}, {},
            {"peers": {"p1:1": actives(m1=1)}}, {}]),
    "scale_to_zero": ([("m1", {"replicas": 2, "target_requests": 2, "min_replicas": 0})], 2, 3, [
        {"peers": {"p1:1": actives(m1=2)}}, {"peers": {"p1:1": actives()}}, {}, {}, {}, {}]),
    "bounds": ([("m1", {"replicas": 2, "target_requests": 1, "min_replicas": 2,
                        "max_replicas": 3})], 1, 1, [
        {"peers": {"p1:1": actives(m1=10)}}, {}, {"peers": {"p1:1": actives()}}, {}]),
    "engine_signal_and_scrape_failures": (
        [("m1", {"replicas": 1, "target_requests": 2}),
         ("off", {"replicas": 3, "autoscaling_disabled": True})], 2, 2, [
            {"peers": {"p1:1": actives(m1=2), "p2:1": DOWN},
             "endpoints": {"m1": {"e1:1": "", "e2:1": ""}, "off": {"e3:1": ""}},
             "pages": {"e1:1": page(q=5, a=3), "e2:1": DOWN, "e3:1": page(a=1)}},
            {"pages": {"e2:1": page(a=2, gen=50)}},
            {"peers": {"p2:1": actives(m1=1)}, "pages": {"e1:1": DOWN}}, {}]),
    "state_saved_and_loaded": ([("m1", {"replicas": 1, "target_requests": 2}),
                                ("m2", {"replicas": 1, "target_requests": 1})], 4, 2, [
        {"peers": {"p1:1": actives(m1=8, m2=3)}}, {}, "restart",
        {"peers": {"p1:1": actives(m1=2)}}, {}]),
    "disaggregated_pools": ([("dz", {"disaggregation": DZ})], 2, 2, [
        {"peers": {"p1:1": actives(dz=4)},
         "endpoints": {"dz": {"pf:1": "prefill", "dc:1": "decode"}},
         "pages": {"pf:1": page(q=9, a=1, st=2, pu=4), "dc:1": page(a=8, st=8, pu=50)}},
        {"pages": {"dc:1": page(a=4, st=8, pu=95)}},
        {"endpoints": {"dz": {"pf:1": "prefill", "dc:1": "decode", "dc:2": "decode"}},
         "pages": {"dc:2": page(a=1, st=8, pu=10), "pf:1": page(q=0, a=0, st=2)}},
        {}, {}]),
    "blind_pool_holds": ([("dz", {"disaggregation": DZ})], 1, 1, [
        {"peers": {"p1:1": actives()},
         "endpoints": {"dz": {"pf:1": "prefill", "dc:1": "decode"}},
         "pages": {"pf:1": page(q=2, a=1, st=2), "dc:1": DOWN}},
        {}, {}, {"pages": {"dc:1": page(a=2, st=8, pu=20)}}, {}]),
}


@pytest.mark.parametrize("name", sorted(TICK_SCENARIOS))
def test_scripted_ticks_match_jax(name, monkeypatch):
    models, window, required, steps = TICK_SCENARIOS[name]
    world = World()
    for step in steps:  # every peer the script names, from the start
        if isinstance(step, dict):
            world.peers.update({a: actives() for a in step.get("peers", {})})
    sides = [TickSide(pkg, world, monkeypatch, window, required) for pkg in PKGS]
    try:
        for side in sides:
            for m, kw in models:
                side.model(m, **kw)
        for i, step in enumerate(steps):
            if step == "restart":
                for side in sides:
                    side.asc = side.new_autoscaler()
                continue
            world.peers.update(step.get("peers", {}))
            world.pages.update(step.get("pages", {}))
            world.endpoints.update(step.get("endpoints", {}))
            for side in sides:
                side.now[0] += 1.0
                side.asc.tick()
            j, t = (s.state() for s in sides)
            assert j == t, f"tick {i}"
        assert j["decisions"], "no decision recorded"
        if name == "scale_up":
            assert j["models"]["m1"][0] == 6  # (6 + 6) / 2
        if name == "scale_to_zero":
            assert j["models"]["m1"][0] == 0
        if name == "bounds":
            assert [d["clamped"] for d in reversed(j["decisions"])] == [3, 3, 2, 2]
            assert j["triggers"][0][0] == "autoscaler_clamp"
        if name == "blind_pool_holds":
            assert [tr[0] for tr in j["triggers"]] == ["autoscaler_hold"] * 2
        if name == "state_saved_and_loaded":
            for s in sides:
                saved = s.store.get(s.asc_mod.KIND_STATE, "kubeai-autoscaler-state")
                assert set(saved.averages) == {"m1", "m2"}
    finally:
        for side in sides:
            side.uninstall()


# ---------------------------------------------------------------------------
# Moving averages, leader election, the parser and the fleet view

import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from kubeai_tpu.autoscaler.movingaverage import SimpleMovingAverage as JSMA  # noqa: E402
from kubeai_tpu.metrics import registry as jreg  # noqa: E402
from kubeai_tpu_torch import metrics as tmetrics  # noqa: E402
from kubeai_tpu_torch.autoscaler.movingaverage import SimpleMovingAverage as TSMA  # noqa: E402


@pytest.mark.parametrize("seed", range(3))
def test_moving_average_same_sequence(seed):
    rng = np.random.default_rng(seed)
    seed_vals = [float(x) for x in rng.integers(0, 9, size=int(rng.integers(1, 8)))]
    j, t = JSMA(seed_vals), TSMA(seed_vals)
    for v in rng.exponential(3.0, size=40):
        j.next(float(v))
        t.next(float(v))
        assert j.calculate() == t.calculate() and j.history() == t.history()


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def time(self):
        return self.now

    def sleep(self, s):
        raise AssertionError("the script drives the election by hand")


def test_election_same_holder_at_each_step(monkeypatch):
    """Two candidates per package's store under one script: acquire,
    renew, a rival refused, expiry and take-over, release on stop and
    the rival's acquire."""
    script = [("a", 0), ("b", 1), ("a", 5), ("b", 16), ("b", 21), ("a", 22),
              ("a", 35), ("b", 37), ("a", 38), ("stop_b", 39), ("a", 40), ("b", 41)]
    out = {}
    for pkg, (_, _, _, leader, _, _, st_mod) in PKGS.items():
        clock = FakeClock()
        monkeypatch.setattr(leader, "time", clock)
        store = st_mod.Store()
        cands = {n: leader.Election(store, n, duration=15.0) for n in "ab"}
        steps = []
        for who, at in script:
            clock.now = 100.0 + at
            if who == "stop_b":
                cands["b"].stop()
            else:
                cands[who]._try_acquire_or_renew()
            lease = store.get(leader.KIND_LEASE, "kubeai-tpu.kubeai.org")
            steps.append((who, lease.holder, lease.renew_time,
                          cands["a"].is_leader.is_set(), cands["b"].is_leader.is_set()))
        out[pkg] = steps
    assert out["jax"] == out["port"]
    assert [s[1] for s in out["port"]] == ["a", "a", "a", "a", "b", "b", "b", "b", "b", "",
                                           "a", "a"]


def _port_engine_page():
    """The port engine's /metrics text on the CPU after a few completions
    (fleet series, histograms with their sums and counts, QoS gauges)."""
    import urllib.request

    from kubeai_tpu_torch.engine.core import build_test_engine
    from kubeai_tpu_torch.engine.server import EngineServer

    srv = EngineServer(build_test_engine(device="cpu"), "m", host="127.0.0.1", port=0)
    srv.start()
    try:
        for p in ("hello", "the sea"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=json.dumps({"prompt": p, "max_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=60).read()
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            return r.read().decode()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def port_page():
    return _port_engine_page()


def test_parse_engine_and_registry_pages(port_page):
    jreg.default_registry.histogram("kubeai_test_exemplar_seconds", "h").observe(
        0.2, exemplar="abc")
    pages = [port_page, jreg.default_registry.render(),
             jreg.default_registry.render(exemplars=True)]
    for text in pages:
        assert jreg.parse_prometheus_text(text) == tmetrics.parse_prometheus_text(text)
    parsed = tmetrics.parse_prometheus_text(port_page)
    # Every series the fleet collector reads is spelled as the port
    # engine's page spells it: a sample, or a counter registered with none
    # yet (no prefix hit, no eviction in this run).
    typed = {line.split()[2] for line in port_page.splitlines() if line.startswith("# TYPE ")}
    for name in (tfleet._QUEUE, tfleet._ACTIVE, tfleet._SLOTS_TOTAL, tfleet._PAGES_USED,
                 tfleet._PAGES_CACHED, tfleet._PAGES_TOTAL, tfleet._GEN_TOKENS,
                 tfleet._HBM_USED, tfleet._HBM_LIMIT, tfleet._PREFIX_CACHED,
                 tfleet._PREFIX_LOOKUP, tfleet._CACHED_EVICTIONS, tfleet._TTFT_SUM,
                 tfleet._TTFT_COUNT):
        assert name in parsed or name in typed, name
    assert sum(v for _, v in parsed[tfleet._GEN_TOKENS]) > 0


@settings(max_examples=60, deadline=None)
@given(st.lists(st.text(min_size=0, max_size=12), min_size=1, max_size=3),
       st.floats(allow_nan=False, allow_infinity=False, width=32))
def test_parse_escaped_label_values(values, value):
    labels = {f"l{i}": v for i, v in enumerate(values)}
    g = jreg.Gauge("kubeai_test_labels", "h")
    g.set(value, labels=labels)
    text = "\n".join(g.collect()) + "\n"
    j, t = jreg.parse_prometheus_text(text), tmetrics.parse_prometheus_text(text)
    assert j == t
    # The format escapes only "\n": a value holding another line break
    # (str.splitlines' "\r", "\x85", ...) splits its line in both parsers.
    if all(len(f"x{v}x".replace("\n", "").splitlines()) == 1 for v in values):
        assert t["kubeai_test_labels"] == [(labels, float(value))]
    for v in values:
        assert tmetrics._unescape_label_value(tmetrics._escape_label_value(v)) == v


def test_fleet_collect_and_debug_view_match_jax(port_page):
    world = World()
    world.endpoints = {"m1": {"e1:1": "", "e2:1": "", "e3:1": ""},
                       "dz": {"pf:1": "prefill", "dc:1": "decode"}}
    world.pages = {"e1:1": port_page, "e2:1": page(q=2, a=3, pu=30, gen=100, ttft=(0.5, 2),
                                                   qos={"interactive": 1, "batch": 4}),
                   "e3:1": DOWN, "pf:1": page(q=5, a=1, st=2), "dc:1": page(a=6, pu=90)}
    views = {}
    for pkg, (_, _, fleet_mod, _, _, _, _) in PKGS.items():
        now = [10.0]
        lb = StubLB(world)
        col = fleet_mod.FleetCollector(lb, clock=lambda: now[0], fetch=world.fetch_page,
                                       default_max_age=1.5)
        got = [col.collect(["m1", "dz"])]
        world.pages["e2:1"] = page(q=0, a=1, pu=10, gen=160, ttft=(0.9, 4))
        now[0] = 12.0
        got.append(col.debug_view(["m1", "dz"]))  # stale: collects again
        now[0] = 12.5
        got.append(col.debug_view(["m1"]))  # fresh: the last collect
        got.append(col.scrape_model("dz"))
        got.append(lb.latency)
        got.append(sorted(col.parsed_pages_by_addr()))
        views[pkg] = json.loads(json.dumps(got, default=str))
        world.pages["e2:1"] = page(q=2, a=3, pu=30, gen=100, ttft=(0.5, 2),
                                   qos={"interactive": 1, "batch": 4})
    assert views["jax"] == views["port"]
    m1 = views["port"][1]["models"]["m1"]
    assert m1["aggregate"]["endpoints"] == 2 and m1["aggregate"]["failed_endpoints"] == 1
    assert [e["tokens_per_second"] for e in m1["endpoints"] if e["address"] == "e2:1"] == [30.0]
    assert views["port"][4] == [["m1", "e2:1", 0.2, 2]]


def test_manager_wires_the_loops():
    """The port's Manager builds the election, the fleet collector, the
    autoscaler (its engine signal the collector's), the three reconcilers'
    hooks and the parked pool, the decision log shared with the pool and
    the API, the SLO monitor over the fleet's pages and the canary prober
    over the proxy (both behind the election), the history store under
    <KUBEAI_HISTORY_DIR>/operator fed by its sampler and the fleet, the
    forecaster over it (the autoscaler's), the incident recorder over the
    fleet's pages by address, each installed, and one messenger per
    stream over its own model client and balancer."""
    import os

    from kubeai_tpu_torch.config.system import MessageStream, System
    from kubeai_tpu_torch.manager import Manager
    from kubeai_tpu_torch.obs import canary as canary_mod
    from kubeai_tpu_torch.obs import forecast as forecast_mod
    from kubeai_tpu_torch.obs import history as history_mod
    from kubeai_tpu_torch.obs import incidents as incidents_mod

    def uninstall(mgr):
        # Never started, so never stopped: uninstall its installs here.
        canary_mod.uninstall_canary(mgr.canary)
        incidents_mod.uninstall_recorder(mgr.incidents)
        forecast_mod.uninstall_forecaster(mgr.forecaster)
        history_mod.uninstall_history(mgr.history)

    system = System()
    system.parked_replicas = 1
    mgr = Manager(system, store=ts.Store(), port=0)
    try:
        assert mgr.autoscaler.engine_queue_scrape == mgr.fleet.scrape_model
        assert mgr.autoscaler.fleet is mgr.fleet and mgr.autoscaler.election is mgr.election
        assert mgr.reconciler.cache_reconciler is mgr.cache_reconciler
        assert mgr.reconciler.adapter_reconciler is mgr.adapter_reconciler
        assert mgr.reconciler.parked_pool is mgr.parked_pool is mgr.autoscaler.parked_pool
        assert mgr.parked_pool.decision_log is mgr.autoscaler.decisions is mgr.api.decision_log
        assert mgr.api.fleet is mgr.fleet and mgr.api.election is mgr.election
        assert mgr.api.slo is mgr.slo and mgr.autoscaler.forecaster is mgr.forecaster
        assert mgr.history.history_dir == os.path.join(os.environ["KUBEAI_HISTORY_DIR"],
                                                       "operator")
        assert mgr.history_sampler.store is mgr.history is mgr.fleet.history
        assert mgr.history_sampler._election is mgr.election
        assert mgr.forecaster.history is mgr.history and mgr.forecaster.election is mgr.election
        assert mgr.forecaster.decision_log is mgr.autoscaler.decisions
        assert mgr.incidents._remote_pages == mgr.fleet.parsed_pages_by_addr
        assert mgr.incidents._election is mgr.election
        assert mgr.incidents.incident_dir == os.environ["KUBEAI_INCIDENT_DIR"]
        assert {"endpoints", "engines", "history", "forecast", "autoscaler", "fleet", "slo",
                "canary", "logs"} <= set(mgr.incidents._sources)
        assert incidents_mod.installed_recorder() is mgr.incidents
        assert forecast_mod.installed_forecaster() is mgr.forecaster
        assert history_mod.installed_history() is mgr.history
        assert mgr.slo._remote_pages == mgr.fleet.parsed_pages
        assert mgr.slo._election is mgr.election and mgr.canary._election is mgr.election
        assert (mgr.canary.proxy, mgr.canary.model_client, mgr.canary.lb) == \
            (mgr.proxy, mgr.model_client, mgr.lb)
        assert canary_mod._prober is mgr.canary
        assert mgr.fleet.default_max_age == 1.5 * system.autoscaling.interval_seconds
    finally:
        mgr.api.httpd.server_close()
        uninstall(mgr)
    assert mgr.messengers == []
    system = System()
    system.streams = [MessageStream(requests_url="mem://a", responses_url="mem://b"),
                      MessageStream(requests_url="file:///q/req", responses_url="file:///q/resp",
                                    max_handlers=4)]
    system.messaging_error_max_backoff_seconds = 3.0
    mgr = Manager(system, store=ts.Store(), port=0)
    try:
        assert [(m.requests_url, m.responses_url, m.max_handlers, m.error_max_backoff)
                for m in mgr.messengers] == [("mem://a", "mem://b", 1, 3.0),
                                             ("file:///q/req", "file:///q/resp", 4, 3.0)]
        assert all(m.model_client is mgr.model_client and m.lb is mgr.lb
                   for m in mgr.messengers)
    finally:
        mgr.api.httpd.server_close()
        uninstall(mgr)
        canary_mod.uninstall_canary(mgr.canary)
