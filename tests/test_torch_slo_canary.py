"""The port's SLO monitor and canary prober (kubeai_tpu_torch/obs/{slo,
canary}.py) and their routes against the JAX package's, on the CPU; and
the manager's ``--kube`` / ``--local`` arguments.

- ``bucket_quantile``, ``burn_rate``, ``attainment_block`` and
  ``error_rate_block`` equal JAX's on hypothesis' inputs; the history
  sampler uses the SLO module's ``bucket_quantile`` (one definition).
- A seeded script of engine pages (each package parses the same
  Prometheus text) and local observations, ticked under one injected
  clock: every ``SLOMonitor.report()``, the ``kubeai_slo_*`` gauges and
  the ``slo_burn`` triggers equal JAX's, through the leader gate (not
  leading, taking the lease, losing it).
- A scripted ``CanaryProber`` over a stub proxy, balancer and model
  client: the probe records, reports, ``kubeai_canary_probes_total`` and
  the ``canary_*`` triggers equal JAX's through ok, a skipped model with
  no endpoints, corrupt, a redeploy that drops the fingerprint, an
  upstream error, a truncated stream, a raising proxy, two models at once,
  ``reset_fingerprint`` and a deleted model.
- ``GET /debug/slo`` and ``GET /debug/canary`` on each package's
  ``OpenAIServer`` answer 200 with equal bodies, and the port's
  ``/debug`` index lists them; without a monitor or prober both 404.
- ``manager.main``: ``--kube-api-server`` gives a KubeStore on that URL,
  ``--kube`` follows KUBERNETES_SERVICE_HOST, ``--local`` overrides
  either with JAX's warning, as the JAX main does; and ``python -m
  kubeai_tpu_torch.manager --kube-api-server URL`` takes the lease on an
  apiserver stand-in and drains on SIGTERM.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
from _torch_operator import obs_dirs  # noqa: F401  (autouse)
from hypothesis import given, settings
from hypothesis import strategies as st


PKGS = ("kubeai_tpu", "kubeai_tpu_torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    if pkg == "kubeai_tpu" and name == "metrics":
        name = "metrics.registry"
    return importlib.import_module(f"{pkg}.{name}")


jslo, tslo = _mod("kubeai_tpu", "obs.slo"), _mod("kubeai_tpu_torch", "obs.slo")


# ---------------------------------------------------------------------------
# The helpers

BOUNDS = st.lists(st.floats(0.001, 100, allow_nan=False), min_size=1, max_size=12,
                  unique=True).map(sorted)


@settings(max_examples=150, deadline=None)
@given(BOUNDS, st.data(), st.floats(0, 1))
def test_bucket_quantile_equals_jax(bounds, data, q):
    counts = data.draw(st.lists(st.integers(0, 50), min_size=len(bounds) + 1,
                                max_size=len(bounds) + 1))
    assert tslo.bucket_quantile(bounds, counts, q) == jslo.bucket_quantile(bounds, counts, q)


@settings(max_examples=150, deadline=None)
@given(st.floats(0, 1), st.floats(0, 1))
def test_burn_rate_equals_jax(att, target):
    assert tslo.burn_rate(att, target) == jslo.burn_rate(att, target)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.floats(0, 60, allow_nan=False), max_size=40), st.floats(0.01, 30),
       st.floats(0.5, 0.9999), st.integers(0, 5), st.integers(0, 100))
def test_blocks_equal_jax(values, threshold, target, failures, total):
    assert tslo.attainment_block(values, threshold, target, failures) == \
        jslo.attainment_block(values, threshold, target, failures)
    assert tslo.error_rate_block(min(failures, total), total, target) == \
        jslo.error_rate_block(min(failures, total), total, target)


def test_history_shares_the_quantile():
    from kubeai_tpu_torch.obs import history

    assert history.bucket_quantile is tslo.bucket_quantile


# ---------------------------------------------------------------------------
# The SLO monitor

class _Recorder:
    """An incident recorder: the triggers published to it."""

    def __init__(self):
        self.triggers = []

    def publish(self, trigger, model="", detail=None, key=""):
        self.triggers.append((trigger, model, detail, key))
        return None


class _Election:
    def __init__(self, leading):
        self.is_leader = threading.Event()
        if leading:
            self.is_leader.set()


def _engine_page(rng, reg_mod, state):
    """A /metrics page of an engine whose cumulative metrics grow by a
    seeded step each call (*state* keeps the registry)."""
    reg = state.setdefault("reg", reg_mod.Registry())
    ttft = reg.histogram("kubeai_engine_ttft_seconds", "", buckets=(0.1, 0.5, 1, 2, 5))
    e2e = reg.histogram("kubeai_request_e2e_seconds", "", buckets=(1, 5, 10, 30, 60))
    reqs = reg.counter("kubeai_engine_requests_total", "")
    wait = reg.histogram("kubeai_qos_queue_wait_seconds", "", buckets=(0.1, 0.5, 2, 30))
    for _ in range(int(rng.integers(0, 30))):
        slow = rng.random() < state["slow"]
        ttft.observe(float(rng.uniform(2.5, 9) if slow else rng.uniform(0.01, 1.5)))
        outcome = "error" if rng.random() < state["errors"] else "ok"
        e2e.observe(float(rng.uniform(0.5, 70 if slow else 20)), labels={"outcome": outcome})
        reqs.inc(labels={"outcome": outcome})
        wait.observe(float(rng.uniform(0, 3)),
                     labels={"class": str(rng.choice(["interactive", "standard", "batch"]))})
    return reg.render()


def _slo_script(seed):
    """[(what, value)]: page growth, clock steps, leadership flips."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(24):
        steps.append(("dt", float(rng.choice([1.0, 2.5, 10.0]))))
        steps.append(("mix", (float(rng.choice([0.0, 0.05, 0.6])),
                              float(rng.choice([0.0, 0.01, 0.4])))))
        if i in (6, 14):
            steps.append(("lead", False))
        if i in (9, 17):
            steps.append(("lead", True))
        steps.append(("tick", None))
    return steps


def _run_slo(pkg, seed, monkeypatch):
    reg_mod = _mod(pkg, "metrics")
    slo = _mod(pkg, "obs.slo")
    incidents = _mod(pkg, "obs.incidents")
    rec = _Recorder()
    monkeypatch.setattr(incidents, "_recorder", rec)
    monkeypatch.setenv("KUBEAI_SLO_TRIGGER_MIN", "5")
    rng = np.random.default_rng(seed)
    now = [100.0]
    pages, state = [], {"slow": 0.0, "errors": 0.0}
    local = reg_mod.Registry()
    local_ttft = local.histogram("kubeai_engine_ttft_seconds", "", buckets=(0.05, 0.25, 2.5))
    election = _Election(leading=False)
    mon = slo.SLOMonitor(registry=local, window_seconds=30.0, interval_seconds=1.0,
                         clock=lambda: now[0], remote_pages=lambda: pages, election=election)
    parse = reg_mod.parse_prometheus_text
    out = [mon.report()]
    for what, value in _slo_script(seed):
        if what == "dt":
            now[0] += value
        elif what == "mix":
            state["slow"], state["errors"] = value
            pages[:] = [parse(_engine_page(rng, reg_mod, state))]
            local_ttft.observe(float(rng.uniform(0, 3)))
        elif what == "lead":
            if value:
                election.is_leader.set()
            else:
                election.is_leader.clear()
        else:
            mon._gated_tick()
            gauges = {name: sorted(_mod(pkg, "metrics").default_registry.get(name)
                                   .snapshot().items())
                      for name in ("kubeai_slo_attainment", "kubeai_slo_burn_rate",
                                   "kubeai_slo_window_requests")}
            out.append((mon.report(), gauges))
    return out, rec.triggers


@pytest.mark.parametrize("seed", range(4))
def test_slo_monitor_equals_jax(seed, monkeypatch):
    got = {pkg: _run_slo(pkg, seed, monkeypatch) for pkg in PKGS}
    assert got["kubeai_tpu_torch"] == got["kubeai_tpu"]
    reports, triggers = got["kubeai_tpu_torch"]
    # The script reaches every state: pending, inactive, live numbers, burns.
    assert any(not r["active"] for r, _ in reports[1:])
    assert any(o.get("requests", 0) > 0 for r, _ in reports[1:] for o in r["objectives"])
    if seed:
        assert triggers and all(t[0] == "slo_burn" for t in triggers)


# ---------------------------------------------------------------------------
# The canary

class _Result:
    def __init__(self, status, chunks, fail_at=None):
        self.status, self.headers = status, []
        self._chunks, self._fail_at = chunks, fail_at
        self.body_iter = self._iter()

    def _iter(self):
        for i, c in enumerate(self._chunks):
            if i == self._fail_at:
                raise ConnectionResetError("upstream reset")
            yield c


def _sse(text, done=True):
    out = [f'data: {json.dumps({"choices": [{"text": ch, "index": 0}]})}\n\n'.encode()
           for ch in text]
    out.append(b'data: {"choices": [{"text": "", "finish_reason": "length"}]}\n\n')
    if done:
        out.append(b"data: [DONE]\n\n")
    return out


class _Proxy:
    """A ModelProxy stand-in: each model answers as ``mode[model]`` says."""

    def __init__(self):
        self.mode, self.requests = {}, []

    def handle(self, body, path, headers, cancelled=None):
        doc = json.loads(body)
        self.requests.append((path, doc, dict(headers)))
        mode = self.mode[doc["model"]]
        if mode == "raise":
            raise RuntimeError("no endpoint answered")
        if mode == "503":
            return _Result(503, [b'{"error": "busy"}'])
        if mode == "truncated":
            return _Result(200, _sse("1 2 3", done=False))
        return _Result(200, _sse(mode))


class _LB:
    def __init__(self):
        self.endpoints = {}

    def get_all_addresses(self, model):
        return list(self.endpoints.get(model, []))


class _Client:
    def __init__(self, pkg):
        self.mt, self.store, self.models = _mod(pkg, "api.model_types"), \
            _mod(pkg, "runtime.store"), {}

    def set(self, name, uid, args=()):
        self.models[name] = self.mt.Model(
            meta=self.store.ObjectMeta(name=name, uid=uid),
            spec=self.mt.ModelSpec(url="hf://org/m", args=list(args)))

    def list_all_models(self):
        return list(self.models.values())


CANARY_SCRIPT = (
    # (models {name: (uid, endpoints, mode)}, action)
    ({"a": ("u1", 1, " 4 5 6"), "b": ("u2", 0, " x")}, "tick"),
    ({"a": ("u1", 1, " 4 5 7")}, "tick"),         # corrupt
    ({"a": ("u1b", 1, " 4 5 7")}, "tick"),        # a redeploy: a new baseline
    ({"a": ("u1b", 1, "503")}, "tick"),
    ({"a": ("u1b", 1, "truncated")}, "tick"),
    ({"a": ("u1b", 1, "raise")}, "tick"),
    ({"a": ("u1b", 1, " 4 5 7"), "b": ("u2", 1, " y z")}, "tick"),  # two at once
    ({"a": ("u1b", 1, " 8 9")}, "reset:a"),
    ({"a": ("u1b", 1, " 8 9")}, "tick"),
    ({"b": None}, "tick"),                          # b deleted: pruned
)


def _run_canary(pkg, monkeypatch):
    canary = _mod(pkg, "obs.canary")
    rec = _Recorder()
    monkeypatch.setattr(_mod(pkg, "obs.incidents"), "_recorder", rec)
    counter = _mod(pkg, "metrics").default_registry.get("kubeai_canary_probes_total")
    before = dict(counter.snapshot())
    proxy, lb, client = _Proxy(), _LB(), _Client(pkg)
    now = [10.0]

    def clock():
        now[0] += 0.125
        return now[0]

    prober = canary.CanaryProber(proxy, client, lb, interval_seconds=1.0, max_tokens=4,
                                 timeout_seconds=5.0, election=_Election(True), clock=clock,
                                 wall=lambda: 1700000000.0 + now[0], enabled=True)
    out = []
    for models, action in CANARY_SCRIPT:
        for name, spec in models.items():
            if spec is None:
                client.models.pop(name, None)
                continue
            uid, endpoints, mode = spec
            client.set(name, uid)
            lb.endpoints[name] = ["127.0.0.1:1"] * endpoints
            proxy.mode[name] = mode
        if action == "tick":
            prober.tick()
        else:
            prober.reset_fingerprint(action.split(":")[1])
        report = prober.report()
        if sum(1 for name in client.models if lb.get_all_addresses(name)) > 1:
            # Two probes fan out over the scrape pool: which one drew which
            # probe number is the pool's order.
            for r in report["models"].values():
                r["n"] = "-"
        out.append(report)
    probes = {k: v - before.get(k, 0.0) for k, v in counter.snapshot().items()}
    reqs = [(p, d, {k: v for k, v in h.items() if k != "X-Request-ID"})
            for p, d, h in proxy.requests]
    return out, sorted(probes.items()), rec.triggers, sorted(reqs, key=repr)


def test_canary_records_equal_jax(monkeypatch):
    got = {pkg: _run_canary(pkg, monkeypatch) for pkg in PKGS}
    assert got["kubeai_tpu_torch"] == got["kubeai_tpu"]
    reports, probes, triggers, _ = got["kubeai_tpu_torch"]
    outcomes = [r["models"].get("a", {}).get("outcome") for r in reports]
    assert outcomes == ["ok", "corrupt", "ok", "error", "error", "error", "ok", "ok", "ok", "ok"]
    assert [r["models"].get("b", {}).get("outcome") for r in reports] == \
        ["skipped"] * 6 + ["ok"] * 3 + [None]
    assert "b" not in reports[-1]["models"]
    assert dict(probes) == {(("outcome", "corrupt"),): 1.0, (("outcome", "error"),): 3.0,
                            (("outcome", "ok"),): 7.0}
    assert [t[0] for t in triggers] == ["canary_corrupt"] + ["canary_error"] * 3


# ---------------------------------------------------------------------------
# The routes

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _server(pkg):
    """An OpenAIServer over stubs, with an SLO monitor and a canary prober
    that each ran a few scripted ticks."""
    srv_mod = _mod(pkg, "proxy.server")
    proxy, lb, client = _Proxy(), _LB(), _Client(pkg)
    proxy.lb = lb
    srv = srv_mod.OpenAIServer(proxy, client, host="127.0.0.1", port=0)
    return srv, proxy, lb, client


def test_debug_routes_equal_jax(monkeypatch):
    bodies = {}
    for pkg in PKGS:
        canary = _mod(pkg, "obs.canary")
        monkeypatch.setattr(_mod(pkg, "obs.incidents"), "_recorder", _Recorder())
        srv, proxy, lb, client = _server(pkg)
        srv.start()
        try:
            none = (_get(srv.port, "/debug/slo"), _get(srv.port, "/debug/canary"))
            now = [50.0]
            rng = np.random.default_rng(3)
            pages = []
            reg_mod = _mod(pkg, "metrics")
            srv.slo = _mod(pkg, "obs.slo").SLOMonitor(
                registry=reg_mod.Registry(), window_seconds=60.0, clock=lambda: now[0],
                remote_pages=lambda: pages)
            state = {"slow": 0.2, "errors": 0.1}
            for _ in range(3):
                now[0] += 5
                pages[:] = [reg_mod.parse_prometheus_text(_engine_page(rng, reg_mod, state))]
                srv.slo.tick()
            client.set("a", "u1")
            lb.endpoints["a"] = ["127.0.0.1:1"]
            proxy.mode["a"] = " 1 2"
            prober = canary.CanaryProber(proxy, client, lb, interval_seconds=2.0,
                                         clock=lambda: now[0], wall=lambda: now[0],
                                         enabled=True)
            canary.install_canary(prober)
            try:
                prober.tick()
                bodies[pkg] = (none, _get(srv.port, "/debug/slo"),
                               _get(srv.port, "/debug/canary"))
            finally:
                canary.uninstall_canary(prober)
            if pkg == "kubeai_tpu_torch":
                code, index = _get(srv.port, "/debug")
                paths = [e["path"] for e in index["endpoints"]]
                assert code == 200 and {"/debug/slo", "/debug/canary", "/debug/incidents",
                                        "/debug/forecast"} <= set(paths)
                # The proxy answers both once a recorder and a forecaster
                # are installed.
                incidents, forecast = _mod(pkg, "obs.incidents"), _mod(pkg, "obs.forecast")
                fake = incidents._recorder
                incidents._recorder = incidents.IncidentRecorder(incident_dir="")
                forecaster = forecast.Forecaster(
                    _mod(pkg, "obs.history").HistoryStore(history_dir=""))
                forecast.install_forecaster(forecaster)
                try:
                    for p in ("/debug/incidents", "/debug/forecast"):
                        assert _get(srv.port, p)[0] == 200
                finally:
                    incidents._recorder = fake
                    forecast.uninstall_forecaster(forecaster)
        finally:
            srv.stop()
    assert bodies["kubeai_tpu_torch"] == bodies["kubeai_tpu"]
    (slo404, canary404), (code_s, slo), (code_c, report) = bodies["kubeai_tpu_torch"]
    assert slo404[0] == canary404[0] == 404 and code_s == code_c == 200
    assert [o["name"] for o in slo["objectives"]][:3] == ["ttft", "e2e", "error_rate"]
    assert report["models"]["a"]["outcome"] == "ok"


# ---------------------------------------------------------------------------
# manager.main

class _Started(Exception):
    pass


def _main_args(pkg, argv, monkeypatch, env=None):
    """(store kind and URL, local_runtime, warnings) that *pkg*'s main
    builds its Manager with for *argv*."""
    mgr_mod = _mod(pkg, "manager")
    seen, warnings = {}, []

    class Manager:
        def __init__(self, system, store=None, local_runtime=False, host="", port=0):
            seen.update(store=(type(store).__name__, getattr(store, "base", None)),
                        local_runtime=local_runtime)

        def start(self):
            raise _Started

    monkeypatch.setattr(mgr_mod, "Manager", Manager)
    monkeypatch.setattr(mgr_mod, "setup_logging", lambda *a, **k: None)
    monkeypatch.setattr(mgr_mod, "log", types.SimpleNamespace(
        warning=lambda msg, *a: warnings.append(msg % a if a else msg),
        info=lambda *a, **k: None))
    for k in ("KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(_Started):
        mgr_mod.main(argv)
    return seen, warnings


@pytest.mark.parametrize("argv,env", [
    (["--kube-api-server", "http://127.0.0.1:6443"], None),
    (["--kube"], None),
    ([], {"KUBERNETES_SERVICE_HOST": "10.0.0.1", "KUBERNETES_SERVICE_PORT": "443"}),
    (["--local", "--kube-api-server", "http://127.0.0.1:6443"], None),
    (["--local"], {"KUBERNETES_SERVICE_HOST": "10.0.0.1"}),
    (["--local"], None),
    ([], None),
])
def test_main_arguments_equal_jax(argv, env, monkeypatch):
    got = {pkg: _main_args(pkg, argv, monkeypatch, env) for pkg in PKGS}
    assert got["kubeai_tpu_torch"] == got["kubeai_tpu"]
    (seen, warnings) = got["kubeai_tpu_torch"]
    kube = "--kube-api-server" in argv or "--kube" in argv or env and \
        "KUBERNETES_SERVICE_HOST" in env
    if "--local" in argv:
        assert seen == {"store": ("NoneType", None), "local_runtime": True}
        assert warnings == (["--local overrides --kube: pods run as local processes on the "
                             "in-memory store"] if kube else [])
    elif kube:
        assert seen["store"][0] == "KubeStore" and not seen["local_runtime"] and not warnings
        if "--kube-api-server" in argv:
            assert seen["store"][1] == "http://127.0.0.1:6443"
    else:
        assert seen == {"store": ("NoneType", None), "local_runtime": False}


def test_manager_cli_takes_the_lease_on_an_apiserver(tmp_path):
    from kubeai_tpu_torch.tools.kube_standin import APIServer

    api = APIServer()
    env = {**os.environ, "PYTHONPATH": ROOT, "KUBEAI_HISTORY_DIR": str(tmp_path),
           "KUBEAI_INCIDENT_DIR": str(tmp_path / "incidents"), "KUBEAI_CANARY": "0"}
    env.pop("KUBERNETES_SERVICE_HOST", None)
    out = open(tmp_path / "manager.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeai_tpu_torch.manager", "--kube-api-server", api.url,
         "--host", "127.0.0.1", "--port", "0", "--drain-grace", "0.2"],
        stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    out.close()
    try:
        deadline = time.time() + 60
        # The lease taken, and the watches open (each lists first).
        while api.get("leases", "kubeai-tpu.kubeai.org") is None or \
                not api.requests["watch"] or not api.requests["list"]:
            assert proc.poll() is None, (tmp_path / "manager.log").read_text()[-3000:]
            assert time.time() < deadline, f"the operator took no lease: {api.requests}"
            time.sleep(0.05)
        lease = api.get("leases", "kubeai-tpu.kubeai.org")
        assert lease["spec"]["holderIdentity"].startswith("kubeai-")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, (tmp_path / "manager.log").read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        api.stop()
    # The drain released the lease.
    assert api.get("leases", "kubeai-tpu.kubeai.org")["spec"].get("holderIdentity", "") == ""
