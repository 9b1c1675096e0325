"""The port's KubeStore (kubeai_tpu_torch/runtime/k8s.py) against the JAX
package's, on the CPU, over tests/test_kubestore.py's FakeAPIServer.

- Scripted scenarios (CRUD, the status subresource, a conflict and
  mutate's retry, every kind of the table, the Lease, the AutoscalerState
  record, two elections on one lease under one clock, a watch resumed
  after a drop, a watch relisted after a 410) run on the JAX store over
  one fake and on the port's over another. Every request each store
  sends (method, path, JSON body, its Authorization and Content-Type) is
  recorded: the two sequences must be equal, the watch streams' requests
  apart from the rest (they come from other threads), and so must the
  objects, errors and watch events each store returns.
- The same scripts on the port's store over the apiserver stand-in of
  ``kubeai_tpu_torch/tools/kube_standin.py`` return the same objects as
  over the fake (uids and creation times apart).
- The test file's own cases run on both packages (its clone).
- A JAX Manager and a port Manager, each over its own fake, reconcile
  the same Model into the same objects (Model, Pod manifest, Lease,
  AutoscalerState record), and each proxies a request to a stub engine
  once the pod reads Ready; the port's Manager does the same over the
  stand-in with its kubelet writing the status.
"""

import importlib
import json
import queue
import threading
import time
import types
import urllib.request

import pytest

import test_kubestore as jtest_kubestore
from _torch_operator import jax_cases, obs_dirs, plain, port_clone, run_jax_case_both  # noqa: F401
from test_kubestore import FakeAPIServer
from test_proxy_integration import FakeEngine

from kubeai_tpu_torch.tools import kube_standin

PKGS = ("kubeai_tpu", "kubeai_tpu_torch")
# Unrecorded: another client's writes in a scenario.
_URLOPEN = urllib.request.urlopen
_STOP_FAKE = FakeAPIServer.stop


def _stop_fake(api):
    threading.Thread(target=_STOP_FAKE, args=(api,), daemon=True).start()


# The JAX Manager's case sleeps out its autoscaler's and election's
# intervals (~10 s) as it stops: test_manager_over_rest_matches_jax holds
# both Managers over REST with short intervals instead.
@pytest.mark.parametrize("module,qual,params", jax_cases(
    jtest_kubestore, skip=("test_manager_control_plane_over_rest",)))
def test_jax_cases_on_both_packages(module, qual, params, request, monkeypatch):
    for mod in (module, port_clone(module)):
        # The fake's stop waits out a half-second shutdown poll.
        monkeypatch.setattr(mod.FakeAPIServer, "stop", _stop_fake)
    run_jax_case_both(module, qual, params, request, monkeypatch)


def _mods(pkg):
    return types.SimpleNamespace(
        mt=importlib.import_module(f"{pkg}.api.model_types"),
        ct=importlib.import_module(f"{pkg}.api.core_types"),
        k8s=importlib.import_module(f"{pkg}.runtime.k8s"),
        store=importlib.import_module(f"{pkg}.runtime.store"),
        leader=importlib.import_module(f"{pkg}.autoscaler.leader"),
        asc=importlib.import_module(f"{pkg}.autoscaler.autoscaler"),
    )


class Recorder:
    """Every request a store sends through urllib: (method, path and
    query, JSON body, Authorization, Content-Type), the watch threads'
    (``kube-watch-<kind>``) apart from the rest."""

    def __init__(self, monkeypatch):
        self.watch, self.rest = [], []
        real = urllib.request.urlopen

        def urlopen(req, *a, **k):
            if isinstance(req, urllib.request.Request):
                body = json.loads(req.data) if req.data else None
                rec = (req.get_method(), req.full_url.split("/", 3)[3], body,
                       req.get_header("Authorization"), req.get_header("Content-type"))
                kube = threading.current_thread().name.startswith("kube-watch")
                (self.watch if kube else self.rest).append(rec)
            return real(req, *a, **k)

        monkeypatch.setattr(urllib.request, "urlopen", urlopen)


def _out(fn, m):
    """*fn()*'s result in a package-free form, or its error's type name."""
    try:
        return plain(fn())
    except (m.store.AlreadyExists, m.store.Conflict, m.store.NotFound) as e:
        return ("error", type(e).__name__)


def _drain(q, names, timeout=15):
    """Watch events until every name in *names* was seen (ADDED or
    MODIFIED) or DELETED is seen for a name prefixed "-"."""
    events, deadline = [], time.time() + timeout
    while time.time() < deadline:
        try:
            ev = q.get(timeout=0.5)
        except queue.Empty:
            continue
        events.append((ev.type, ev.kind, plain(ev.obj)))
        seen = {(e[0] == "DELETED", e[2][1]["meta"][1]["name"]) for e in events}
        if all(((n.startswith("-"), n.lstrip("-")) in seen) for n in names):
            break
    return events


def _model(m, name, **spec):
    return m.mt.Model(meta=m.store.ObjectMeta(name=name, labels={"team": "a"}),
                      spec=m.mt.ModelSpec(url="hf://org/model", **spec))


def sc_crud(m, store, api, mp):
    out = [_out(lambda: store.create(m.mt.KIND_MODEL, _model(
        m, "m1", engine=m.mt.ENGINE_TPU, resource_profile="nvidia-gpu-h100:1", min_replicas=1,
        max_replicas=3, args=["--max-slots", "8"], env={"A": "1"})), m)]
    out.append(_out(lambda: store.get(m.mt.KIND_MODEL, "m1"), m))
    out.append(_out(lambda: store.create(m.mt.KIND_MODEL, _model(m, "m1")), m))
    out.append(_out(lambda: store.mutate(m.mt.KIND_MODEL, "m1",
                                         lambda o: setattr(o.spec, "min_replicas", 2)), m))

    def status(o):
        o.status.replicas_all, o.status.replicas_ready = 2, 1

    out.append(_out(lambda: store.mutate(m.mt.KIND_MODEL, "m1", status), m))
    out.append(_out(lambda: store.list(m.mt.KIND_MODEL, selector={"team": "a"}), m))
    out.append(_out(lambda: store.list(m.mt.KIND_MODEL, selector={"team": "b"}), m))
    out.append(_out(lambda: store.delete(m.mt.KIND_MODEL, "m1"), m))
    out.append(_out(lambda: store.get(m.mt.KIND_MODEL, "m1"), m))
    out.append(_out(lambda: store.delete(m.mt.KIND_MODEL, "m1"), m))
    return out


def sc_conflict(m, store, api, mp):
    out = [_out(lambda: store.create(m.mt.KIND_MODEL, _model(m, "m1")), m)]
    stale = store.get(m.mt.KIND_MODEL, "m1")
    out.append(_out(lambda: store.mutate(m.mt.KIND_MODEL, "m1", lambda o: None), m))
    stale.spec.target_requests = 9
    out.append(_out(lambda: store.update(m.mt.KIND_MODEL, stale), m))
    out.append(_out(lambda: store.update(m.mt.KIND_MODEL, stale, check_version=False), m))
    raced = []

    def fn(o):
        # The first attempt loses a race to another writer: mutate retries.
        if not raced:
            raced.append(1)
            other = store.get(m.mt.KIND_MODEL, "m1")
            other.spec.max_replicas = 4
            store.update(m.mt.KIND_MODEL, other)
        o.spec.min_replicas = 1

    out.append(_out(lambda: store.mutate(m.mt.KIND_MODEL, "m1", fn), m))
    return out


def sc_kinds(m, store, api, mp):
    ct, meta = m.ct, m.store.ObjectMeta
    objs = [
        (ct.KIND_POD, ct.Pod(meta=meta(name="p1", labels={"model": "m1"}, owner_uids=["u1"]),
                             spec=ct.PodSpec(containers=[ct.Container(
                                 name="server", image="img", command=["python", "-m", "x"],
                                 args=["--port", "8000"], env={"K": "v"}, ports=[8000],
                                 resources_limits={"nvidia.com/gpu": "1"})]))),
        (ct.KIND_JOB, ct.Job(meta=meta(name="j1", labels={"model": "m1"}),
                             spec=ct.PodSpec(containers=[ct.Container(name="l", image="i")]))),
        (ct.KIND_PVC, ct.PVC(meta=meta(name="c1"), spec=ct.PVCSpec(storage="10Gi"))),
        (ct.KIND_CONFIGMAP, ct.ConfigMap(meta=meta(name="cm1"), data={"a": "b"})),
        (ct.KIND_SECRET, ct.Secret(meta=meta(name="s1", labels={"model": "m1"}),
                                   data={"token": "t0k"})),
    ]
    out = []
    for kind, obj in objs:
        out.append(_out(lambda: store.create(kind, obj), m))
        out.append(_out(lambda: store.get(kind, obj.meta.name), m))
    # The kubelet's status, forged on the server, reads back.
    doc = api.get("pods", "p1") if isinstance(api, kube_standin.APIServer) else \
        api.objects["default/pods"]["p1"]
    status = {"phase": "Running", "podIP": "10.1.2.3",
              "conditions": [{"type": "Ready", "status": "True"}]}
    if isinstance(api, kube_standin.APIServer):
        api.kubelet_update("pods", "p1", lambda d: d.__setitem__("status", status))
    else:
        doc["status"] = status
    out.append(_out(lambda: store.get(ct.KIND_POD, "p1"), m))
    # An update never writes a pod's status (KubeStore pops it).
    out.append(_out(lambda: store.mutate(ct.KIND_POD, "p1",
                                         lambda p: p.meta.labels.update(x="1")), m))
    out.append(_out(lambda: store.list(ct.KIND_POD, selector={"model": "m1"}), m))
    out.append(_out(lambda: store.delete_all_of(ct.KIND_SECRET, selector={"model": "m1"}), m))
    out.append(_out(lambda: store.list(ct.KIND_SECRET), m))
    return out


def sc_lease(m, store, api, mp):
    lease = m.leader.Lease(meta=m.store.ObjectMeta(name="kubeai.org"), holder="me",
                           renew_time=5.25, duration_seconds=15.0)
    out = [_out(lambda: store.create("Lease", lease), m)]
    out.append(_out(lambda: store.get("Lease", "kubeai.org"), m))
    out.append(_out(lambda: store.mutate("Lease", "kubeai.org",
                                         lambda x: setattr(x, "holder", "you")), m))
    out.append(_out(lambda: store.list("Lease"), m))
    return out


def sc_record(m, store, api, mp):
    st = m.asc.AutoscalerState(meta=m.store.ObjectMeta(name="as-state"),
                               averages={"m1": 2.5, "m2": 0.0})
    out = [_out(lambda: store.create("AutoscalerState", st), m)]
    out.append(_out(lambda: store.get("AutoscalerState", "as-state"), m))
    st2 = store.get("AutoscalerState", "as-state")
    st2.averages = {"m1": 3.0}
    out.append(_out(lambda: store.update("AutoscalerState", st2, check_version=False), m))
    out.append(_out(lambda: store.list("AutoscalerState"), m))
    out.append(_out(lambda: store.list("AutoscalerState", selector={"x": "y"}), m))
    out.append(_out(lambda: store.delete("AutoscalerState", "as-state"), m))
    out.append(_out(lambda: store.get("AutoscalerState", "as-state"), m))
    return out


def sc_election(m, store, api, mp):
    """Two operators' elections on one lease under one clock: a takes it,
    b waits, a's lease expires and b takes it over, a loses it, b releases."""
    now = [1000.0]
    mp.setattr(m.leader, "time", types.SimpleNamespace(time=lambda: now[0]))
    a = m.leader.Election(store, "op-a", duration=1.0)
    b = m.leader.Election(store, "op-b", duration=1.0)
    out = []
    for who, dt in ((a, 0.0), (b, 0.1), (a, 0.2), (b, 0.5), (b, 1.5), (a, 0.1)):
        now[0] += dt
        who._try_acquire_or_renew()
        out.append((who.identity, a.is_leader.is_set(), b.is_leader.is_set()))
    b.stop()
    out.append(_out(lambda: store.get("Lease", "kubeai-tpu.kubeai.org"), m))
    return out


def _watching(api):
    """Wait until the store's watch stream is open on *api* (its list
    done): the script's next write then lands in the stream."""
    watchers = lambda: api._watchers if isinstance(api, kube_standin.APIServer) \
        else api.watchers  # noqa: E731
    deadline = time.time() + 15
    while not watchers():
        assert time.time() < deadline, "no watch stream opened"
        time.sleep(0.01)


def sc_watch_resume(m, store, api, mp):
    q = store.watch(m.mt.KIND_MODEL)
    _watching(api)
    store.create(m.mt.KIND_MODEL, _model(m, "m1"))
    out = [_drain(q, ["m1"])]
    api.drop_watches()
    _watching(api)
    store.create(m.mt.KIND_MODEL, _model(m, "m2"))
    out.append(_drain(q, ["m2"]))
    store.delete(m.mt.KIND_MODEL, "m1")
    out.append(_drain(q, ["-m1"]))
    return out


def sc_watch_410(m, store, api, mp):
    q = store.watch(m.mt.KIND_MODEL)
    _watching(api)
    store.create(m.mt.KIND_MODEL, _model(m, "m1"))
    out = [_drain(q, ["m1"])]
    real = urllib.request.urlopen
    done = []

    def urlopen(req, *a, **k):
        # Just before the resumed watch: another client creates m2 and
        # the history is compacted past the store's resourceVersion.
        if isinstance(req, urllib.request.Request) and "resourceVersion=1&" in req.full_url \
                and not done:
            done.append(1)
            doc = {"apiVersion": "kubeai.org/v1", "kind": "Model",
                   "metadata": {"name": "m2", "labels": {"team": "a"}},
                   "spec": {"url": "hf://org/model", "engine": "TPUEngine"}}
            if isinstance(api, kube_standin.APIServer):
                api._create("default", "models", doc)
                api.compact()
            else:
                api.compact()
                post = urllib.request.Request(
                    f"{api.url}/apis/kubeai.org/v1/namespaces/default/models",
                    data=json.dumps(doc).encode(), method="POST")
                _URLOPEN(post, timeout=10).close()
        return real(req, *a, **k)

    mp.setattr(urllib.request, "urlopen", urlopen)
    api.drop_watches()
    out.append(sorted(_drain(q, ["m1", "m2"], timeout=25), key=repr))
    assert done
    return out


SCENARIOS = {"crud": sc_crud, "conflict": sc_conflict, "kinds": sc_kinds, "lease": sc_lease,
             "record": sc_record, "election": sc_election, "watch_resume": sc_watch_resume,
             "watch_410": sc_watch_410}


def _run(name, pkg, api, mp):
    m = _mods(pkg)
    store = m.k8s.KubeStore(api_server=api.url, token="test-token", namespace="default")
    try:
        return SCENARIOS[name](m, store, api, mp)
    finally:
        store.close()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_requests_and_results_equal_jax(name, monkeypatch):
    results, logs = {}, {}
    for pkg in PKGS:
        api = FakeAPIServer()
        # One context for the recorder and the scenario's own patches:
        # both are undone, in order, when it closes.
        with monkeypatch.context() as mp:
            rec = Recorder(mp)
            try:
                results[pkg] = _run(name, pkg, api, mp)
            finally:
                _stop_fake(api)
        logs[pkg] = rec
    assert urllib.request.urlopen is _URLOPEN  # every patch undone
    assert results["kubeai_tpu_torch"] == results["kubeai_tpu"]
    j, t = logs["kubeai_tpu"], logs["kubeai_tpu_torch"]
    assert t.rest == j.rest and len(j.rest) > 0
    assert t.watch == j.watch
    assert all(r[3] == "Bearer test-token" for r in j.rest + j.watch)


def _strip_server_fields(obj):
    """A plain result without what the two servers fill in differently:
    uids, creation times and resource versions (the stand-in's kubelet
    write is a write; the fake's forged status is not)."""
    if isinstance(obj, dict):
        return {k: ("-" if k in ("uid", "creation_time", "resource_version")
                    else _strip_server_fields(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strip_server_fields(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_strip_server_fields(x) for x in obj)
    return obj


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_standin_answers_as_the_fake(name, monkeypatch):
    """The port's store returns the same objects and events over the
    stand-in apiserver as over the fake."""
    got = {}
    for which in ("fake", "standin"):
        api = FakeAPIServer() if which == "fake" else kube_standin.APIServer()
        with monkeypatch.context() as mp:
            try:
                got[which] = _strip_server_fields(_run(name, "kubeai_tpu_torch", api, mp))
            finally:
                _stop_fake(api)
        if which == "standin":
            assert sum(api.requests.values()) > 0
    assert urllib.request.urlopen is _URLOPEN  # every patch undone
    if name == "kinds":
        # After the pod's update (steps 11 and 12), the stand-in keeps the
        # kubelet's status, as an apiserver does (a main-resource PUT
        # never changes it); the fake stores the body, which has none.
        for step in (11, 12):
            pods = [got["standin"][step], got["fake"][step]]
            pods = [p if isinstance(p, list) else [p] for p in pods]
            assert [p[1]["status"][1]["ready"] for p in pods[0]] == [True]
            assert [p[1]["status"][1]["ready"] for p in pods[1]] == [False]
            for which in got:
                for p in (got[which][step] if isinstance(got[which][step], list)
                          else [got[which][step]]):
                    p[1]["status"] = "-"
    assert got["standin"] == got["fake"]


# ---------------------------------------------------------------------------
# The Manager over REST


def _wait(cond, what, timeout=15):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.05)


def _complete(port, model):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/openai/v1/completions",
        data=json.dumps({"model": model, "prompt": "hi"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _normal(doc):
    """A stored document without the server's and the run's own values."""
    if isinstance(doc, dict):
        return {k: _normal(v) for k, v in doc.items()
                if k not in ("resourceVersion", "uid", "renewTime", "holderIdentity",
                             "creationTimestamp", "lastTransitionTime",
                             # each run's engine port, and the hash of a pod
                             # whose command names the package
                             "model-pod-port", "pod-hash")}
    if isinstance(doc, list):
        return [_normal(x) for x in doc]
    return doc


def _manager(pkg, url, monkeypatch, tmp_path):
    monkeypatch.setenv("KUBEAI_CANARY", "0")
    monkeypatch.setenv("KUBEAI_HISTORY_DIR", str(tmp_path / "history"))
    system = importlib.import_module(f"{pkg}.config.system").System()
    # Short loops: the JAX autoscaler and election sleep a whole interval
    # before they stop.
    system.leader_election_lease_seconds = 0.6
    system.autoscaling.interval_seconds = 0.2
    system.autoscaling.time_window_seconds = 0.6
    system.allow_pod_address_override = True
    store = _mods(pkg).k8s.KubeStore(api_server=url, token="t", namespace="default")
    mgr = importlib.import_module(f"{pkg}.manager").Manager(
        system.default_and_validate(), store=store, host="127.0.0.1", port=0)
    return mgr, store


def test_manager_over_rest_matches_jax(monkeypatch, tmp_path):
    """Each package's Manager over its own fake: the same Model reconciles
    into the same stored objects, and a forged Ready routes a request."""
    docs = {}
    for pkg in PKGS:
        api, eng = FakeAPIServer(), FakeEngine()
        mgr, store = _manager(pkg, api.url, monkeypatch, tmp_path)
        m = _mods(pkg)
        mgr.start()
        try:
            store.create(m.mt.KIND_MODEL, m.mt.Model(
                meta=m.store.ObjectMeta(name="m1"),
                spec=m.mt.ModelSpec(url="hf://a/b", resource_profile="cpu:1", min_replicas=1)))
            _wait(lambda: api.objects.get("default/pods"), "no pod")
            _wait(lambda: api.objects.get("default/configmaps"), "no autoscaler state")
            _wait(lambda: "status" in api.objects["default/models"]["m1"], "no model status")
            _wait(lambda: api.objects.get("default/leases"), "no lease")
            (name, doc), = api.objects["default/pods"].items()
            doc["status"] = {"phase": "Running", "podIP": "127.0.0.1",
                             "conditions": [{"type": "Ready", "status": "True"}]}
            doc["metadata"].setdefault("annotations", {})["model-pod-port"] = str(eng.port)
            api.notify("default/pods", "MODIFIED", doc)
            assert _complete(mgr.api.port, "m1")["choices"][0]["text"] == "ok:m1"
            _wait(lambda: api.objects["default/models"]["m1"].get("status", {}).get(
                "replicas", {}).get("ready") == 1, "the model's status never read 1 ready")
            if pkg == "kubeai_tpu_torch":
                # The port's TPUEngine pod runs the port's server in its image.
                server = doc["spec"]["containers"][0]
                assert server["command"] == ["python", "-m", "kubeai_tpu_torch.engine.server"]
                assert server["image"] == "kubeai-tpu/engine-cuda:latest"
                doc = json.loads(json.dumps(doc).replace("kubeai_tpu_torch", "kubeai_tpu")
                                 .replace("engine-cuda:", "engine:"))
            docs[pkg] = {
                "model": _normal(api.objects["default/models"]["m1"]),
                # The pod's name ends in a random suffix.
                "pod": _normal({**doc, "metadata": {k: v for k, v in doc["metadata"].items()
                                                    if k != "name"}}),
                "lease": _normal(api.objects["default/leases"]),
                "records": sorted(api.objects["default/configmaps"]),
                "leader": api.objects["default/leases"]["kubeai-tpu.kubeai.org"]["spec"][
                    "holderIdentity"] == mgr.election.identity,
            }
        finally:
            mgr.stop()
            store.close()
            eng.stop()
            api.stop()
    assert docs["kubeai_tpu_torch"] == docs["kubeai_tpu"]
    assert docs["kubeai_tpu"]["records"] == ["rec-autoscalerstate-kubeai-autoscaler-state"]


def test_manager_over_the_standin_with_its_kubelet(monkeypatch, tmp_path):
    """The port's Manager over the stand-in apiserver; the kubelet's status
    write (no process: its _set_status, as after a launch and a probe)
    makes the pod Ready, and the proxy routes to it. Deleting the Model
    takes the Pod out of the apiserver (the garbage collector)."""
    from kubeai_tpu_torch.api import model_types as mt
    from kubeai_tpu_torch.api.core_types import KIND_POD
    from kubeai_tpu_torch.runtime.k8s import KubeStore

    api, eng = kube_standin.APIServer(), FakeEngine()
    mgr, store = _manager("kubeai_tpu_torch", api.url, monkeypatch, tmp_path)
    kubelet = kube_standin.Kubelet(api, KubeStore(api_server=api.url))
    mgr.start()
    try:
        # The Model as kubectl would send it: the CRD's JSON.
        doc = {"apiVersion": "kubeai.org/v1", "kind": "Model", "metadata": {"name": "m1"},
               "spec": {"url": "hf://a/b", "engine": "TPUEngine", "resourceProfile": "cpu:1",
                        "minReplicas": 1}}
        req = urllib.request.Request(f"{api.url}/apis/kubeai.org/v1/namespaces/default/models",
                                     data=json.dumps(doc).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
        _wait(lambda: api.objects.get(("default", "pods")), "no pod")
        (name,) = api.objects[("default", "pods")]
        assert store.get(KIND_POD, name).status.ready is False
        kubelet._set_status(name, phase="Running", scheduled=True, pod_ip="127.0.0.1",
                            port=eng.port)
        kubelet._set_status(name, ready=True)
        pod = store.get(KIND_POD, name)
        assert pod.status.ready and pod.status.phase == "Running"
        assert pod.meta.annotations[mt.ANNOTATION_MODEL_POD_PORT] == str(eng.port)
        assert _complete(mgr.api.port, "m1")["choices"][0]["text"] == "ok:m1"
        _wait(mgr.election.is_leader.is_set, "the Manager took no lease")
        assert api.get("leases", "kubeai-tpu.kubeai.org")["spec"]["holderIdentity"] == \
            mgr.election.identity
        req = urllib.request.Request(f"{api.url}/apis/kubeai.org/v1/namespaces/default/models/m1",
                                     method="DELETE")
        urllib.request.urlopen(req, timeout=10).close()
        _wait(lambda: not api.objects[("default", "pods")], "the pod outlived its Model")
        assert api.watch_events > 0 and api.requests["watch"] > 0
        assert {"get", "list", "create", "update", "delete"} <= set(api.requests)
    finally:
        mgr.stop()
        store.close()
        kubelet.store.close()
        eng.stop()
        api.stop()
