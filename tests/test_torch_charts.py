"""The port's charts (kubeai_tpu_torch/charts/) against the port's own code,
on the CPU, rendered by the port's helmlite.

- The operator chart's system ConfigMap loads through the port's
  ``load_system_config`` with ``default_gpu_profiles()`` and the CUDA
  engine's image; its Deployment runs ``python -m
  kubeai_tpu_torch.manager`` with ``CONFIG_PATH`` at the mounted
  ConfigMap; its kinds are the JAX chart's, and its Ingress renders as
  the JAX chart's does under the same values. Its PodMonitor selects the
  port's engine pods (the ``model`` label) and scrapes their unnamed
  container port 8000; the JAX chart's selects a label and a port name
  its pods do not have (the reference's to decide).
- The models chart renders nothing by default and, with every entry
  enabled, the port's ``CATALOG``: each Model's whole spec.
- The Role grants every request the port's KubeStore sends: each
  scripted store scenario of tests/test_torch_kubestore.py and a Manager
  (its reconcile, its lease and its watch) over the fake apiserver, every
  request recorded as (verb, API group, resource, namespaced). The JAX
  chart's Role refuses the Manager's ``list`` and ``watch`` on leases
  (the reference's to decide; ROADMAP queue 3).
- Over the apiserver stand-in with its kubelet, the stand-in counts each
  client's requests apart by bearer token: the Manager's are all granted.
"""

import json
import os
import time

import pytest
import yaml

import test_torch_kubestore as tks
from _torch_operator import obs_dirs  # noqa: F401
from test_kubestore import FakeAPIServer
from test_proxy_integration import FakeEngine

from kubeai_tpu.utils.helmlite import render_chart as jax_render_chart
from kubeai_tpu_torch.catalog import CATALOG, model_from_catalog, model_from_manifest
from kubeai_tpu_torch.config.system import (
    CUDA_ENGINE_IMAGE,
    default_gpu_profiles,
    load_system_config,
)
from kubeai_tpu_torch.tools import kube_standin
from kubeai_tpu_torch.utils.helmlite import render_chart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CHARTS = os.path.join(REPO, "kubeai_tpu_torch", "charts")
OPERATOR_CHART = os.path.join(PORT_CHARTS, "kubeai-tpu-torch")
MODELS_CHART = os.path.join(PORT_CHARTS, "models")
JAX_OPERATOR_CHART = os.path.join(REPO, "charts", "kubeai-tpu")
LEASES = "coordination.k8s.io"


def _one(docs, kind):
    (doc,) = [d for d in docs if d.get("kind") == kind and (kind != "ConfigMap" or "data" in d)]
    return doc


def _role(chart=OPERATOR_CHART, render=render_chart):
    return _one(render(chart, namespace="default"), "Role")


def test_configmap_loads_through_the_port_loader():
    docs = render_chart(OPERATOR_CHART, release_name="kubeai", namespace="kubeai-ns")
    cm = _one(docs, "ConfigMap")
    assert cm["metadata"] == {"name": "kubeai-config", "namespace": "kubeai-ns", "labels": {
        "app.kubernetes.io/name": "kubeai-tpu-torch", "app.kubernetes.io/instance": "kubeai",
        "app.kubernetes.io/version": "0.2.0"}}
    system = load_system_config(data=yaml.safe_load(cm["data"]["system.yaml"]))
    assert system.resource_profiles == default_gpu_profiles()
    assert system.engine_images["TPUEngine"].default == CUDA_ENGINE_IMAGE
    assert system.model_loader_image == "kubeai-tpu/model-loader:latest"
    assert system.secret_names.huggingface == "kubeai-huggingface"
    assert (system.autoscaling.interval_seconds, system.autoscaling.time_window_seconds) == \
        (10, 600)
    # --set reaches the loaded System (chip_smoke's kube run).
    docs = render_chart(OPERATOR_CHART, sets={"autoscaling.intervalSeconds": "1",
                                              "autoscaling.timeWindowSeconds": "3"})
    system = load_system_config(data=yaml.safe_load(_one(docs, "ConfigMap")["data"][
        "system.yaml"]))
    assert (system.autoscaling.interval_seconds, system.autoscaling.time_window_seconds) == (1, 3)


def test_deployment_runs_the_port_manager():
    docs = render_chart(OPERATOR_CHART)
    dep = _one(docs, "Deployment")
    pod = dep["spec"]["template"]["spec"]
    (c,) = pod["containers"]
    assert c["command"] == ["python", "-m", "kubeai_tpu_torch.manager"]
    assert c["image"] == "kubeai-tpu-torch/operator:latest"
    env = {e["name"]: e for e in c["env"]}
    (mount,) = c["volumeMounts"]
    (vol,) = pod["volumes"]
    assert env["CONFIG_PATH"]["value"] == os.path.join(mount["mountPath"], "system.yaml")
    assert vol["name"] == mount["name"]
    assert vol["configMap"]["name"] == _one(docs, "ConfigMap")["metadata"]["name"]
    assert "system.yaml" in _one(docs, "ConfigMap")["data"]
    assert pod["serviceAccountName"] == _one(docs, "ServiceAccount")["metadata"]["name"]
    assert sorted({d["kind"] for d in docs}) == sorted(
        {d["kind"] for d in jax_render_chart(JAX_OPERATOR_CHART)})


def test_ingress_and_pod_monitor_render_as_the_jax_chart():
    """The Ingress renders as the JAX chart's. The PodMonitor keeps the
    JAX chart's metadata and path, and selects what the port's controller
    puts on an engine pod: the ``model`` label and container port 8000,
    which has no name (tests/test_torch_k8s_manifests.py's planned pod)."""
    from test_torch_k8s_manifests import _planned_pod

    from kubeai_tpu_torch.runtime import k8s_manifests as tman

    sets = {"ingress.enabled": "true", "ingress.className": "nginx",
            "ingress.rules": '[{"host": "a.example.com", "path": "/", "pathType": "Prefix"}]',
            "ingress.tls": '[{"hosts": ["a.example.com"], "secretName": "t"}]',
            "metrics.prometheusOperator.enginePodMonitor.enabled": "true",
            "metrics.prometheusOperator.enginePodMonitor.labels": '{"release": "prom"}'}

    def docs(chart, render):
        out = {d["kind"]: d for d in render(chart, sets=sets, namespace="ns")
               if d["kind"] in ("Ingress", "PodMonitor")}
        # The chart's name is the one label that differs.
        return json.loads(json.dumps(out).replace('"kubeai-tpu-torch"', '"kubeai-tpu"'))

    got, jax = docs(OPERATOR_CHART, render_chart), docs(JAX_OPERATOR_CHART, jax_render_chart)
    assert set(got) == {"Ingress", "PodMonitor"}
    assert got["Ingress"] == jax["Ingress"]
    mon, jmon = got["PodMonitor"], jax["PodMonitor"]
    assert {k: v for k, v in mon.items() if k != "spec"} == \
        {k: v for k, v in jmon.items() if k != "spec"}
    assert mon["spec"] == {
        "selector": {"matchExpressions": [{"key": "model", "operator": "Exists"}]},
        "podMetricsEndpoints": [{"targetPort": 8000, "path": "/metrics"}],
    }
    # The JAX chart's selector and port name, which no port engine pod has.
    assert jmon["spec"]["selector"] == {"matchLabels": {"app.kubernetes.io/managed-by":
                                                        "kubeai-tpu"}}
    assert jmon["spec"]["podMetricsEndpoints"][0]["port"] == "http"
    pod = tman.pod_manifest(_planned_pod()[1])
    assert "model" in pod["metadata"]["labels"]
    assert "app.kubernetes.io/managed-by" not in pod["metadata"]["labels"]
    ports = [p for c in pod["spec"]["containers"] for p in c.get("ports", [])]
    assert ports == [{"containerPort": 8000}]


def test_models_chart_equals_the_catalog():
    assert render_chart(MODELS_CHART) == []
    sets = {"catalog." + name.replace(".", "\\.") + ".enabled": "true" for name in CATALOG}
    docs = render_chart(MODELS_CHART, sets=sets)
    assert [d["kind"] for d in docs] == ["Model"] * len(CATALOG)
    models = {d["metadata"]["name"]: model_from_manifest(d) for d in docs}
    assert list(models) == list(CATALOG)
    for name, m in models.items():
        # The whole spec: url, engine, resourceProfile, args, load balancing, ...
        assert m.spec == model_from_catalog(name).spec
        assert m.spec.resource_profile.split(":")[0] in default_gpu_profiles()


@pytest.mark.parametrize("method,path,key", [
    ("GET", "/api/v1/namespaces/default/pods/p1", ("get", "", "pods", True)),
    ("GET", "/api/v1/namespaces/default/pods?labelSelector=a%3Db", ("list", "", "pods", True)),
    ("GET", "/api/v1/pods", ("list", "", "pods", False)),
    ("GET", "/apis/coordination.k8s.io/v1/namespaces/default/leases?watch=true&"
            "resourceVersion=3&allowWatchBookmarks=true",
     ("watch", LEASES, "leases", True)),
    ("POST", "/apis/batch/v1/namespaces/default/jobs", ("create", "batch", "jobs", True)),
    ("PUT", "/apis/kubeai.org/v1/namespaces/ns/models/m1/status",
     ("update", "kubeai.org", "models/status", True)),
    ("DELETE", "/api/v1/namespaces/default/secrets/s1", ("delete", "", "secrets", True)),
])
def test_request_key(method, path, key):
    assert kube_standin.request_key(method, path) == key
    rules = {"rules": [{"apiGroups": [key[1]], "resources": [key[2]], "verbs": [key[0]]}]}
    assert kube_standin.refused_by_role(rules, [key]) == ([] if key[3] else [key])
    assert kube_standin.refused_by_role({"rules": [{"apiGroups": ["*"], "resources": ["*"],
                                                    "verbs": ["x"]}]}, [key]) == [key]


def _manager_requests(monkeypatch, tmp_path):
    """Run a port Manager over the fake apiserver (token "t"): a Model
    created by another client reconciles into a Pod, the autoscaler state
    and a status; the pod reads Ready, a request routes to it; the Model is
    scaled to zero and deleted. Returns the Manager's KubeStore's
    requests, as recorded by test_torch_kubestore's Recorder."""
    from kubeai_tpu_torch.api import model_types as mt
    from kubeai_tpu_torch.runtime.k8s import KubeStore
    from kubeai_tpu_torch.runtime.store import ObjectMeta

    api, eng = FakeAPIServer(), FakeEngine()
    rec = tks.Recorder(monkeypatch)
    mgr, store = tks._manager("kubeai_tpu_torch", api.url, monkeypatch, tmp_path)
    user = KubeStore(api_server=api.url, token="user", namespace="default")
    mgr.start()
    try:
        user.create(mt.KIND_MODEL, mt.Model(meta=ObjectMeta(name="m1"), spec=mt.ModelSpec(
            url="hf://a/b", resource_profile="cpu:1", min_replicas=1)))
        tks._wait(lambda: api.objects.get("default/pods"), "no pod")
        tks._wait(lambda: api.objects.get("default/leases"), "no lease")
        (name, doc), = api.objects["default/pods"].items()
        doc["status"] = {"phase": "Running", "podIP": "127.0.0.1",
                         "conditions": [{"type": "Ready", "status": "True"}]}
        doc["metadata"].setdefault("annotations", {})["model-pod-port"] = str(eng.port)
        api.notify("default/pods", "MODIFIED", doc)
        assert tks._complete(mgr.api.port, "m1")["choices"][0]["text"] == "ok:m1"
        tks._wait(lambda: api.objects["default/models"]["m1"].get("status", {}).get(
            "replicas", {}).get("ready") == 1, "the model's status never read 1 ready")
        tks._wait(lambda: api.objects.get("default/configmaps"), "no autoscaler state")

        def to_zero(m):
            m.spec.min_replicas, m.spec.replicas = 0, 0

        user.mutate(mt.KIND_MODEL, "m1", to_zero)
        tks._wait(lambda: not api.objects.get("default/pods"), "the pod was not deleted")
        user.delete(mt.KIND_MODEL, "m1")
        time.sleep(0.3)
    finally:
        mgr.stop()
        store.close()
        user.close()
        eng.stop()
        api.stop()
    return [r for r in rec.rest + rec.watch if r[3] == "Bearer t"]


@pytest.mark.parametrize("case", ["manager"] + [f"store-{n}" for n in sorted(tks.SCENARIOS)])
def test_role_grants_every_kubestore_request(case, monkeypatch, tmp_path):
    if case == "manager":
        sent = _manager_requests(monkeypatch, tmp_path)
    else:
        api = FakeAPIServer()
        with monkeypatch.context() as mp:
            rec = tks.Recorder(mp)
            try:
                tks._run(case[len("store-"):], "kubeai_tpu_torch", api, mp)
            finally:
                tks._stop_fake(api)
        sent = rec.rest + rec.watch
    keys = {kube_standin.request_key(method, "/" + path) for method, path, *_ in sent}
    assert keys
    assert kube_standin.refused_by_role(_role(), keys) == []
    if case == "manager":
        # Every kind the store maps is listed and watched; the Lease is
        # read, created and renewed; the Model's status goes to /status.
        plurals = {"models": "kubeai.org", "pods": "", "jobs": "batch",
                   "persistentvolumeclaims": "", "configmaps": "", "secrets": "",
                   "leases": LEASES}
        for plural, group in plurals.items():
            assert {("list", group, plural, True), ("watch", group, plural, True)} <= keys
        assert {("get", LEASES, "leases", True), ("create", LEASES, "leases", True),
                ("update", LEASES, "leases", True), ("create", "", "pods", True),
                ("delete", "", "pods", True), ("update", "kubeai.org", "models/status", True),
                ("create", "", "configmaps", True)} <= keys
        assert kube_standin.refused_by_role(_role(JAX_OPERATOR_CHART, jax_render_chart),
                                            keys) == [("list", LEASES, "leases", True),
                                                      ("watch", LEASES, "leases", True)]


def test_standin_counts_each_client_apart(monkeypatch, tmp_path):
    """A Manager (token "operator") and the kubelet's store (token
    "kubelet") over the stand-in, a Model POSTed without a token: each
    user's requests are counted apart, the kubelet's status write (in
    process) counts for nobody, and the Manager's are all granted by the
    chart's Role."""
    import urllib.request

    from kubeai_tpu_torch.api.core_types import KIND_POD
    from kubeai_tpu_torch.config.system import System
    from kubeai_tpu_torch.manager import Manager
    from kubeai_tpu_torch.runtime.k8s import KubeStore

    monkeypatch.setenv("KUBEAI_CANARY", "0")
    api = kube_standin.APIServer()
    system = System()
    system.leader_election_lease_seconds = 0.6
    system.autoscaling.interval_seconds = 0.2
    system.autoscaling.time_window_seconds = 0.6
    store = KubeStore(api_server=api.url, token="operator", namespace="default")
    mgr = Manager(system.default_and_validate(), store=store, host="127.0.0.1", port=0)
    kubelet = kube_standin.Kubelet(api, KubeStore(api_server=api.url, token="kubelet"))
    mgr.start()
    try:
        doc = {"apiVersion": "kubeai.org/v1", "kind": "Model", "metadata": {"name": "m1"},
               "spec": {"url": "hf://a/b", "engine": "TPUEngine", "resourceProfile": "cpu:1",
                        "minReplicas": 1}}
        req = urllib.request.Request(f"{api.url}/apis/kubeai.org/v1/namespaces/default/models",
                                     data=json.dumps(doc).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10).close()
        tks._wait(lambda: api.objects.get(("default", "pods")), "no pod")
        tks._wait(mgr.election.is_leader.is_set, "the Manager took no lease")
        tks._wait(lambda: ("operator", "watch", LEASES, "leases", True) in api.requests_by,
                  "the Manager opened no watch on leases")
        (name,) = api.objects[("default", "pods")]
        kubelet._set_status(name, phase="Running", scheduled=True, pod_ip="127.0.0.1")
        assert kubelet.store.get(KIND_POD, name).status.phase == "Running"
    finally:
        mgr.stop()
        store.close()
        kubelet.store.close()
        api.stop()
    operator = api.requests_of("operator")
    assert api.requests_of("") == {("create", "kubeai.org", "models", True)}
    assert api.requests_of("kubelet") == {("get", "", "pods", True)}
    assert {("create", "", "pods", True), ("watch", LEASES, "leases", True)} <= operator
    assert kube_standin.refused_by_role(_role(), operator) == []
    assert {"get", "list", "watch", "create"} <= set(api.requests)
