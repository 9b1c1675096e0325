"""The port's pod plans, engine pod generators and Model reconciler
(kubeai_tpu_torch/controller) against the JAX package's, on the CPU.

- The cases of tests/test_pod_plan.py run through both packages
  (tests/_torch_operator.py): ``calculate_pod_plan`` and
  ``pod_spec_hash`` give equal plans and hashes on each test's pods.
- The reconciler scenarios of tests/test_controller.py (create, feature
  labels, scale up and down, bounds, status, rollout on a spec change, a
  lost pod, delete, files, JSON patches, multi-host gangs, the engine
  matrix) run on a JAX and a port store side by side, and so do the
  control loops' scenarios: the cache (PVC, loader Job, pods gated until
  it completes, eviction Job and finalizer on delete), adapters (loads
  and unloads through a stub engine client as the spec adds, changes and
  removes them) and the parked pool (top-up, a claim against
  tests/test_parked.py's fake parked server, the sweep of a failed
  attach). After every step the Models, the pods, the ConfigMaps and
  Secrets, the Jobs and PVCs are equal, up to random names (each side
  draws them from one seeded sequence) and what the port means to
  change; so are the engine calls and the decision records. The JAX side runs the
  JAX default profiles; the port's System holds the same profiles with
  ``nvidia.com/gpu`` for ``google.com/tpu``, so the four third-party
  engines' pods are equal field by field and the native engine's differ
  only in the command, the image and the resource name.
- The cases of tests/test_cache.py and tests/test_parked.py run on both
  packages (``run_jax_case_both``).
- The native pod on the port's default ``nvidia-gpu-h100`` profile at 1,
  2 and 8 GPUs: ``kubeai_tpu_torch.engine.server``, the CUDA image,
  ``nvidia.com/gpu`` requests and limits, ``--tensor-parallel-size`` the
  GPU count, the H100 node selector, ``/readyz``; at
  ``hosts_per_replica`` 2 each pod carries the controller's
  ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES`` and the gang secret, and
  ``--tensor-parallel-size`` counts both hosts.
- Every model source scheme resolves to the JAX generator's ``--model``.
"""

import copy
import json
import random
import re
import threading
import uuid
from http.server import ThreadingHTTPServer

import pytest

import test_cache as jtest_cache
import test_parked as jtest_parked
import test_pod_plan as jtest_pod_plan
from _torch_operator import jax_cases, plain, run_jax_case, run_jax_case_both, to_port
from kubeai_tpu.api import core_types as jct
from kubeai_tpu.api import model_types as jmt
from kubeai_tpu.autoscaler.autoscaler import DecisionLog as JDecisionLog
from kubeai_tpu.config import system as jsys
from kubeai_tpu.controller import adapters as jadapters
from kubeai_tpu.controller import cache as jcache
from kubeai_tpu.controller import parked as jparked
from kubeai_tpu.controller import controller as jcontroller
from kubeai_tpu.controller import engines as jengines
from kubeai_tpu.controller.controller import ModelReconciler as JReconciler
from kubeai_tpu.runtime import store as js
from kubeai_tpu_torch.api import model_types as tmt
from kubeai_tpu_torch.autoscaler.autoscaler import DecisionLog as TDecisionLog
from kubeai_tpu_torch.config import system as tsys
from kubeai_tpu_torch.controller import adapters as tadapters
from kubeai_tpu_torch.controller import cache as tcache
from kubeai_tpu_torch.controller import parked as tparked
from kubeai_tpu_torch.controller import controller as tcontroller
from kubeai_tpu_torch.controller import engines as tengines
from kubeai_tpu_torch.controller.controller import ModelReconciler as TReconciler
from kubeai_tpu_torch.runtime import store as ts


@pytest.mark.parametrize("module,qual,params", jax_cases(jtest_pod_plan))
def test_pod_plan_cases_through_both_packages(module, qual, params, request, monkeypatch):
    calls = run_jax_case(module, qual, params, ("calculate_pod_plan", "pod_spec_hash"),
                         request, monkeypatch)
    assert calls > 0


@pytest.mark.parametrize("module,qual,params", jax_cases(jtest_cache) + jax_cases(
    # The e2e case spawns a parked JAX engine; the port's parked pods run
    # end to end in tests/test_torch_e2e_local.py.
    jtest_parked, skip=("test_parked_attach_serves_completion",)))
def test_cache_and_parked_cases_on_both_packages(module, qual, params, request, monkeypatch):
    run_jax_case_both(module, qual, params, request, monkeypatch)


# ---------------------------------------------------------------------------
# The reconciler side by side

# What the port changes in a native pod, spelled as the JAX pod spells it.
PORT_TO_JAX = (("kubeai_tpu_torch.engine.server", "kubeai_tpu.engine.server"),
               ("kubeai_tpu_torch.loader", "kubeai_tpu.loader"),
               (tsys.CUDA_ENGINE_IMAGE, "kubeai-tpu/engine:latest"),
               ("nvidia.com/gpu", "google.com/tpu"))


def _port_system(jsystem):
    """The port's System with the JAX System's profiles and settings, GPUs
    for TPU chips."""
    doc = json.dumps(plain(jsystem.resource_profiles)).replace("google.com/tpu",
                                                               "nvidia.com/gpu")
    profiles = copy.deepcopy(jsystem.resource_profiles)
    for name, prof in profiles.items():
        for d in (prof.requests, prof.limits):
            if "google.com/tpu" in d:
                d["nvidia.com/gpu"] = d.pop("google.com/tpu")
    t = to_port(copy.deepcopy(jsystem))
    t.resource_profiles = to_port(profiles)
    t.engine_images.pop("TPUEngine", None)
    assert json.dumps(plain(t.resource_profiles)) == doc
    return t.default_and_validate()


class EngineStub:
    """The adapter reconciler's engine client: records each call."""

    def __init__(self):
        self.calls = []

    def load_lora_adapter(self, addr, name, path):
        self.calls.append(("load", addr, name, path))

    def unload_lora_adapter(self, addr, name):
        self.calls.append(("unload", addr, name))


class Side:
    def __init__(self, pkg):
        self.pkg = pkg
        self.engine = EngineStub()
        self.decisions = None
        self.pool = None
        if pkg == "jax":
            self.mt, self.store = jmt, js.Store()
            self.system = jsys.System().default_and_validate()
        else:
            self.mt, self.store = tmt, ts.Store()
            self.system = None
        self.rec = None

    def hook(self, name):
        """The reconciler, with the hooks scenario *name* runs."""
        sysmod, cache, adapters, parked, log, rec = (
            (jsys, jcache, jadapters, jparked, JDecisionLog, JReconciler) if self.pkg == "jax"
            else (tsys, tcache, tadapters, tparked, TDecisionLog, TReconciler))
        kw = {}
        if name.startswith("cache"):
            self.system.cache_profiles["efs"] = sysmod.CacheProfile(
                shared_filesystem_storage_class="efs")
            self.system.cache_warm_compile = True
            kw["cache_reconciler"] = cache.CacheReconciler(self.store, self.system)
        if name == "adapters":
            kw["adapter_reconciler"] = adapters.AdapterReconciler(self.store, client=self.engine)
        if name == "parked":
            self.system.parked_replicas = 1
            self.decisions = log()
            self.pool = kw["parked_pool"] = parked.ParkedPool(
                self.store, self.system, decision_log=self.decisions, clock=lambda: 123.0)
        self.rec = rec(self.store, self.system, **kw)

    def model(self, name="m1", **kw):
        kw.setdefault("url", "hf://org/model")
        kw.setdefault("engine", jmt.ENGINE_TPU)
        kw.setdefault("resource_profile", "tpu-v5e-1x1:1")
        kw.setdefault("replicas", 1)
        if "files" in kw:
            kw["files"] = [self.mt.File(path=p, content=c) for p, c in kw["files"]]
        return self.mt.Model(meta=(js if self.pkg == "jax" else ts).ObjectMeta(name=name),
                             spec=self.mt.ModelSpec(**kw))

    def settle(self, name="m1", n=5):
        for _ in range(n):
            self.rec.reconcile(name)

    def pods(self):
        return sorted(self.store.list("Pod"), key=lambda p: p.meta.resource_version)


def _sides(name=""):
    j, t = Side("jax"), Side("port")
    t.system = _port_system(j.system)
    for side in (j, t):
        side.hook(name)
    return j, t


def _canon(side) -> str:
    """Every object of a side as JSON, random names and tokens replaced by
    their order of appearance, the port's spelled as the JAX package's."""
    objs = {kind: [plain(o) for o in sorted(side.store.list(kind),
                                            key=lambda o: o.meta.resource_version)]
            for kind in ("Model", "Pod", "ConfigMap", "Secret", "Job",
                         "PersistentVolumeClaim")}
    objs["engine_calls"] = side.engine.calls
    if side.decisions is not None:
        objs["decisions"] = [{**r, "t": None} for r in side.decisions.snapshot()]
    text = json.dumps(objs, sort_keys=True)
    if side.pkg == "port":
        for port, jax in PORT_TO_JAX:
            text = text.replace(port, jax)
    seen: dict = {}

    def token(m):
        return seen.setdefault(m.group(0), f"<{len(seen)}>")

    # Pod-name suffixes (uuid hex), gang slice ids, pod-hash labels (a
    # native pod's spec differs, so does its hash), uids, gang secrets,
    # creation times, deletion times.
    text = re.sub(r'"creation_time": [0-9.e+]+', '"creation_time": 0', text)
    text = re.sub(r'"deletion_timestamp": [0-9.e+]+', '"deletion_timestamp": 0', text)
    text = re.sub(r'"uid": "[0-9a-f]+"', '"uid": ""', text)
    text = re.sub(r'"owner_uids": \["[0-9a-f]+"\]', '"owner_uids": ["owner"]', text)
    text = re.sub(r'"KUBEAI_GANG_SECRET": "[0-9a-f]{64}"', '"KUBEAI_GANG_SECRET": "<token>"', text)
    # Uids in the cache's paths and PVC annotations.
    text = re.sub(r"(?<![0-9a-f])[0-9a-f]{32}(?![0-9a-f])", token, text)
    text = re.sub(r"(?<=-)[0-9a-f]{6}(?=\")|(?<=-)[0-9a-f]{8}(?=[-\".])"
                  r'|(?<="pod-hash": ")[0-9a-f]{8}(?=")|(?<="slice-id": ")[0-9a-f]{8}(?=")',
                  token, text)
    return text


def _ready(side, index=None):
    for i, p in enumerate(side.pods()):
        if index is None or i == index:
            try:
                side.store.mutate("Pod", p.meta.name,
                                  lambda p: setattr(p.status, "ready", True))
            except Exception:
                pass


SCENARIOS = {
    "create": [("create", {"replicas": 2}), ("settle",)],
    "feature_labels": [("create", {}), ("settle",)],
    "scale_up_down": [("create", {"replicas": 1}), ("settle",), ("replicas", 3), ("settle",),
                      ("replicas", 0), ("settle",)],
    "replica_bounds": [("create", {"replicas": 9, "max_replicas": 2}), ("settle",)],
    "status_counts": [("create", {"replicas": 2}), ("settle",), ("ready", 0), ("settle",)],
    "rollout": [("create", {"replicas": 2}), ("settle",), ("ready", None), ("args", "--x=1"),
                ("reconcile",)] + [("ready", None), ("reconcile",)] * 8,
    "lost_pod": [("create", {"replicas": 2}), ("settle",), ("delete_pod", 0), ("settle",)],
    "delete": [("create", {"replicas": 2}), ("settle",), ("delete_model",)],
    "files": [("create", {"files": [("/cfg/prompt.txt", "hello")]}), ("settle",)],
    "json_patches": [("patch",), ("create", {}), ("settle",)],
    "gang": [("create", {"resource_profile": "tpu-v5e-4x4:1", "replicas": 2}), ("settle",),
             ("replicas", 1), ("settle",)],
    "vllm": [("create", {"engine": jmt.ENGINE_VLLM, "resource_profile": "cpu:1"}),
             ("settle",)],
    "ollama": [("create", {"engine": jmt.ENGINE_OLLAMA, "url": "ollama://qwen2:0.5b",
                           "resource_profile": "cpu:1"}), ("settle",)],
    "faster_whisper": [("create", {"engine": jmt.ENGINE_FASTER_WHISPER,
                                   "url": "hf://org/whisper", "resource_profile": "cpu:1"}),
                       ("settle",)],
    "infinity": [("create", {"engine": jmt.ENGINE_INFINITY, "url": "hf://org/embed",
                             "resource_profile": "cpu:1"}), ("settle",)],
    "native_on_tpu_counts": [("create", {"resource_profile": "tpu-v5e-2x4:1"}), ("settle",)],
    # The control loops' reconcilers.
    "cache": [("create", {"cache_profile": "efs", "resource_profile": "cpu:1",
                          "args": ["--max-slots", "2"]}), ("settle",),
              ("complete_job", "load-cache-m1"), ("reconcile",), ("settle",)],
    "cache_delete": [("create", {"cache_profile": "efs", "resource_profile": "cpu:1"}),
                     ("settle",), ("complete_job", "load-cache-m1"), ("settle",),
                     ("delete_model",), ("reconcile",), ("reconcile",),
                     ("complete_job", "evict-cache-m1"), ("reconcile",)],
    "adapters": [("create", {"replicas": 2, "resource_profile": "cpu:1",
                             "adapters": [("a1", "hf://org/a1"), ("a2", "s3://b/a2")]}),
                 ("settle",), ("serve", None), ("reconcile",),
                 ("adapters", [("a1", "hf://org/a1-v2"), ("a2", "s3://b/a2")]), ("reconcile",),
                 ("adapters", [("a1", "hf://org/a1-v2")]), ("reconcile",), ("reconcile",)],
    "parked": [("pool",), ("run_parked", "attach"),
               ("create", {"url": "file:///ckpt", "resource_profile": "cpu:1",
                           "min_replicas": 1}), ("settle",), ("pool",),
               ("run_parked", "failed"), ("pool",), ("settle",)],
}


def _step(side, step):
    op = step[0]
    if op == "create":
        kw = dict(step[1])
        if "adapters" in kw:
            kw["adapters"] = [side.mt.Adapter(name=n, url=u) for n, u in kw["adapters"]]
        side.store.create("Model", side.model(**kw))
    elif op == "settle":
        side.settle()
    elif op == "reconcile":
        side.rec.reconcile("m1")
    elif op == "replicas":
        side.store.mutate("Model", "m1", lambda m: setattr(m.spec, "replicas", step[1]))
    elif op == "args":
        side.store.mutate("Model", "m1", lambda m: m.spec.args.append(step[1]))
    elif op == "ready":
        _ready(side, step[1])
    elif op == "delete_pod":
        side.store.delete("Pod", side.pods()[step[1]].meta.name)
    elif op == "delete_model":
        side.store.delete("Model", "m1")
    elif op == "complete_job":
        side.store.mutate("Job", step[1], lambda j: setattr(j.status, "succeeded", 1))
    elif op == "serve":
        for i, p in enumerate(side.pods()):
            def ready(p, i=i):
                p.status.ready = True
                p.status.pod_ip = f"10.0.0.{i}"
            side.store.mutate("Pod", p.meta.name, ready)
    elif op == "adapters":
        side.store.mutate("Model", "m1", lambda m: setattr(
            m.spec, "adapters", [side.mt.Adapter(name=n, url=u) for n, u in step[1]]))
    elif op == "pool":
        side.pool.reconcile()
    elif op == "run_parked":
        # Parked pods run at the fake parked server that takes attaches
        # ("attach"), or, the adopted ones, at one whose attach failed.
        port = _PARKED_SERVERS[step[1]].server_port
        for p in side.pods():
            if step[1] == "failed" and p.meta.labels.get(jparked.LABEL_PARKED) != "attached":
                continue

            def run(p):
                p.status.phase = "Running"
                p.status.pod_ip = "127.0.0.1"
                p.meta.annotations[jmt.ANNOTATION_MODEL_POD_PORT] = str(port)
            side.store.mutate("Pod", p.meta.name, run)
    elif op == "patch":
        side.system.model_server_pods.json_patches = [
            {"op": "add", "path": "/spec/node_selector/custom", "value": "yes"}]


class _SeededUUID:
    """A stand-in for the ``uuid`` module whose ``uuid4`` draws from a
    seeded sequence. Each reconciler names pods, gang slices and secrets
    with ``uuid4``, and a scale-down keeps the gang whose slice id sorts
    first: with each side drawing its own ids the two would keep
    different gangs in about half of the runs."""

    def __init__(self, seed=0):
        self._rng = random.Random(seed)

    def uuid4(self):
        return uuid.UUID(int=self._rng.getrandbits(128), version=4)


_PARKED_SERVERS: dict = {}


@pytest.fixture
def parked_servers():
    """tests/test_parked.py's fake parked servers: one takes attaches, one
    reports a failed attach on /readyz."""
    servers = {"attach": ThreadingHTTPServer(("127.0.0.1", 0), jtest_parked._FakeParked),
               "failed": ThreadingHTTPServer(("127.0.0.1", 0), jtest_parked._FakeFailedAttach)}
    jtest_parked._FakeParked.attaches = []
    jtest_parked._FakeParked.accept = True
    jtest_parked._FakeFailedAttach.attach_state = "failed: no such checkpoint"
    for srv in servers.values():
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    _PARKED_SERVERS.update(servers)
    yield servers
    _PARKED_SERVERS.clear()
    for srv in servers.values():
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reconcile_scenarios_match_jax(name, monkeypatch, request):
    for mod in (jcontroller, tcontroller, jparked, tparked):
        monkeypatch.setattr(mod, "uuid", _SeededUUID())
    if name == "parked":
        request.getfixturevalue("parked_servers")
    j, t = _sides(name)
    for i, step in enumerate(SCENARIOS[name]):
        _step(j, step)
        _step(t, step)
        assert _canon(j) == _canon(t), f"step {i} {step}"
        if name == "cache" and i == 1:
            assert t.pods() == [] and t.store.list("Job"), "a pod before the loader Job ended"
    if name == "cache":
        (pod,) = t.pods()
        assert pod.spec.containers[0].command == ["python", "-m", "kubeai_tpu_torch.engine.server"]
        assert t.store.get("Model", "m1").status.cache_loaded
    if name == "cache_delete":
        assert t.store.list("Model") == [] and t.store.list("Job") == []
    if name == "adapters":
        assert [c[0] for c in t.engine.calls] == ["load"] * 4 + ["unload", "load"] * 2 + \
            ["unload"] * 2
        assert all(p.meta.labels.get("adapter.kubeai.org/a1") ==
                   tadapters.url_hash("hf://org/a1-v2") for p in t.pods())
    if name == "parked":
        # Each side's claim attached once; the sweep deleted the adopted
        # pod and the Model got a pod of its own.
        assert len(jtest_parked._FakeParked.attaches) == 2
        assert jtest_parked._FakeParked.attaches[0] == jtest_parked._FakeParked.attaches[1]
        assert [r["action"] for r in reversed(t.decisions.snapshot())] == [
            "parked_attach", "parked_attach_failed"]
        served = t.store.list("Pod", selector={"model": "m1"})
        assert len(served) == 1 and not served[0].meta.name.startswith("parked-")
    if name == "gang":
        pods = t.pods()
        assert len(pods) == 4 and {p.spec.containers[0].env["TPU_WORKER_ID"]
                                   for p in pods} == {"0", "1", "2", "3"}
    if name in ("vllm", "ollama", "faster_whisper", "infinity"):
        # Equal field by field: nothing of PORT_TO_JAX was needed.
        (jp,), (tp,) = j.pods(), t.pods()
        assert plain(jp.spec) == plain(tp.spec)
        assert jp.meta.labels == tp.meta.labels  # the pod-hash too


# ---------------------------------------------------------------------------
# The native pod on the card's profiles


def _native(count, hosts=1, url="hf://org/model", replicas=1):
    system = tsys.System().default_and_validate()
    if hosts > 1:
        system.resource_profiles["h100-gang"] = tsys.ResourceProfile(
            requests={"nvidia.com/gpu": "8"}, limits={"nvidia.com/gpu": "8"},
            node_selector={"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"},
            hosts_per_replica=hosts)
    store = ts.Store()
    rec = TReconciler(store, system)
    profile = "h100-gang:1" if hosts > 1 else f"nvidia-gpu-h100:{count}"
    store.create(tmt.KIND_MODEL, tmt.Model(meta=ts.ObjectMeta(name="m1"), spec=tmt.ModelSpec(
        url=url, resource_profile=profile, replicas=replicas)))
    for _ in range(5):
        rec.reconcile("m1")
    return store, sorted(store.list("Pod"), key=lambda p: p.meta.name)


@pytest.mark.parametrize("gpus", [1, 2, 8])
def test_native_pod_on_h100s(gpus):
    _, (pod,) = _native(gpus)
    c = pod.spec.containers[0]
    assert c.command == ["python", "-m", "kubeai_tpu_torch.engine.server"]
    assert c.image == "kubeai-tpu/engine-cuda:latest"
    assert c.resources_requests == c.resources_limits == {"nvidia.com/gpu": str(gpus)}
    assert c.args[c.args.index("--tensor-parallel-size") + 1] == str(gpus)
    assert c.args[:6] == ["--model", "hf://org/model", "--served-model-name", "m1",
                          "--port", "8000"]
    assert pod.spec.node_selector == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert c.readiness_probe.path == "/readyz" and c.liveness_probe.path == "/health"
    assert "TPU_WORKER_ID" not in c.env and not pod.spec.subdomain


def test_native_gang_of_two_hosts():
    store, pods = _native(1, hosts=2, replicas=1)
    assert len(pods) == 2
    sid = pods[0].meta.labels["slice-id"]
    secret = f"model-m1-gang-{sid}"
    hostnames = [f"model-m1-{sid}-{r}.model-m1-slice" for r in range(2)]
    for rank, pod in enumerate(pods):
        c = pod.spec.containers[0]
        assert c.args[c.args.index("--tensor-parallel-size") + 1] == "16"
        assert c.env["TPU_WORKER_ID"] == str(rank)
        assert c.env["TPU_WORKER_HOSTNAMES"] == ",".join(hostnames)
        assert c.env["TPU_HOSTS_PER_REPLICA"] == "2"
        assert c.env[f"__envFromSecret_{secret}"] == secret
        assert "KUBEAI_GANG_SECRET" not in c.env
        assert pod.spec.subdomain == "model-m1-slice"
    assert len(store.get("Secret", secret).data["KUBEAI_GANG_SECRET"]) == 64


@pytest.mark.parametrize("url", ["hf://org/model", "pvc://claim/path", "file:///models/x",
                                 "s3://bucket/key", "gs://bucket/key", "oss://bucket/key",
                                 "ollama://x"])
def test_model_argument_per_source_scheme(url):
    def one(pkg_engines, pkg_mt, pkg_store, cfg_system, rec_cls):
        m = pkg_mt.Model(meta=pkg_store.ObjectMeta(name="m1", uid="u"),
                         spec=pkg_mt.ModelSpec(url=url, resource_profile="cpu:1"))
        rec = rec_cls(pkg_store.Store(), cfg_system)
        try:
            pod = pkg_engines.pod_for_model(m, rec.resolve_pod_config(m))
        except ValueError as e:
            return str(e)
        args = pod.spec.containers[0].args
        return args[args.index("--model") + 1]

    j = one(jengines, jmt, js, jsys.System().default_and_validate(), JReconciler)
    t = one(tengines, tmt, ts, tsys.System().default_and_validate(), TReconciler)
    assert j == t


@pytest.mark.parametrize("name", ["create", "files", "gang", "ollama", "vllm"])
def test_k8s_parse_matches_jax(name):
    """The objects a scenario leaves, rendered as Kubernetes manifests by
    the JAX package (runtime/k8s_manifests.py), read back the same by both
    packages' runtime/k8s_parse.py; a Job and a PVC beside them."""
    from kubeai_tpu.runtime import k8s_manifests as jman
    from kubeai_tpu.runtime import k8s_parse as jparse
    from kubeai_tpu_torch.runtime import k8s_parse as tparse

    j, _ = _sides()
    for step in SCENARIOS[name]:
        _step(j, step)
    docs = [("parse_pod", jman.pod_manifest(p)) for p in j.store.list("Pod")]
    docs += [("parse_configmap", jman.configmap_manifest(c)) for c in j.store.list("ConfigMap")]
    docs += [("parse_secret", jman.secret_manifest(s)) for s in j.store.list("Secret")]
    job = jct.Job(meta=js.ObjectMeta(name="loader", labels={"a": "b"}))
    job.spec.containers = copy.deepcopy(j.store.list("Pod")[0].spec.containers)
    docs += [("parse_job", jman.job_manifest(job)),
             ("parse_pvc", jman.pvc_manifest(jct.PVC(meta=js.ObjectMeta(name="cache"))))]
    assert len(docs) >= 3
    for fn, doc in docs:
        assert plain(getattr(jparse, fn)(copy.deepcopy(doc))) == \
            plain(getattr(tparse, fn)(copy.deepcopy(doc))), fn
