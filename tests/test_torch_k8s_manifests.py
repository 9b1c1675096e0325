"""The port's manifests (kubeai_tpu_torch/runtime/k8s_manifests.py) against
the JAX package's, on the CPU.

- tests/test_k8s_manifests.py's own cases run with ``pod_manifest``,
  ``model_manifest`` and ``model_from_manifest`` dual
  (tests/_torch_operator.py): each call gives equal results in both
  packages.
- Seeded objects of every kind (Pods and Jobs with containers, init
  containers, volumes, probes, env from secrets, selectors; PVCs,
  ConfigMaps, Secrets; Models with every optional spec field) render to
  equal dicts in both packages, through each function and through
  ``MANIFEST_FNS``.
- A Model's manifest reads back through either package's
  ``model_from_manifest`` to the same Model.
- A pod that the port's controller plans on ``nvidia-gpu-h100:1`` renders
  with ``nvidia.com/gpu`` requests and limits, ``--tensor-parallel-size
  1``, the ``/readyz`` probe and no TPU key anywhere; the module's CLI
  prints it, and ``render_store``'s YAML parses.
"""

import json

import numpy as np
import pytest
import yaml

import test_k8s_manifests as jtest_manifests
from _torch_operator import jax_cases, plain, run_jax_case, to_port
from kubeai_tpu.api import core_types as jct
from kubeai_tpu.api import model_types as jmt
from kubeai_tpu.catalog import model_from_manifest as j_from_manifest
from kubeai_tpu.runtime import k8s_manifests as jman
from kubeai_tpu.runtime.store import ObjectMeta
from kubeai_tpu_torch.catalog import model_from_manifest as t_from_manifest
from kubeai_tpu_torch.runtime import k8s_manifests as tman

WRAP = ("pod_manifest", "model_manifest", "model_from_manifest")


@pytest.mark.parametrize("module,qual,params", jax_cases(jtest_manifests))
def test_jax_cases_through_both_packages(module, qual, params, request, monkeypatch):
    calls = run_jax_case(module, qual, params, WRAP, request, monkeypatch)
    # render_store's case calls none of WRAP (test_render_store_equals_jax
    # holds render_store itself).
    assert calls > 0 or qual == "test_render_store_yaml_parses"


def _meta(rng, name, namespace=None):
    meta = ObjectMeta(name=name, namespace=namespace or str(rng.choice(["default", "prod"])))
    if rng.random() < 0.7:
        meta.labels = {"model": "m1", f"l{int(rng.integers(0, 9))}": "v"}
    if rng.random() < 0.5:
        meta.annotations = {"a": str(rng.integers(0, 99))}
    if rng.random() < 0.3:
        meta.finalizers = ["kubeai.org/cache-eviction"]
    if rng.random() < 0.5:
        meta.owner_uids = [f"uid-{int(rng.integers(0, 9))}"]
    return meta


def _probe(rng):
    if rng.random() < 0.3:
        return None
    path = "exec:test -f /tmp/ready" if rng.random() < 0.2 else "/readyz"
    return jct.Probe(path=path, port=int(rng.integers(8000, 8100)),
                     initial_delay_seconds=int(rng.integers(0, 3)),
                     period_seconds=int(rng.integers(1, 20)),
                     failure_threshold=int(rng.integers(1, 9)))


def _container(rng, name):
    env = {"PYTHONUNBUFFERED": "1"}
    if rng.random() < 0.5:
        env["__envFromSecret_hf"] = "kubeai-huggingface"
    return jct.Container(
        name=name if rng.random() < 0.8 else "", image=f"img:{int(rng.integers(0, 9))}",
        command=["python", "-m", "kubeai_tpu_torch.engine.server"] if rng.random() < 0.7 else [],
        args=[f"--a{i}" for i in range(int(rng.integers(0, 4)))], env=env,
        ports=[8000] if rng.random() < 0.6 else [],
        resources_requests={"nvidia.com/gpu": "1"} if rng.random() < 0.6 else {},
        resources_limits={"nvidia.com/gpu": "1", "memory": "80Gi"} if rng.random() < 0.6 else {},
        volume_mounts=[jct.VolumeMount(name="cache", mount_path="/model",
                                       sub_path="m1-u" if rng.random() < 0.5 else "",
                                       read_only=bool(rng.random() < 0.5))]
        if rng.random() < 0.5 else [],
        startup_probe=_probe(rng), readiness_probe=_probe(rng), liveness_probe=_probe(rng))


def _pod_spec(rng):
    vols = []
    for i, kind in enumerate(rng.choice(["empty", "pvc", "cm", "host"],
                                        size=int(rng.integers(0, 4)))):
        v = jct.Volume(name=f"v{i}")
        if kind == "empty":
            v.empty_dir = True
        elif kind == "pvc":
            v.pvc_name = "cache-pvc"
        elif kind == "cm":
            v.config_map_name = "files"
        else:
            v.host_path = "/data"
        vols.append(v)
    return jct.PodSpec(
        containers=[_container(rng, f"c{i}") for i in range(int(rng.integers(1, 3)))],
        init_containers=[_container(rng, "init")] if rng.random() < 0.3 else [],
        volumes=vols,
        node_selector={"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
        if rng.random() < 0.5 else {},
        tolerations=[{"key": "nvidia.com/gpu", "operator": "Exists"}]
        if rng.random() < 0.5 else [],
        affinity={"nodeAffinity": {}} if rng.random() < 0.2 else {},
        scheduler_name="sched" if rng.random() < 0.2 else "",
        runtime_class_name="nvidia" if rng.random() < 0.3 else "",
        priority_class_name="high" if rng.random() < 0.2 else "",
        service_account_name="sa" if rng.random() < 0.2 else "",
        restart_policy=str(rng.choice(["Always", "Never", "OnFailure"])),
        subdomain="slice" if rng.random() < 0.2 else "",
        hostname="h0" if rng.random() < 0.2 else "")


def _model(rng, name):
    spec = jmt.ModelSpec(
        url=str(rng.choice(["hf://org/m", "s3://b/k", "file:///ckpt", "pvc://c/p"])),
        engine=str(rng.choice([jmt.ENGINE_TPU, "VLLM"])),
        resource_profile="nvidia-gpu-h100:1" if rng.random() < 0.7 else "",
        cache_profile="h100-cache" if rng.random() < 0.3 else "",
        args=["--max-slots", "8"] if rng.random() < 0.5 else [],
        env={"A": "1"} if rng.random() < 0.5 else {},
        replicas=int(rng.integers(0, 3)) if rng.random() < 0.5 else None,
        min_replicas=int(rng.integers(0, 2)),
        max_replicas=int(rng.integers(2, 5)) if rng.random() < 0.5 else None,
        autoscaling_disabled=bool(rng.random() < 0.2),
        target_requests=int(rng.choice([100, 8])),
        scale_down_delay_seconds=int(rng.choice([30, 600])),
        priority_class_name="high" if rng.random() < 0.2 else "",
        owner="team-a" if rng.random() < 0.3 else "")
    if rng.random() < 0.4:
        spec.load_balancing = jmt.LoadBalancing(
            strategy=jmt.PREFIX_HASH_STRATEGY,
            prefix_hash=jmt.PrefixHash(prefix_char_length=int(rng.integers(50, 200))))
    if spec.engine == jmt.ENGINE_TPU and rng.random() < 0.3:
        spec.disaggregation = jmt.Disaggregation(
            enabled=True, prefill_replicas=2, decode_replicas=1,
            max_prefill_replicas=4 if rng.random() < 0.5 else None,
            max_decode_replicas=3 if rng.random() < 0.5 else None, handoff_tokens=16)
    if rng.random() < 0.4:
        spec.adapters = [jmt.Adapter(name="ad1", url="hf://c/d")]
    if rng.random() < 0.3:
        spec.files = [jmt.File(path="/config/a.json", content="{}")]
    model = jmt.Model(meta=_meta(rng, name), spec=spec)
    if rng.random() < 0.5:
        model.status = jmt.ModelStatus(replicas_all=2, replicas_ready=1,
                                       cache_loaded=bool(rng.random() < 0.5))
    return model


def _objects(seed):
    rng = np.random.default_rng(seed)
    return [
        ("Pod", jct.Pod(meta=_meta(rng, "p1"), spec=_pod_spec(rng))),
        ("Job", jct.Job(meta=_meta(rng, "j1"), spec=_pod_spec(rng),
                        backoff_limit=int(rng.integers(0, 6)))),
        ("PersistentVolumeClaim", jct.PVC(meta=_meta(rng, "c1"), spec=jct.PVCSpec(
            storage_class_name="standard" if rng.random() < 0.5 else "",
            access_modes=["ReadWriteOnce"] if rng.random() < 0.5 else ["ReadWriteMany"],
            storage=f"{int(rng.integers(1, 500))}Gi"))),
        ("ConfigMap", jct.ConfigMap(meta=_meta(rng, "cm1"),
                                    data={f"k{i}": str(i) for i in range(int(rng.integers(0, 4)))})),
        ("Secret", jct.Secret(meta=_meta(rng, "s1"), data={"token": f"t{rng.integers(0, 99)}"})),
        ("Model", _model(rng, "m1")),
    ]


@pytest.mark.parametrize("seed", range(12))
def test_every_manifest_equals_jax(seed):
    fns = {"Pod": "pod_manifest", "Job": "job_manifest",
           "PersistentVolumeClaim": "pvc_manifest", "ConfigMap": "configmap_manifest",
           "Secret": "secret_manifest", "Model": "model_manifest"}
    assert list(tman.MANIFEST_FNS) == list(jman.MANIFEST_FNS) == list(fns)
    for kind, obj in _objects(seed):
        want = getattr(jman, fns[kind])(obj)
        got = getattr(tman, fns[kind])(to_port(obj))
        assert got == want, kind
        assert tman.MANIFEST_FNS[kind](to_port(obj)) == want
        # The manifest is plain JSON (what KubeStore sends).
        assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("seed", range(12))
def test_model_round_trips_through_both_packages(seed):
    model = dict(_objects(seed))["Model"]
    doc = jman.model_manifest(model)
    back_j, back_t = j_from_manifest(doc), t_from_manifest(doc)
    assert plain(back_t) == plain(back_j)
    assert plain(t_from_manifest(tman.model_manifest(to_port(model)))) == plain(back_j)
    assert tman.model_manifest(back_t) == jman.model_manifest(back_j)


def _planned_pod(tmp_path=None):
    from kubeai_tpu_torch.api import model_types as tmt
    from kubeai_tpu_torch.config.system import System
    from kubeai_tpu_torch.controller.controller import ModelReconciler
    from kubeai_tpu_torch.runtime.store import ObjectMeta as TMeta
    from kubeai_tpu_torch.runtime.store import Store

    store = Store()
    rec = ModelReconciler(store, System().default_and_validate())
    store.create(tmt.KIND_MODEL, tmt.Model(meta=TMeta(name="m1"), spec=tmt.ModelSpec(
        url="hf://org/model", resource_profile="nvidia-gpu-h100:1", replicas=1)))
    for _ in range(3):
        rec.reconcile("m1")
    return store, store.list("Pod", selector={"model": "m1"})[0]


def _check_cuda_pod(doc):
    assert doc["apiVersion"] == "v1" and doc["kind"] == "Pod"
    server = doc["spec"]["containers"][0]
    assert server["command"] == ["python", "-m", "kubeai_tpu_torch.engine.server"]
    assert server["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert server["resources"]["requests"]["nvidia.com/gpu"] == "1"
    args = server["args"]
    assert args[args.index("--tensor-parallel-size") + 1] == "1"
    assert server["readinessProbe"]["httpGet"]["path"] == "/readyz"
    assert doc["spec"]["nodeSelector"] == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    text = json.dumps(doc)
    assert "google.com/tpu" not in text and "gke-tpu" not in text and "tpu-topology" not in text


def test_cuda_pod_manifest_shape():
    _, pod = _planned_pod()
    _check_cuda_pod(tman.pod_manifest(pod))


def test_render_store_equals_jax():
    from kubeai_tpu.runtime.store import Store as JStore
    from kubeai_tpu_torch.runtime.store import Store as TStore

    jstore, tstore = JStore(), TStore()
    for seed in range(4):
        for kind, obj in _objects(seed):
            obj.meta.name = f"{obj.meta.name}-{seed}"
            jstore.create(kind, obj)
            tstore.create(kind, to_port(obj))
    for kinds in (None, ["Pod", "Model"], ["Secret"]):
        text = tman.render_store(tstore, kinds)
        assert text == jman.render_store(jstore, kinds)
        assert len(list(yaml.safe_load_all(text))) == 4 * (len(kinds) if kinds else 6)


def test_render_store_and_the_cli(tmp_path, capsys):
    store, _ = _planned_pod()
    docs = list(yaml.safe_load_all(tman.render_store(store)))
    assert {d["kind"] for d in docs} == {"Model", "Pod"}
    assert [d["kind"] for d in yaml.safe_load_all(tman.render_store(store, ["Model"]))] == \
        ["Model"]
    models = tmp_path / "models.yaml"
    models.write_text(yaml.safe_dump({
        "apiVersion": "kubeai.org/v1", "kind": "Model", "metadata": {"name": "m1"},
        "spec": {"url": "hf://org/model", "engine": "TPUEngine",
                 "resourceProfile": "nvidia-gpu-h100:1", "replicas": 1}}))
    tman.main(["--models", str(models), "--kinds", "Pod"])
    (pod,) = list(yaml.safe_load_all(capsys.readouterr().out))
    _check_cuda_pod(pod)
