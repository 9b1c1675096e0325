"""The port's operator types and configuration (kubeai_tpu_torch/api,
config/system.py, catalog.py) against the JAX package's, on the CPU.

- The cases of tests/test_model_types.py, test_openai_validation.py and
  test_config.py run through both packages (tests/_torch_operator.py):
  ``validate_model``, ``body_for_path`` and ``load_system_config`` give
  equal results and equal errors on each test's inputs. Configurations
  differ only where the port means to: the default resource profiles
  (``cpu`` and ``nvidia-gpu-h100`` for the TPU podslices) and the
  ``TPUEngine`` image.
- ``model_from_manifest`` (``validate_model`` at its end) accepts and
  refuses the same manifests: every file of deploy/models/ and seeded
  mutations of them (hypothesis, derandomized), with equal Models or
  equal errors.
- ``System().default_and_validate()`` is the JAX one but for those two
  differences; the ``nvidia-gpu-h100`` profile requests and limits one
  ``nvidia.com/gpu`` on the H100 node label.
- The catalog's native entries validate and run the CUDA engine on
  ``nvidia-gpu-h100`` profiles.
"""

import copy
import dataclasses
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_config as jtest_config
import test_model_types as jtest_model_types
import test_openai_validation as jtest_openai
from _torch_operator import Dual, jax_cases, plain, run_jax_case
from kubeai_tpu import catalog as jcat
from kubeai_tpu.config import system as jsys
from kubeai_tpu_torch import catalog as tcat
from kubeai_tpu_torch.api import model_types as tmt
from kubeai_tpu_torch.config import system as tsys

MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "deploy", "models")


def _normalized(system, module):
    """plain(system) with the package's own defaults (profiles and the
    TPUEngine image) named, not spelled out."""
    doc = plain(system)
    fields = doc[1]
    defaults = (module.default_tpu_profiles() if module is jsys else
                module.default_gpu_profiles())
    if fields["resource_profiles"] == plain(defaults):
        fields["resource_profiles"] = "<package default>"
    tpu = fields["engine_images"].get("TPUEngine")
    want = "kubeai-tpu/engine:latest" if module is jsys else tsys.CUDA_ENGINE_IMAGE
    if tpu and tpu[1]["default"] == want:
        tpu[1]["default"] = "<package default>"
    return doc


def _same_system(j, t):
    return _normalized(j, jsys) == _normalized(t, tsys)


CASES = (
    jax_cases(jtest_model_types)
    + jax_cases(jtest_openai)
    # test_defaults and test_consecutive_scale_downs call no wrapped
    # function: the defaults are held below.
    + jax_cases(jtest_config, skip=("test_defaults", "test_consecutive_scale_downs"))
)
WRAP = {jtest_model_types: ("validate_model",),
        jtest_openai: ("body_for_path", "kubeai_tpu.proxy.apiutils:parse_request")}


@pytest.mark.parametrize("module,qual,params", CASES)
def test_jax_cases_through_both_packages(module, qual, params, request, monkeypatch):
    if module is jtest_config:
        d = Dual(jsys.load_system_config, tsys.load_system_config, same=_same_system)
        monkeypatch.setattr(module, "load_system_config", d)
        calls = run_jax_case(module, qual, params, (), request, monkeypatch) + d.calls
    else:
        calls = run_jax_case(module, qual, params, WRAP[module], request, monkeypatch)
    assert calls > 0, "the case called neither package"


def test_system_defaults_differ_only_in_profiles_and_image():
    j, t = jsys.System().default_and_validate(), tsys.System().default_and_validate()
    jd, td = plain(j), plain(t)
    assert set(td[1]["resource_profiles"]) == {"cpu", "nvidia-gpu-h100"}
    assert td[1]["resource_profiles"]["cpu"] == jd[1]["resource_profiles"]["cpu"]
    h100 = t.resource_profiles["nvidia-gpu-h100"]
    assert h100.requests == h100.limits == {"nvidia.com/gpu": "1"}
    assert h100.node_selector == {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    assert h100.hosts_per_replica == 1
    assert t.engine_images["TPUEngine"].default == "kubeai-tpu/engine-cuda:latest"
    assert _same_system(j, t)
    # Every other engine image and every other default is the JAX one.
    for name in ("VLLM", "OLlama", "FasterWhisper", "Infinity"):
        assert plain(t.engine_images[name]) == plain(j.engine_images[name])
    # The same checks refuse the same settings.
    for bad in ({"autoscaling": {"intervalSeconds": 0}}, {"modelRollouts": {"surge": -1}},
                {"resourceProfiles": {"x": {"hostsPerReplica": 0}}}, {"bogus": 1},
                {"autoscaling": {"intervalSeconds": 10, "timeWindowSeconds": 5}}):
        with pytest.raises(ValueError) as je:
            jsys.load_system_config(data=copy.deepcopy(bad))
        with pytest.raises(ValueError) as te:
            tsys.load_system_config(data=copy.deepcopy(bad))
        assert str(je.value) == str(te.value)


def _manifests():
    out = []
    for name in sorted(os.listdir(MODELS_DIR)):
        with open(os.path.join(MODELS_DIR, name)) as f:
            out.extend(d for d in yaml.safe_load_all(f) if d)
    return out


MANIFESTS = _manifests()


def _both(doc):
    """(JAX result, port result): a Model or the error's (type, text)."""
    out = []
    for cat in (jcat, tcat):
        try:
            out.append(plain(cat.model_from_manifest(copy.deepcopy(doc))))
        except Exception as e:  # the refusal itself is compared
            out.append((type(e).__name__, str(e)))
    return out


def test_every_deploy_manifest_validates_the_same():
    assert len(MANIFESTS) >= 10
    for doc in MANIFESTS:
        j, t = _both(doc)
        assert j == t, doc["metadata"]["name"]
        assert j[0] == "Model"


MUTATIONS = {
    "url": st.sampled_from(["hf://a/b", "s3://b/k", "gs://b/k", "file:///m", "pvc://p/x",
                            "http://x", "ftp://y", "", "ollama://m:1", "oss://b/k"]),
    "engine": st.sampled_from(["TPUEngine", "VLLM", "OLlama", "FasterWhisper",
                               "Infinity", "Triton", ""]),
    "features": st.lists(st.sampled_from(["TextGeneration", "TextEmbedding",
                                          "SpeechToText", "Vision"]), max_size=3),
    "resourceProfile": st.sampled_from(["cpu:1", "nvidia-gpu-h100:2", "tpu-v5e-2x2:1",
                                        "bad", "x:", ":1", ""]),
    "replicas": st.one_of(st.none(), st.integers(-2, 4)),
    "minReplicas": st.integers(-1, 3),
    "maxReplicas": st.one_of(st.none(), st.integers(-1, 4)),
    "targetRequests": st.integers(-1, 200),
    "adapters": st.lists(st.fixed_dictionaries({
        "name": st.sampled_from(["a", "b-1", "bad_name", "", "Up"]),
        "url": st.sampled_from(["hf://x/y", "s3://b/a", "nope"])}), max_size=3),
    "files": st.lists(st.fixed_dictionaries({
        "path": st.sampled_from(["/a", "/b", ""]), "content": st.just("x")}), max_size=3),
    "loadBalancing": st.fixed_dictionaries({
        "strategy": st.sampled_from(["LeastLoad", "PrefixHash", "RoundRobin", "Random"]),
        "prefixHash": st.fixed_dictionaries({"meanLoadFactor": st.integers(90, 200)})}),
    "autoscalingDisabled": st.booleans(),
    "bogusField": st.just(1),
}


@settings(max_examples=120, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_mutated_manifests_validate_the_same(data):
    doc = copy.deepcopy(data.draw(st.sampled_from(MANIFESTS)))
    for key in data.draw(st.lists(st.sampled_from(sorted(MUTATIONS)), min_size=1, max_size=3,
                                  unique=True)):
        doc["spec"][key] = data.draw(MUTATIONS[key])
    j, t = _both(doc)
    assert j == t


def test_catalog_native_entries_run_the_cuda_engine():
    from kubeai_tpu_torch.config.system import System
    from kubeai_tpu_torch.controller import engines
    from kubeai_tpu_torch.controller.controller import ModelReconciler
    from kubeai_tpu_torch.runtime.store import Store

    rec = ModelReconciler(Store(), System().default_and_validate())
    native = [n for n, s in tcat.CATALOG.items() if s.engine == tmt.ENGINE_TPU]
    assert len(native) == 5
    for name in tcat.CATALOG:
        m = tcat.model_from_catalog(name)  # validate_model passes
        m.meta.uid = "u"
        pod = engines.pod_for_model(m, rec.resolve_pod_config(m))
        c = pod.spec.containers[0]
        if name in native:
            assert m.spec.resource_profile.startswith("nvidia-gpu-h100:")
            assert c.command == ["python", "-m", "kubeai_tpu_torch.engine.server"]
            gpus = int(m.spec.resource_profile.split(":")[1])
            assert c.resources_limits == {"nvidia.com/gpu": str(gpus)}
            assert c.args[c.args.index("--tensor-parallel-size") + 1] == str(gpus)
    # The CPU entries are the JAX catalog's.
    for name, spec in tcat.CATALOG.items():
        if spec.engine != tmt.ENGINE_TPU:
            assert plain(spec) == plain(jcat.CATALOG[name])
    assert dataclasses.is_dataclass(tcat.CATALOG[native[0]])
