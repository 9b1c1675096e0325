"""Curated model catalog + manifest loading (port of kubeai_tpu/catalog.py).

The JAX catalog's entries with the framework's own engine (``TPUEngine``,
here the CUDA engine) on ``nvidia-gpu-h100`` profiles, sized to the
card's 80 GB in bf16: one card for the 2-8B models, two for
Mixtral-8x7B (93 GB), four for Llama-3.1-70B (141 GB). The CPU entries
of third-party engines are the JAX catalog's; its vLLM-TPU entry has no
TPU profile here and is left out. ``apply_manifest_file`` reads YAML
(PyYAML, imported only there).
"""

from __future__ import annotations

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.model_types import (
    LoadBalancing,
    Model,
    ModelSpec,
    PrefixHash,
    default_model,
    validate_model,
)
from kubeai_tpu_torch.runtime.store import AlreadyExists, ObjectMeta, Store

CATALOG: dict[str, ModelSpec] = {
    # -- the native engine on H100s --------------------------------------------
    "llama-3.1-8b-instruct-h100": ModelSpec(
        url="hf://meta-llama/Llama-3.1-8B-Instruct",
        engine=mt.ENGINE_TPU,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="nvidia-gpu-h100:1",
        args=["--max-seq-len", "8192"],
        min_replicas=0,
        target_requests=64,
    ),
    "llama-3.1-70b-instruct-h100": ModelSpec(
        url="hf://meta-llama/Llama-3.1-70B-Instruct",
        engine=mt.ENGINE_TPU,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="nvidia-gpu-h100:4",
        args=["--max-seq-len", "8192"],
        min_replicas=0,
        target_requests=32,
        load_balancing=LoadBalancing(strategy=mt.PREFIX_HASH_STRATEGY, prefix_hash=PrefixHash()),
    ),
    "gemma-2b-it-h100": ModelSpec(
        url="hf://google/gemma-2b-it",
        engine=mt.ENGINE_TPU,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="nvidia-gpu-h100:1",
        min_replicas=0,
    ),
    "qwen2.5-7b-instruct-h100": ModelSpec(
        url="hf://Qwen/Qwen2.5-7B-Instruct",
        engine=mt.ENGINE_TPU,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="nvidia-gpu-h100:1",
        min_replicas=0,
    ),
    "mixtral-8x7b-instruct-h100": ModelSpec(
        url="hf://mistralai/Mixtral-8x7B-Instruct-v0.1",
        engine=mt.ENGINE_TPU,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="nvidia-gpu-h100:2",
        min_replicas=0,
        load_balancing=LoadBalancing(strategy=mt.PREFIX_HASH_STRATEGY, prefix_hash=PrefixHash()),
    ),
    # -- CPU / aux engines ---------------------------------------------------
    "gemma2-2b-cpu": ModelSpec(
        url="ollama://gemma2:2b",
        engine=mt.ENGINE_OLLAMA,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="cpu:2",
        min_replicas=0,
    ),
    "qwen2.5-0.5b-cpu": ModelSpec(
        url="ollama://qwen2.5:0.5b",
        engine=mt.ENGINE_OLLAMA,
        features=[mt.FEATURE_TEXT_GENERATION],
        resource_profile="cpu:1",
        min_replicas=0,
    ),
    "nomic-embed-text-cpu": ModelSpec(
        url="hf://nomic-ai/nomic-embed-text-v1.5",
        engine=mt.ENGINE_INFINITY,
        features=[mt.FEATURE_TEXT_EMBEDDING],
        resource_profile="cpu:1",
        min_replicas=0,
    ),
    "bge-embed-text-cpu": ModelSpec(
        url="hf://BAAI/bge-small-en-v1.5",
        engine=mt.ENGINE_INFINITY,
        features=[mt.FEATURE_TEXT_EMBEDDING],
        resource_profile="cpu:1",
        min_replicas=0,
    ),
    "faster-whisper-medium-en-cpu": ModelSpec(
        url="hf://Systran/faster-whisper-medium.en",
        engine=mt.ENGINE_FASTER_WHISPER,
        features=[mt.FEATURE_SPEECH_TO_TEXT],
        resource_profile="cpu:1",
        min_replicas=0,
    ),
}


def model_from_catalog(name: str, **overrides) -> Model:
    import copy

    spec = copy.deepcopy(CATALOG[name])
    for k, v in overrides.items():
        setattr(spec, k, v)
    m = Model(meta=ObjectMeta(name=name), spec=spec)
    default_model(m)
    validate_model(m)
    return m


def apply_catalog(store: Store, names: list[str] | None = None) -> list[Model]:
    out = []
    for name in names or list(CATALOG):
        m = model_from_catalog(name)
        try:
            out.append(store.create(mt.KIND_MODEL, m))
        except AlreadyExists:
            pass
    return out


# -- YAML manifests ---------------------------------------------------------


def model_from_manifest(doc: dict) -> Model:
    """Build a Model from a k8s-style manifest dict (apiVersion/kind/
    metadata/spec with camelCase fields). Uses the same generic
    camelCase-to-dataclass builder as the system config, so unknown spec
    fields are rejected rather than silently dropped."""
    from kubeai_tpu_torch.config.system import _build

    spec_doc = dict(doc.get("spec", {}))
    # Manifest alias (reference CRD field name) -> dataclass field.
    lb = spec_doc.get("loadBalancing")
    if isinstance(lb, dict) and isinstance(lb.get("prefixHash"), dict):
        ph = dict(lb["prefixHash"])
        if "meanLoadFactor" in ph:
            ph["meanLoadPercentage"] = ph.pop("meanLoadFactor")
        spec_doc["loadBalancing"] = {**lb, "prefixHash": ph}
    spec = _build(ModelSpec, spec_doc)
    from kubeai_tpu_torch.runtime.k8s_parse import parse_meta

    m = Model(meta=parse_meta(doc), spec=spec)
    status_doc = doc.get("status") or {}
    if status_doc:
        reps = status_doc.get("replicas") or {}
        m.status.replicas_all = reps.get("all", 0)
        m.status.replicas_ready = reps.get("ready", 0)
        m.status.cache_loaded = (status_doc.get("cache") or {}).get("loaded", False)
    default_model(m)
    validate_model(m)
    return m


def apply_manifest_file(store: Store, path: str) -> list[Model]:
    import yaml

    out = []
    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if not doc:
                continue
            m = model_from_manifest(doc)
            try:
                out.append(store.create(mt.KIND_MODEL, m))
            except AlreadyExists:
                pass
    return out
