"""Model resource types — the framework's "CRD".

Port of kubeai_tpu/api/model_types.py: the JAX package's code,
its imports in this package. ``ENGINES`` and ``validate_model`` are the
JAX package's, so a Model manifest validates the same in both.
``TPUEngine`` keeps its name as the framework's own engine; in this
package its pods run the CUDA engine (``kubeai_tpu_torch.engine.server``,
controller/engines/cuda.py).

Field-for-field parity with the reference Model CRD
(ref: api/k8s/v1/model_types.go:36-256) with TPU-first defaults; the
CEL validation rules there are enforced in validate() here
(ref: model_types.go:27-35,53-54 url schemes, adapter shape, files cap).
Label/annotation names match the reference (ref: api/k8s/v1/metadata.go)
so tooling ports over.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from kubeai_tpu_torch.runtime.store import ObjectMeta

KIND_MODEL = "Model"

# Engines. TPUEngine is this framework's own engine (here the CUDA one);
# the others mirror the reference's matrix (ref: internal/config/system.go:222-231).
ENGINE_TPU = "TPUEngine"  # kubeai_tpu_torch.engine.server
ENGINE_VLLM = "VLLM"  # vllm-tpu image
ENGINE_OLLAMA = "OLlama"
ENGINE_FASTER_WHISPER = "FasterWhisper"
ENGINE_INFINITY = "Infinity"
ENGINES = (ENGINE_TPU, ENGINE_VLLM, ENGINE_OLLAMA, ENGINE_FASTER_WHISPER, ENGINE_INFINITY)

FEATURE_TEXT_GENERATION = "TextGeneration"
FEATURE_TEXT_EMBEDDING = "TextEmbedding"
FEATURE_SPEECH_TO_TEXT = "SpeechToText"
FEATURES = (FEATURE_TEXT_GENERATION, FEATURE_TEXT_EMBEDDING, FEATURE_SPEECH_TO_TEXT)

LEAST_LOAD_STRATEGY = "LeastLoad"
PREFIX_HASH_STRATEGY = "PrefixHash"
# Benchmark-baseline strategy (the reference compares against a k8s
# Service's round-robin; here it is first-class and selectable).
ROUND_ROBIN_STRATEGY = "RoundRobin"

URL_SCHEMES = ("hf", "pvc", "ollama", "s3", "gs", "oss", "file")

# Label/annotation keys (parity: api/k8s/v1/metadata.go:3-31).
LABEL_MODEL = "model"
LABEL_POD_HASH = "pod-hash"
LABEL_FEATURE_PREFIX = "features.kubeai.org/"
LABEL_ADAPTER_PREFIX = "adapter.kubeai.org/"
ANNOTATION_MODEL_POD_IP = "model-pod-ip"
ANNOTATION_MODEL_POD_PORT = "model-pod-port"
# Phase role of a disaggregated serving pod (kubeai_tpu/disagg):
# "prefill" | "decode"; absent on unified pods.
LABEL_ROLE = "kubeai.org/role"

_ADAPTER_NAME_RE = re.compile(r"^[a-z0-9]+(?:[-._][a-z0-9]+)*$")
_RESOURCE_PROFILE_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9-_.]*:\d+$")


@dataclass
class PrefixHash:
    mean_load_percentage: int = 125
    replication: int = 256
    prefix_char_length: int = 100


@dataclass
class LoadBalancing:
    strategy: str = LEAST_LOAD_STRATEGY
    prefix_hash: PrefixHash = field(default_factory=PrefixHash)


@dataclass
class Disaggregation:
    """Disaggregated prefill/decode serving (docs/disaggregation.md):
    the model runs as TWO pod pools — prefill replicas that serve the
    prompt phase and the first ``handoff_tokens`` stream events, and
    decode replicas that take over via replay-based handoff. Pools are
    scaled independently (prefill on queue-wait pressure, decode on
    slot/KV occupancy), so a burst of long prompts can no longer
    degrade decode TPOT by stealing decode batch slots."""

    enabled: bool = False
    # Per-pool replica counts — mutated by the autoscaler's per-pool
    # decisions (ModelClient.scale_pool), never by spec.replicas.
    prefill_replicas: int = 1
    decode_replicas: int = 1
    max_prefill_replicas: int | None = None
    max_decode_replicas: int | None = None
    # K: stream events served from the prefill pool before the proxy
    # hands the request off to a decode replica (engine-side the
    # prefill replica caps generation at this budget).
    handoff_tokens: int = 8
    # Autoscaling targets, one per pool — deliberately DIFFERENT
    # signals: queued-work-per-replica for prefill (TTFT pressure),
    # percent slot/KV occupancy for decode (TPOT pressure).
    prefill_target_queue: int = 4
    decode_target_occupancy_pct: int = 80


@dataclass
class Adapter:
    name: str = ""
    url: str = ""


@dataclass
class File:
    path: str = ""
    content: str = ""


@dataclass
class ModelSpec:
    url: str = ""
    engine: str = ENGINE_TPU
    features: list[str] = field(default_factory=lambda: [FEATURE_TEXT_GENERATION])
    resource_profile: str = ""  # "<name>:<count>"
    cache_profile: str = ""
    adapters: list[Adapter] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    replicas: int | None = None
    min_replicas: int = 0
    max_replicas: int | None = None
    autoscaling_disabled: bool = False
    target_requests: int = 100
    scale_down_delay_seconds: int = 30
    load_balancing: LoadBalancing = field(default_factory=LoadBalancing)
    disaggregation: Disaggregation = field(default_factory=Disaggregation)
    files: list[File] = field(default_factory=list)
    priority_class_name: str = ""
    owner: str = ""


@dataclass
class ModelStatus:
    replicas_all: int = 0
    replicas_ready: int = 0
    cache_loaded: bool = False


@dataclass
class Model:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ModelSpec = field(default_factory=ModelSpec)
    status: ModelStatus = field(default_factory=ModelStatus)


class ValidationError(ValueError):
    pass


def validate_model(m: Model, prev: Model | None = None) -> None:
    """Admission-time validation; parity with the reference's CEL rules
    plus controller-side checks."""
    s = m.spec
    scheme = s.url.split("://", 1)[0] if "://" in s.url else ""
    if scheme not in URL_SCHEMES:
        raise ValidationError(
            f"url must use one of schemes {URL_SCHEMES}, got {s.url!r}"
        )
    if s.engine not in ENGINES:
        raise ValidationError(f"engine must be one of {ENGINES}")
    for f in s.features:
        if f not in FEATURES:
            raise ValidationError(f"unknown feature {f!r}")
    if s.resource_profile and not _RESOURCE_PROFILE_RE.match(s.resource_profile):
        raise ValidationError("resourceProfile must look like '<name>:<count>'")
    if len(s.files) > 10:
        raise ValidationError("at most 10 files per model")
    seen_paths = set()
    for f in s.files:
        if not f.path or len(f.path) > 1024:
            raise ValidationError("file path must be 1..1024 chars")
        if len(f.content) > 100_000:
            raise ValidationError("file content must be <= 100k chars")
        if f.path in seen_paths:
            raise ValidationError(f"duplicate file path {f.path}")
        seen_paths.add(f.path)
    seen_adapters = set()
    for a in s.adapters:
        if not _ADAPTER_NAME_RE.match(a.name or ""):
            raise ValidationError(f"invalid adapter name {a.name!r}")
        if "_" in a.name:
            raise ValidationError("adapter name must not contain '_'")
        if a.name in seen_adapters:
            raise ValidationError(f"duplicate adapter {a.name}")
        seen_adapters.add(a.name)
        a_scheme = a.url.split("://", 1)[0] if "://" in a.url else ""
        if a_scheme not in URL_SCHEMES:
            raise ValidationError(f"adapter url scheme invalid: {a.url!r}")
    if s.replicas is not None and s.replicas < 0:
        raise ValidationError("replicas must be >= 0")
    if s.min_replicas < 0:
        raise ValidationError("minReplicas must be >= 0")
    if s.max_replicas is not None and s.min_replicas > s.max_replicas:
        raise ValidationError("minReplicas must be <= maxReplicas")
    if s.target_requests < 1:
        raise ValidationError("targetRequests must be >= 1")
    if s.load_balancing.strategy not in (LEAST_LOAD_STRATEGY, PREFIX_HASH_STRATEGY, ROUND_ROBIN_STRATEGY):
        raise ValidationError(f"unknown load balancing strategy {s.load_balancing.strategy!r}")
    ph = s.load_balancing.prefix_hash
    if not (100 <= ph.mean_load_percentage):
        raise ValidationError("prefixHash.meanLoadPercentage must be >= 100")
    dz = s.disaggregation
    if dz.enabled:
        if s.engine != ENGINE_TPU:
            raise ValidationError(
                "disaggregation requires the TPUEngine (role-aware serving)"
            )
        if dz.handoff_tokens < 1:
            raise ValidationError("disaggregation.handoffTokens must be >= 1")
        # Pools never scale to zero: an empty prefill pool would turn
        # every new stream into a cold start, and an empty decode pool
        # would strand every handoff.
        if dz.prefill_replicas < 1 or dz.decode_replicas < 1:
            raise ValidationError("disaggregation pool replicas must be >= 1")
        if dz.max_prefill_replicas is not None and dz.max_prefill_replicas < dz.prefill_replicas:
            raise ValidationError("maxPrefillReplicas must be >= prefillReplicas")
        if dz.max_decode_replicas is not None and dz.max_decode_replicas < dz.decode_replicas:
            raise ValidationError("maxDecodeReplicas must be >= decodeReplicas")
        if dz.prefill_target_queue < 1:
            raise ValidationError("disaggregation.prefillTargetQueue must be >= 1")
        if not (1 <= dz.decode_target_occupancy_pct <= 100):
            raise ValidationError(
                "disaggregation.decodeTargetOccupancyPct must be in [1, 100]"
            )
    # Immutability (CEL parity: url/engine immutable post-create).
    if prev is not None:
        if s.url != prev.spec.url:
            raise ValidationError("url is immutable")
        if s.engine != prev.spec.engine:
            raise ValidationError("engine is immutable")


def default_model(m: Model) -> None:
    """Apply defaulting (parity with CRD defaults)."""
    s = m.spec
    if s.max_replicas is None and s.min_replicas > 0 and not s.autoscaling_disabled:
        pass  # max stays unbounded until set
    if s.replicas is None and s.autoscaling_disabled:
        s.replicas = max(s.min_replicas, 1)


def feature_labels(m: Model) -> dict[str, str]:
    return {LABEL_FEATURE_PREFIX + f: "true" for f in m.spec.features}
