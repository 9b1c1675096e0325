"""System configuration (port of kubeai_tpu/config/system.py).

One YAML/dict config with defaulting + validation, the JAX package's
fields, defaults and checks, with two changes for the card: the default
resource profiles are ``cpu`` and ``nvidia-gpu-h100`` (``nvidia.com/gpu``
requests and limits, the GPU product node selector) instead of TPU
podslices, and the ``TPUEngine`` image, the framework's own engine, is
the CUDA engine's (``kubeai_tpu_torch/Dockerfile.engine``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


# The tag kubeai_tpu_torch/Dockerfile.engine builds.
CUDA_ENGINE_IMAGE = "kubeai-tpu/engine-cuda:latest"


@dataclass
class ResourceProfile:
    requests: dict[str, str] = field(default_factory=dict)
    limits: dict[str, str] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[dict] = field(default_factory=list)
    affinity: dict = field(default_factory=dict)
    scheduler_name: str = ""
    runtime_class_name: str = ""
    image_name: str = ""
    # TPU topology (drives multi-host slice orchestration; new vs reference)
    tpu_topology: str = ""  # e.g. "2x4"
    hosts_per_replica: int = 1  # >1 => multi-host slice gang


@dataclass
class CacheProfile:
    shared_filesystem_storage_class: str = ""
    shared_filesystem_storage: str = "100Gi"


@dataclass
class EngineImages:
    default: str = ""
    profiles: dict[str, str] = field(default_factory=dict)  # profile name -> image

    def for_profile(self, profile_name: str) -> str:
        return self.profiles.get(profile_name, self.default)


@dataclass
class Autoscaling:
    interval_seconds: float = 10.0
    time_window_seconds: float = 600.0
    state_config_map_name: str = "kubeai-autoscaler-state"

    def consecutive_scale_downs_for(self, scale_down_delay_seconds: float) -> int:
        """How many consecutive scale-down decisions before acting
        (parity: internal/config/system.go:138-140)."""
        import math

        return int(math.ceil(scale_down_delay_seconds / self.interval_seconds))

    @property
    def average_window_count(self) -> int:
        import math

        return int(math.ceil(self.time_window_seconds / self.interval_seconds))


@dataclass
class MessageStream:
    requests_url: str = ""
    responses_url: str = ""
    max_handlers: int = 1


@dataclass
class ModelRollouts:
    surge: int = 1


@dataclass
class SecretNames:
    huggingface: str = "kubeai-huggingface"
    aws: str = "kubeai-aws"
    gcp: str = "kubeai-gcp"
    alibaba: str = "kubeai-alibaba"


@dataclass
class ModelServerPods:
    service_account_name: str = ""
    image_pull_secrets: list[str] = field(default_factory=list)
    json_patches: list[dict] = field(default_factory=list)
    security_context: dict = field(default_factory=dict)


@dataclass
class System:
    secret_names: SecretNames = field(default_factory=SecretNames)
    resource_profiles: dict[str, ResourceProfile] = field(default_factory=dict)
    cache_profiles: dict[str, CacheProfile] = field(default_factory=dict)
    engine_images: dict[str, EngineImages] = field(default_factory=dict)
    model_loader_image: str = "kubeai-tpu/model-loader:latest"
    autoscaling: Autoscaling = field(default_factory=Autoscaling)
    streams: list[MessageStream] = field(default_factory=list)
    messaging_error_max_backoff_seconds: float = 30.0
    model_rollouts: ModelRollouts = field(default_factory=ModelRollouts)
    model_server_pods: ModelServerPods = field(default_factory=ModelServerPods)
    metrics_addr: str = ":8080"
    api_addr: str = ":8000"
    allow_pod_address_override: bool = False
    fixed_self_metric_addrs: list[str] = field(default_factory=list)
    leader_election_lease_seconds: float = 15.0
    # Parked-replica pool (cold-start fast path): keep N pre-warmed
    # engine processes holding compiled programs but no weights;
    # scale-from-zero ATTACHES a model to one instead of cold-spawning.
    # parked_args are extra engine-server args for the parked pods
    # (e.g. --park-config <ckpt> to AOT-warm a model's shapes at park
    # time, or engine shape flags matching the expected Models).
    parked_replicas: int = 0
    parked_args: list[str] = field(default_factory=list)
    # "<profile>[:count]" applied to parked pods so they schedule like
    # model pods on a real cluster (TPU requests, node selector);
    # LocalRuntime ignores scheduling fields, so it is optional there.
    parked_resource_profile: str = ""
    # Opt-in: cache loader Jobs ALSO warm the shared compile cache
    # (--warm-compile-cache) against the staged checkpoint's shapes.
    cache_warm_compile: bool = False

    def default_and_validate(self) -> "System":
        # Default engine images (parity with the reference matrix shape,
        # TPU-first contents).
        defaults = {
            "TPUEngine": EngineImages(default=CUDA_ENGINE_IMAGE),
            "VLLM": EngineImages(
                default="vllm/vllm-openai:latest",
                profiles={"google-tpu": "vllm/vllm-tpu:latest"},
            ),
            "OLlama": EngineImages(default="ollama/ollama:latest"),
            "FasterWhisper": EngineImages(
                default="fedirz/faster-whisper-server:latest-cpu"
            ),
            "Infinity": EngineImages(default="michaelf34/infinity:latest"),
        }
        for name, imgs in defaults.items():
            self.engine_images.setdefault(name, imgs)
        if not self.resource_profiles:
            self.resource_profiles = default_gpu_profiles()
        for name, prof in self.resource_profiles.items():
            if prof.hosts_per_replica < 1:
                raise ValueError(f"resourceProfile {name}: hostsPerReplica must be >= 1")
        if self.autoscaling.interval_seconds <= 0:
            raise ValueError("autoscaling.interval must be > 0")
        if self.autoscaling.time_window_seconds < self.autoscaling.interval_seconds:
            raise ValueError("autoscaling.timeWindow must be >= interval")
        if self.model_rollouts.surge < 0:
            raise ValueError("modelRollouts.surge must be >= 0")
        return self


def default_gpu_profiles() -> dict[str, ResourceProfile]:
    """The card's resource profiles: ``cpu`` (the JAX package's) and one
    H100 per count, scheduled by the NVIDIA device plugin's resource and
    GPU feature discovery's product label."""

    def gpu(product: str) -> ResourceProfile:
        return ResourceProfile(
            requests={"nvidia.com/gpu": "1"},
            limits={"nvidia.com/gpu": "1"},
            node_selector={"nvidia.com/gpu.product": product},
        )

    return {
        "cpu": ResourceProfile(requests={"cpu": "1", "memory": "2Gi"}),
        "nvidia-gpu-h100": gpu("NVIDIA-H100-80GB-HBM3"),
    }


def _snake(k: str) -> str:
    out = []
    for ch in k:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _build(cls, data):
    """Recursively build a dataclass from a (camelCase or snake_case) dict."""
    import dataclasses
    import typing

    if not dataclasses.is_dataclass(cls) or not isinstance(data, dict):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    # PEP 563 (future annotations) stores field types as strings; resolve.
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for k, v in data.items():
        name = _snake(k)
        f = fields.get(name)
        if f is None:
            raise ValueError(f"unknown config field {k!r} for {cls.__name__}")
        kwargs[name] = _coerce(hints.get(name), v)
    return cls(**kwargs)


def _coerce(ftype, v):
    """Coerce a parsed value to its (resolved) field type: nested
    dataclasses, dict[str, Dataclass], and list[Dataclass] are built
    recursively; everything else passes through."""
    import dataclasses
    import typing

    if ftype is None:
        return v
    if dataclasses.is_dataclass(ftype):
        return _build(ftype, v)
    origin = typing.get_origin(ftype)
    args = typing.get_args(ftype)
    if origin is dict and args and dataclasses.is_dataclass(args[1]) and isinstance(v, dict):
        return {k: _build(args[1], item) for k, item in v.items()}
    if origin is list and args and dataclasses.is_dataclass(args[0]) and isinstance(v, list):
        return [_build(args[0], item) for item in v]
    return v


def _reference_compat(data: dict) -> dict:
    """Accept the reference's config spellings alongside ours, so a
    kubeai values.yaml / system ConfigMap ports over unchanged:

    - modelServers.<E>.images.{default,<profile>: img}  ->
      engineImages.<E>.{default, profiles}
      (ref: internal/config/system.go:222-231)
    - cacheProfiles.<N>.sharedFilesystem.{storageClassName,size} ->
      flat sharedFilesystemStorageClass / sharedFilesystemStorage
      (ref: internal/config/system.go:202-212)
    - modelLoading.image -> modelLoaderImage
    """
    data = dict(data)
    servers = data.pop("modelServers", None)
    if servers and "engineImages" not in data:
        images = {}
        for engine, cfg in servers.items():
            imgs = dict((cfg or {}).get("images") or {})
            images[engine] = {
                "default": imgs.pop("default", ""),
                "profiles": imgs,
            }
        data["engineImages"] = images
    loading = data.pop("modelLoading", None)
    if loading and "modelLoaderImage" not in data:
        if loading.get("image"):
            data["modelLoaderImage"] = loading["image"]
    caches = data.get("cacheProfiles")
    if isinstance(caches, dict):
        converted = {}
        for name, prof in caches.items():
            prof = dict(prof or {})
            shared = prof.pop("sharedFilesystem", None)
            if shared:
                prof.setdefault(
                    "sharedFilesystemStorageClass", shared.get("storageClassName", "")
                )
                prof.setdefault(
                    "sharedFilesystemStorage", shared.get("size", "100Gi")
                )
            converted[name] = prof
        data["cacheProfiles"] = converted
    messaging = data.pop("messaging", None)
    if messaging and "streams" not in data:
        data["streams"] = messaging.get("streams") or []
        if "errorMaxBackoffSeconds" in messaging:
            data["messagingErrorMaxBackoffSeconds"] = messaging["errorMaxBackoffSeconds"]
    if isinstance(data.get("streams"), list):
        # The reference spells requestsURL/responsesURL (capitalized
        # initialism); normalize to camelCase for the field mapper.
        data["streams"] = [
            {
                {"requestsURL": "requestsUrl", "responsesURL": "responsesUrl"}.get(k, k): v
                for k, v in (s or {}).items()
            }
            for s in data["streams"]
        ]
    return data


def load_system_config(path: str | None = None, data: dict | None = None) -> System:
    """Load from YAML file or dict (CONFIG_PATH equivalent,
    ref: cmd/main.go:40-46). Accepts both this framework's spellings and
    the reference's (see _reference_compat)."""
    if path is not None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    sys_ = _build(System, _reference_compat(data or {}))
    return sys_.default_and_validate()
