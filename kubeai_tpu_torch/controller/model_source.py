"""Model source URL parsing + credential/volume injection.

Port of kubeai_tpu/controller/model_source.py: the JAX package's code,
its imports in this package.

Parity: internal/modelcontroller/model_source.go:19-64,231-287. Schemes:
    hf://org/model[?param=...]      HuggingFace repo
    pvc://claim/path                pre-provisioned PVC
    ollama://model[:tag][?pull=..]  Ollama registry name
    s3://bucket/path  gs://  oss:// object storage
    file:///abs/path                local path (LocalRuntime / dev)
Query params: insecure, pull, model (engine-specific model id within the
source).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from urllib.parse import parse_qs, urlparse

from kubeai_tpu_torch.api.core_types import Container, Pod, Volume, VolumeMount
from kubeai_tpu_torch.config.system import SecretNames


@dataclass
class ModelSource:
    url: str = ""
    scheme: str = ""
    ref: str = ""  # everything after scheme://, before ?
    # Scheme-specific:
    huggingface_repo: str = ""
    pvc_name: str = ""
    pvc_subpath: str = ""
    ollama_model: str = ""
    bucket_url: str = ""  # s3/gs/oss full url without params
    local_path: str = ""
    # Params:
    insecure: bool = False
    pull: str = ""
    named_model: str = ""


def parse_model_source(url: str) -> ModelSource:
    parsed = urlparse(url)
    scheme = parsed.scheme
    if not scheme:
        raise ValueError(f"model url missing scheme: {url!r}")
    q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
    src = ModelSource(
        url=url,
        scheme=scheme,
        ref=(parsed.netloc + parsed.path).strip("/") if scheme != "file" else parsed.path,
        insecure=q.get("insecure", "").lower() in ("1", "true"),
        pull=q.get("pull", ""),
        named_model=q.get("model", ""),
    )
    if scheme == "hf":
        src.huggingface_repo = src.ref
        if src.huggingface_repo.count("/") != 1:
            raise ValueError(f"hf:// url must be hf://<org>/<model>: {url!r}")
    elif scheme == "pvc":
        parts = src.ref.split("/", 1)
        src.pvc_name = parts[0]
        src.pvc_subpath = parts[1] if len(parts) > 1 else ""
        if not src.pvc_name:
            raise ValueError(f"pvc:// url must name a claim: {url!r}")
    elif scheme == "ollama":
        src.ollama_model = src.ref
    elif scheme in ("s3", "gs", "oss"):
        src.bucket_url = url.split("?")[0]
    elif scheme == "file":
        src.local_path = parsed.path
    else:
        raise ValueError(f"unsupported model url scheme {scheme!r}")
    return src


@dataclass
class SourcePodAdditions:
    env: dict[str, str] = field(default_factory=dict)
    env_from_secrets: list[str] = field(default_factory=list)
    volumes: list[Volume] = field(default_factory=list)
    mounts: list[VolumeMount] = field(default_factory=list)


def source_pod_additions(src: ModelSource, secrets: SecretNames) -> SourcePodAdditions:
    """Credentials + volumes each source scheme needs in the server pod
    (parity: model_source.go:82-227)."""
    add = SourcePodAdditions()
    if src.scheme == "hf":
        add.env["HF_HOME"] = "/tmp/hf"
        add.env_from_secrets.append(secrets.huggingface)
    elif src.scheme == "s3":
        add.env_from_secrets.append(secrets.aws)
    elif src.scheme == "gs":
        add.env["GOOGLE_APPLICATION_CREDENTIALS"] = "/secrets/gcp/keyfile.json"
        add.env_from_secrets.append(secrets.gcp)
    elif src.scheme == "oss":
        add.env_from_secrets.append(secrets.alibaba)
    elif src.scheme == "pvc":
        add.volumes.append(Volume(name="model-source", pvc_name=src.pvc_name))
        add.mounts.append(
            VolumeMount(
                name="model-source",
                mount_path="/model",
                sub_path=src.pvc_subpath,
                read_only=True,
            )
        )
    elif src.scheme == "file":
        # Mounted at the same path as on the host so the container arg
        # (--model <path>) is valid in both cluster mode and LocalRuntime
        # (which has no mounts at all).
        add.volumes.append(Volume(name="model-source", host_path=src.local_path))
        add.mounts.append(VolumeMount(name="model-source", mount_path=src.local_path))
    return add


def apply_source_to_container(add: SourcePodAdditions, pod: Pod, container: Container):
    container.env.update(add.env)
    for s in add.env_from_secrets:
        container.env[f"__envFromSecret_{s}"] = s
    pod.spec.volumes.extend(add.volumes)
    container.volume_mounts.extend(add.mounts)
