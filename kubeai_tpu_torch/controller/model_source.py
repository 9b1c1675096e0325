"""Model source URLs (port of kubeai_tpu/controller/model_source.py:
``ModelSource`` and ``parse_model_source``; the pod and volume injection
stays with the operator). Schemes:
    hf://org/model[?param=...]      HuggingFace repo
    pvc://claim/path                pre-provisioned PVC
    ollama://model[:tag][?pull=..]  Ollama registry name
    s3://bucket/path  gs://  oss:// object storage
    file:///abs/path                local path
Query params: insecure, pull, model (engine-specific model id within the
source).
"""

from __future__ import annotations

from dataclasses import dataclass
from urllib.parse import parse_qs, urlparse


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
