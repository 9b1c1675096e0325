"""Ollama engine pod generator.

Port of kubeai_tpu/controller/engines/ollama.py: the JAX package's code,
its imports in this package.

Parity: internal/modelcontroller/engine_ollama.go:13-213 — the server
starts `ollama serve`, and model availability is driven by a startup
probe exec script that pulls (or copies from a mounted PVC path) then
`ollama cp`s the model to its served name; OLLAMA_KEEP_ALIVE is pinned
effectively-forever so the model stays resident.
"""

from __future__ import annotations

from kubeai_tpu_torch.api.core_types import Container, Pod, Probe
from kubeai_tpu_torch.controller.engines.common import (
    MODEL_PORT,
    ModelPodConfig,
    base_pod,
)


def ollama_startup_script(src, served_name: str, insecure: bool) -> str:
    """The probe-exec script (parity: engine_ollama.go:173-213)."""
    if src.scheme == "pvc":
        pull = f"/bin/ollama create {served_name} -f /model/Modelfile"
        return f"/bin/ollama list | grep -q {served_name} || ({pull})"
    flags = " --insecure" if insecure else ""
    model = src.ollama_model
    lines = [
        f"/bin/ollama list | grep -q '^{served_name}' && exit 0",
        f"/bin/ollama pull{flags} {model}",
        f"/bin/ollama cp {model} {served_name}",
    ]
    return " && ".join(lines[1:]) if served_name == model else "; ".join(lines)


def ollama_pod_for_model(model, cfg: ModelPodConfig) -> Pod:
    src = cfg.source
    env = {
        "OLLAMA_HOST": f"0.0.0.0:{MODEL_PORT}",
        # Keep the model loaded indefinitely (ref: engine_ollama.go:31-34).
        "OLLAMA_KEEP_ALIVE": "999999h",
    }
    if cfg.cache_mount_path:
        env["OLLAMA_MODELS"] = cfg.cache_mount_path

    container = Container(command=["/bin/ollama"], args=["serve"], env=env)
    script = ollama_startup_script(src, model.meta.name, src.insecure)
    # Startup probe runs the pull script; readiness checks the API.
    container.startup_probe = Probe(
        path="exec:" + script, port=MODEL_PORT, failure_threshold=360, period_seconds=10
    )
    container.readiness_probe = Probe(path="/", port=MODEL_PORT, period_seconds=5)
    container.liveness_probe = Probe(path="/", port=MODEL_PORT, period_seconds=10)
    return base_pod(model, cfg, container)
