"""vLLM engine pod generator (vllm-tpu images on TPU profiles).

Port of kubeai_tpu/controller/engines/vllm.py: the JAX package's code,
its imports in this package.

Behavioral parity with the reference's generator
(ref: internal/modelcontroller/engine_vllm.go:12-167): --model /
--served-model-name args, s3 via runai-streamer, LoRA enablement env,
/dev/shm emptyDir, 3h startup probe.
"""

from __future__ import annotations

from kubeai_tpu_torch.api.core_types import Container, Pod, Volume, VolumeMount
from kubeai_tpu_torch.controller.engines.common import (
    MODEL_PORT,
    ModelPodConfig,
    base_pod,
    default_probes,
)


def vllm_pod_for_model(model, cfg: ModelPodConfig) -> Pod:
    src = cfg.source
    if src.scheme == "hf":
        model_arg = src.huggingface_repo
    elif src.scheme == "pvc":
        model_arg = "/model"
    elif src.scheme == "file":
        model_arg = src.local_path  # mounted at the same path
    elif src.scheme == "s3":
        # vLLM loads s3 urls directly via the runai streamer
        # (ref: engine_vllm.go:20-41).
        model_arg = src.bucket_url
    else:
        model_arg = cfg.cache_mount_path or "/model"
    if cfg.cache_mount_path:
        model_arg = cfg.cache_mount_path

    args = ["--model", model_arg, "--served-model-name", model.meta.name, "--port", str(MODEL_PORT)]
    if src.scheme == "s3":
        args += ["--load-format", "runai_streamer"]
    args += list(model.spec.args)

    env = {}
    if model.spec.adapters:
        # ref: engine_vllm.go:45-52
        env["VLLM_ALLOW_RUNTIME_LORA_UPDATING"] = "True"
        args += ["--enable-lora"]

    container = Container(command=[], args=args, env=env)
    default_probes(container, startup_seconds=10800)
    pod = base_pod(model, cfg, container)

    # /dev/shm for torch shared memory (ref: engine_vllm.go dshm emptyDir).
    pod.spec.volumes.append(Volume(name="dshm", empty_dir=True))
    container.volume_mounts.append(VolumeMount(name="dshm", mount_path="/dev/shm"))
    return pod
