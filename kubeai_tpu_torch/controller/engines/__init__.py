"""Engine pod-spec generators (port of kubeai_tpu/controller/engines).

Each engine turns (Model, resolved config) into a Pod spec. The four
third-party generators are the JAX package's; ``TPUEngine``, the
framework's own engine, runs the port's CUDA engine (cuda.py).
"""

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.controller.engines.common import ModelPodConfig
from kubeai_tpu_torch.controller.engines.cuda import cuda_engine_pod_for_model
from kubeai_tpu_torch.controller.engines.fasterwhisper import faster_whisper_pod_for_model
from kubeai_tpu_torch.controller.engines.infinity import infinity_pod_for_model
from kubeai_tpu_torch.controller.engines.ollama import ollama_pod_for_model
from kubeai_tpu_torch.controller.engines.vllm import vllm_pod_for_model

GENERATORS = {
    mt.ENGINE_TPU: cuda_engine_pod_for_model,
    mt.ENGINE_VLLM: vllm_pod_for_model,
    mt.ENGINE_OLLAMA: ollama_pod_for_model,
    mt.ENGINE_FASTER_WHISPER: faster_whisper_pod_for_model,
    mt.ENGINE_INFINITY: infinity_pod_for_model,
}


def pod_for_model(model, cfg: ModelPodConfig):
    gen = GENERATORS.get(model.spec.engine)
    if gen is None:
        raise ValueError(f"no pod generator for engine {model.spec.engine!r}")
    return gen(model, cfg)


__all__ = ["pod_for_model", "ModelPodConfig", "GENERATORS"]
