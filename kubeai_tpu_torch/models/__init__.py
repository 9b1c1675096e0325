from kubeai_tpu_torch.models.base import ModelConfig, RopeScaling, llama_3_1_8b

__all__ = ["ModelConfig", "RopeScaling", "llama_3_1_8b"]
