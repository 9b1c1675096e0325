"""The operator's system configuration (port of kubeai_tpu/config)."""

from kubeai_tpu_torch.config.system import System, load_system_config

__all__ = ["System", "load_system_config"]
