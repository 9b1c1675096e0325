"""The OpenAI proxy with scale-from-zero and its recovery (port of kubeai_tpu/proxy)."""
