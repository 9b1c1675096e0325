"""The operator's API types: Models, workload objects, OpenAI bodies (port of kubeai_tpu/api)."""
