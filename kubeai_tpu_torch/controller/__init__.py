"""The part of the operator's controller that the engine needs: the model
source URL (port of kubeai_tpu/controller)."""
