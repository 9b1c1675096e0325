"""The operator's controller: model sources, pod plans, engine pod
generators and the Model reconciler (port of kubeai_tpu/controller)."""
