"""Small helpers of the port with no torch in them (port of kubeai_tpu/utils)."""
