"""Training on one card: LoRA fine-tuning (``finetune``) and the
full-parameter step (``trainer``), ports of kubeai_tpu/train/."""
