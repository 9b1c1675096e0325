from kubeai_tpu_torch.autoscaler.movingaverage import SimpleMovingAverage

__all__ = ["SimpleMovingAverage"]
