"""The object store and the local pod runtime (port of kubeai_tpu/runtime)."""

from kubeai_tpu_torch.runtime.store import ObjectMeta, Store, WatchEvent

__all__ = ["Store", "ObjectMeta", "WatchEvent"]
