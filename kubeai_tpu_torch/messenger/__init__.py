"""Pub/sub request transport (port of kubeai_tpu/messenger): the
Messenger consumer and its bus drivers."""

from kubeai_tpu_torch.messenger.messenger import Messenger
from kubeai_tpu_torch.messenger.drivers import open_subscription, open_topic

__all__ = ["Messenger", "open_topic", "open_subscription"]
