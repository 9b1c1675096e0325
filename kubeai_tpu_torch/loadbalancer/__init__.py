"""Endpoint groups, CHWBL prefix routing and passive health (port of kubeai_tpu/loadbalancer)."""

from kubeai_tpu_torch.loadbalancer.chwbl import HashRing, chwbl_choose, load_ok
from kubeai_tpu_torch.loadbalancer.group import (
    LEAST_LOAD,
    PREFIX_HASH,
    Endpoint,
    EndpointGroup,
)

__all__ = [
    "HashRing",
    "chwbl_choose",
    "load_ok",
    "Endpoint",
    "EndpointGroup",
    "LEAST_LOAD",
    "PREFIX_HASH",
]
