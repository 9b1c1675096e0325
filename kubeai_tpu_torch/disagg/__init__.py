"""Disaggregated prefill/decode serving (docs/disaggregation.md).

Port of kubeai_tpu/disagg/__init__.py: the JAX package's code,
its imports in this package.

The subsystem that splits a model's fleet into phase-role pools:

- ``roles`` — the role vocabulary (pod label, engine ``--role`` flag),
  pod stamping for the controller, and spec helpers.
- ``handoff`` — the proxy-side replay-based handoff: detection of the
  prefill engine's budget-cap finish, decode-upstream acquisition, and
  the handoff metrics.
- ``signals`` — per-pool autoscaling signal derivation from the fleet
  collector's role-dimensioned scrape (prefill: queue-wait pressure;
  decode: slot/KV-page occupancy).
"""

from kubeai_tpu_torch.disagg.roles import (  # noqa: F401
    ROLE_DECODE,
    ROLE_PREFILL,
    ROLES,
    disagg_spec,
    pool_max_replicas,
    pool_replicas,
    stamp_role_pod,
)
