"""Phase-role vocabulary + pod stamping for disaggregated serving.

Port of kubeai_tpu/disagg/roles.py: the JAX package's code,
its imports in this package.

A disaggregated model runs two pod pools distinguished by the
``kubeai.org/role`` label (api.model_types.LABEL_ROLE). The label is the
single source the whole stack reads: the load balancer copies it onto
endpoints, the proxy routes by it, the fleet collector dimensions
/debug/fleet by it, and the autoscaler scales each pool on its own
signal. Engine replicas learn their role from the ``--role`` CLI flag
the controller stamps alongside the label (with ``--handoff-budget`` on
the prefill pool).
"""

from __future__ import annotations

import copy

from kubeai_tpu_torch.api import model_types as mt

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_PREFILL, ROLE_DECODE)


def disagg_spec(model) -> mt.Disaggregation | None:
    """The model's Disaggregation block when the mode is enabled, else
    None. Tolerates anything model-shaped (tests stub Model objects)."""
    spec = getattr(model, "spec", None)
    dz = getattr(spec, "disaggregation", None)
    if dz is not None and getattr(dz, "enabled", False):
        return dz
    return None


def pool_replicas(dz: mt.Disaggregation, role: str) -> int:
    return dz.prefill_replicas if role == ROLE_PREFILL else dz.decode_replicas


def pool_max_replicas(dz: mt.Disaggregation, role: str) -> int | None:
    return (
        dz.max_prefill_replicas if role == ROLE_PREFILL else dz.max_decode_replicas
    )


def stamp_role_pod(desired, role: str, dz: mt.Disaggregation):
    """Clone the engine generator's desired pod into *role*'s variant:
    the role label (routing + observability) and the engine CLI flags
    (behavior). Returns a fresh Pod — the caller plans each pool
    independently, so the unified desired pod must stay pristine.

    The flags feed pod_spec_hash, so flipping a model between unified
    and disaggregated (or resizing the handoff budget) rolls the pods
    — exactly the semantics a topology change needs."""
    pod = copy.deepcopy(desired)
    pod.meta.labels[mt.LABEL_ROLE] = role
    server = pod.spec.containers[0]
    server.args = list(server.args) + ["--role", role]
    if role == ROLE_PREFILL:
        server.args += ["--handoff-budget", str(dz.handoff_tokens)]
    return pod
