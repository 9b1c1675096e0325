"""Desired-state pod planning with surge rollout.

Port of kubeai_tpu/controller/pod_plan.py: the JAX package's code,
its imports in this package.

Behavioral parity with the reference planner
(ref: internal/modelcontroller/pod_plan.go:28-156):
- desired pods carry a spec-hash label; a hash change is a rollout
- rollouts add `surge` extra replicas while any out-of-date pod exists
- out-of-date pods that are NOT ready are recreated immediately; ready
  out-of-date pods are recreated one-per-reconcile only when all pods are
  ready (so capacity never dips)
- deletion order: not-ready first, then unscheduled, then old-hash, then
  youngest (ref: pod_plan.go:215-243)
- delete before create (avoid node scale-up waste)
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from kubeai_tpu_torch.api.core_types import Pod, pod_is_ready
from kubeai_tpu_torch.api.model_types import LABEL_POD_HASH, Model
from kubeai_tpu_torch.utils.xxh import xxh64


def pod_spec_hash(pod: Pod) -> str:
    """Stable short hash over the pod spec (the reference uses FNV-32a over
    a spec dump, ref: internal/k8sutils/pods.go:27-41; xxhash here)."""
    dump = json.dumps(asdict(pod.spec), sort_keys=True)
    return f"{xxh64(dump) & 0xFFFFFFFF:08x}"


@dataclass
class PodPlan:
    to_create: list[Pod] = field(default_factory=list)
    to_delete: list[Pod] = field(default_factory=list)
    to_remain: list[Pod] = field(default_factory=list)
    details: list[str] = field(default_factory=list)

    def contains_actions(self) -> bool:
        return bool(self.to_create or self.to_delete)


def _deletion_sort_key(pod: Pod, expected_hash: str):
    return (
        pod_is_ready(pod),  # not-ready first
        pod.status.scheduled,  # unscheduled first
        pod.meta.labels.get(LABEL_POD_HASH) == expected_hash,  # old-hash first
        -pod.meta.creation_time,  # youngest first
    )


def calculate_pod_plan(
    all_pods: list[Pod],
    model: Model,
    desired_pod: Pod,
    surge: int = 1,
    replicas: int | None = None,
) -> PodPlan:
    """Compute creations/deletions to converge *all_pods* to the model's
    replica count with a hash-labelled surge rollout. *replicas*
    overrides ``model.spec.replicas`` — disaggregated models plan each
    phase-role pool separately with its own pool size."""
    expected_hash = pod_spec_hash(desired_pod)
    desired_pod.meta.labels[LABEL_POD_HASH] = expected_hash
    desired_pod.meta.name = ""  # name assigned per-create

    pods = sorted(all_pods, key=lambda p: _deletion_sort_key(p, expected_hash))

    ready_all = sum(1 for p in pods if pod_is_ready(p))
    out_of_date = [p for p in pods if p.meta.labels.get(LABEL_POD_HASH) != expected_hash]

    plan = PodPlan()
    remainder = {p.meta.name: p for p in pods}

    def mark_delete(p: Pod):
        remainder.pop(p.meta.name, None)
        plan.to_delete.append(p)

    desired = (model.spec.replicas or 0) if replicas is None else replicas
    if out_of_date:
        desired += surge
    diff = len(pods) - desired

    if diff < 0:
        plan.details.append(f"creating {-diff} pods")
        for _ in range(-diff):
            plan.to_create.append(_clone(desired_pod))
    elif diff > 0:
        plan.details.append(f"deleting {diff} pods")
        for p in pods[:diff]:
            mark_delete(p)

    recreated = 0

    def may_recreate() -> bool:
        # Don't recreate the surge pod once the rollout completes
        # (ref: pod_plan.go:128-131).
        return recreated < len(out_of_date) - surge

    for p in out_of_date:
        if not pod_is_ready(p):
            plan.details.append(f"out-of-date pod {p.meta.name} not ready; recreating now")
            mark_delete(p)
            if may_recreate():
                plan.to_create.append(_clone(desired_pod))
                recreated += 1
            continue
        if ready_all == desired:
            plan.details.append(f"all ready; recreating out-of-date pod {p.meta.name}")
            mark_delete(p)
            if may_recreate():
                plan.to_create.append(_clone(desired_pod))
                recreated += 1
            break  # one ready pod per reconcile

    plan.to_remain = list(remainder.values())
    return plan


def _clone(pod: Pod) -> Pod:
    import copy

    return copy.deepcopy(pod)
