"""Model reconciler: Model objects -> server Pods (+ the files ConfigMap)
(port of kubeai_tpu/controller/controller.py, ``ModelReconciler``).

The JAX reconciler's order and plans: files ConfigMap -> feature labels
-> replica bounds -> cache -> pod list -> status -> pod plan -> adapters.
One Model replica may expand to ``hosts_per_replica`` pods (a multi-host
gang), planned as groups. ``TPUEngine`` pods run the port's CUDA engine
(engines/cuda.py).

The cache reconciler (cache.py), the adapter reconciler (adapters.py)
and the parked pool (parked.py) are passed in by the Manager; each may be
None, and then its step is skipped.
"""

from __future__ import annotations

import logging
import threading
import uuid

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_POD, Pod, pod_is_ready
from kubeai_tpu_torch.api.model_types import Model
from kubeai_tpu_torch.config.system import System
from kubeai_tpu_torch.controller import engines
from kubeai_tpu_torch.controller.engines.common import ModelPodConfig
from kubeai_tpu_torch.controller.files import ensure_model_files_configmap, patch_file_volumes
from kubeai_tpu_torch.controller.model_source import parse_model_source
from kubeai_tpu_torch.controller.patch import apply_json_patch_to_pod
from kubeai_tpu_torch.controller.pod_plan import calculate_pod_plan, pod_spec_hash
from kubeai_tpu_torch.runtime.store import Conflict, NotFound, ObjectMeta, Store, WatchEvent

log = logging.getLogger("kubeai_tpu_torch.controller")


class ModelReconciler:
    def __init__(self, store: Store, system: System, cache_reconciler=None, adapter_reconciler=None, parked_pool=None):
        self.store = store
        self.system = system
        self.cache_reconciler = cache_reconciler
        self.adapter_reconciler = adapter_reconciler
        # Parked-replica pool (controller/parked.py): scale-ups attach
        # to a pre-warmed parked pod instead of creating one, when one
        # is available and the model is eligible.
        self.parked_pool = parked_pool
        self._running = False
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="model-reconciler", daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        q = self.store.watch()  # all kinds: Model events + owned Pod events
        while self._running:
            try:
                ev: WatchEvent = q.get(timeout=0.1)
            except Exception:
                continue
            try:
                names = self._models_for_event(ev)
                for ns, name in names:
                    self.reconcile(name, ns)
            except Exception:
                log.exception("reconcile failed for event %s %s", ev.type, ev.kind)

    def _models_for_event(self, ev: WatchEvent) -> set[tuple[str, str]]:
        if ev.kind == mt.KIND_MODEL:
            return {(ev.obj.meta.namespace, ev.obj.meta.name)}
        # Owned-object events map back to the owning model by label
        # (ref: watches on owned Pods/PVCs/Jobs, model_controller.go:200-209).
        model = getattr(ev.obj.meta, "labels", {}).get(mt.LABEL_MODEL)
        if model:
            return {(ev.obj.meta.namespace, model)}
        return set()

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, name: str, namespace: str = "default") -> None:
        try:
            model = self.store.get(mt.KIND_MODEL, name, namespace)
        except NotFound:
            return

        if model.meta.deletion_timestamp is not None:
            self._finalize(model)
            return

        ensure_model_files_configmap(self.store, model)
        if self._apply_self_labels(model):
            return  # label update re-triggers reconcile
        if self._apply_replica_bounds(model):
            return

        if self.cache_reconciler is not None and model.spec.cache_profile:
            proceed = self.cache_reconciler.reconcile(model)
            if not proceed:
                return  # cache still loading; reconcile re-triggered by Job events

        pods = self.store.list(KIND_POD, namespace, {mt.LABEL_MODEL: name})
        self._update_status(model, pods)

        cfg = self.resolve_pod_config(model)
        desired = engines.pod_for_model(model, cfg)
        if cfg.cache_mount_path:
            self._patch_cache_mount(desired, model)
        patch_file_volumes(desired, model)
        if self.adapter_reconciler is not None and model.spec.adapters:
            self.adapter_reconciler.patch_loader_sidecar(desired, model)
        desired = apply_json_patch_to_pod(self.system.model_server_pods.json_patches, desired)

        hosts = max(cfg.profile.hosts_per_replica, 1)
        from kubeai_tpu_torch.disagg import disagg_spec

        dz = disagg_spec(model)
        if hosts > 1:
            if dz is not None:
                # Multi-host gangs already dedicate whole slices per
                # replica; phase-role pools within a slice are future
                # work — serve unified rather than half-apply.
                log.warning(
                    "model %s: disaggregation is ignored on multi-host "
                    "slice gangs (hosts_per_replica=%d)",
                    model.meta.name, hosts,
                )
            self._execute_slice_plan(model, pods, desired, hosts)
        elif dz is not None:
            self._execute_disagg_plan(model, pods, desired, dz)
        else:
            plan = calculate_pod_plan(pods, model, desired, surge=self.system.model_rollouts.surge)
            if (
                plan.to_create
                and self.parked_pool is not None
                and model.spec.engine == mt.ENGINE_TPU
                # Only sources a parked pod can reach WITHOUT per-model
                # volumes: local/shared paths and self-staging hf://
                # downloads. pvc:// and cache-profile models mount
                # volumes at pod creation, which a running pod can never
                # gain — an attach would just fail and burn a parked pod.
                and cfg.source.scheme in ("file", "hf")
                and not model.spec.cache_profile
            ):
                # Scale-from-zero fast path: attach to parked pods
                # before spawning; whatever the pool can't cover is
                # created normally.
                remaining = []
                for pod in plan.to_create:
                    claimed = self.parked_pool.claim(model, pod)
                    if claimed is None:
                        remaining.append(pod)
                    else:
                        plan.details.append(
                            f"attached parked pod {claimed.meta.name}"
                        )
                plan.to_create = remaining
            self._execute_plan(model, plan)

        if self.adapter_reconciler is not None:
            self.adapter_reconciler.reconcile(model, self.store.list(KIND_POD, namespace, {mt.LABEL_MODEL: name}))

    def resolve_pod_config(self, model: Model) -> ModelPodConfig:
        """Parity: getModelConfig (ref: model_controller.go:257-319)."""
        source = parse_model_source(model.spec.url)
        profile_name, count = "cpu", 1
        if model.spec.resource_profile:
            profile_name, count_s = model.spec.resource_profile.rsplit(":", 1)
            count = int(count_s)
        profile = self.system.resource_profiles.get(profile_name)
        if profile is None:
            raise ValueError(f"unknown resource profile {profile_name!r}")
        images = self.system.engine_images.get(model.spec.engine)
        if images is None:
            raise ValueError(f"no images configured for engine {model.spec.engine}")
        image = profile.image_name or images.for_profile(profile_name)
        cache_mount = ""
        if model.spec.cache_profile and self.cache_reconciler is not None:
            cache_mount = self.cache_reconciler.model_cache_dir(model)
        return ModelPodConfig(
            source=source,
            image=image,
            profile=profile,
            profile_count=count,
            secrets=self.system.secret_names,
            cache_mount_path=cache_mount,
        )

    # -- pieces ------------------------------------------------------------

    def _apply_self_labels(self, model: Model) -> bool:
        """Feature labels on the Model itself enable label-selector lookups
        (ref: model_controller.go:374-407)."""
        want = mt.feature_labels(model)
        current = {k: v for k, v in model.meta.labels.items() if k.startswith(mt.LABEL_FEATURE_PREFIX)}
        if current == want:
            return False

        def mutate(m):
            for k in list(m.meta.labels):
                if k.startswith(mt.LABEL_FEATURE_PREFIX):
                    del m.meta.labels[k]
            m.meta.labels.update(want)

        self.store.mutate(mt.KIND_MODEL, model.meta.name, mutate, model.meta.namespace)
        return True

    def _apply_replica_bounds(self, model: Model) -> bool:
        """Clamp replicas to [min,max]; init replicas for autoscaled models
        (ref: model_controller.go:357-372)."""
        s = model.spec
        replicas = s.replicas
        if replicas is None:
            replicas = s.min_replicas
        clamped = max(replicas, s.min_replicas)
        if s.max_replicas is not None:
            clamped = min(clamped, s.max_replicas)
        if clamped == s.replicas:
            return False

        def mutate(m):
            m.spec.replicas = clamped

        self.store.mutate(mt.KIND_MODEL, model.meta.name, mutate, model.meta.namespace)
        return True

    def _update_status(self, model: Model, pods: list[Pod]) -> None:
        ready = sum(1 for p in pods if pod_is_ready(p))
        if (model.status.replicas_all, model.status.replicas_ready) == (len(pods), ready):
            return

        def mutate(m):
            m.status.replicas_all = len(pods)
            m.status.replicas_ready = ready

        try:
            self.store.mutate(mt.KIND_MODEL, model.meta.name, mutate, model.meta.namespace)
        except NotFound:
            pass

    def _execute_plan(self, model: Model, plan) -> None:
        if plan.contains_actions():
            log.info("model %s: %s", model.meta.name, "; ".join(plan.details))
        for pod in plan.to_delete:
            try:
                self.store.delete(KIND_POD, pod.meta.name, pod.meta.namespace)
            except NotFound:
                pass
        for pod in plan.to_create:
            pod.meta.name = f"model-{model.meta.name}-{pod.meta.labels[mt.LABEL_POD_HASH]}-{uuid.uuid4().hex[:6]}"
            pod.meta.owner_uids = [model.meta.uid]
            try:
                self.store.create(KIND_POD, pod)
            except Conflict:
                pass

    def _execute_disagg_plan(self, model: Model, pods: list[Pod], desired: Pod, dz) -> None:
        """Disaggregated serving: one surge-rollout plan PER PHASE-ROLE
        POOL, each with its own replica count from the disaggregation
        spec. Role pods carry the kubeai.org/role label (routing +
        observability) and role CLI flags (--role, --handoff-budget),
        which feed the spec hash — flipping the mode or resizing the
        handoff budget rolls the pods like any other spec change.
        Unlabeled pods (a model just flipped to disaggregated) fold
        into the decode pool's plan: their hash can't match a
        role-stamped pod, so the rollout machinery replaces them."""
        from kubeai_tpu_torch.disagg import (
            ROLE_DECODE,
            ROLE_PREFILL,
            pool_replicas,
            stamp_role_pod,
        )

        by_role: dict[str, list[Pod]] = {ROLE_PREFILL: [], ROLE_DECODE: []}
        for p in pods:
            role = p.meta.labels.get(mt.LABEL_ROLE)
            by_role[role if role == ROLE_PREFILL else ROLE_DECODE].append(p)
        for role in (ROLE_PREFILL, ROLE_DECODE):
            role_pod = stamp_role_pod(desired, role, dz)
            plan = calculate_pod_plan(
                by_role[role], model, role_pod,
                surge=self.system.model_rollouts.surge,
                replicas=pool_replicas(dz, role),
            )
            if plan.contains_actions():
                plan.details.insert(0, f"{role} pool")
            self._execute_plan(model, plan)

    def _execute_slice_plan(self, model: Model, pods: list[Pod], desired: Pod, hosts: int) -> None:
        """Multi-host slices: each replica is a gang of `hosts` pods with
        worker ranks; the whole gang is created/deleted together. A gang is
        identified by the slice-id label; replica count is gang count."""
        expected_hash = pod_spec_hash(desired)
        desired.meta.labels[mt.LABEL_POD_HASH] = expected_hash

        gangs: dict[str, list[Pod]] = {}
        for p in pods:
            gangs.setdefault(p.meta.labels.get("slice-id", p.meta.name), []).append(p)

        desired_replicas = model.spec.replicas or 0
        gang_items = sorted(gangs.items())

        # Delete: stale-hash gangs, incomplete gangs, then excess gangs.
        def gang_stale(gang: list[Pod]) -> bool:
            return any(p.meta.labels.get(mt.LABEL_POD_HASH) != expected_hash for p in gang) or len(gang) != hosts

        from kubeai_tpu_torch.api.core_types import KIND_SECRET, Secret

        def delete_gang(sid: str, gang: list[Pod]) -> None:
            for p in gang:
                try:
                    self.store.delete(KIND_POD, p.meta.name, p.meta.namespace)
                except NotFound:
                    pass
            try:  # the gang's dispatch-stream secret dies with it
                self.store.delete(
                    KIND_SECRET,
                    f"model-{model.meta.name}-gang-{sid}",
                    model.meta.namespace,
                )
            except NotFound:
                pass

        keep: list[str] = []
        for sid, gang in gang_items:
            if gang_stale(gang):
                delete_gang(sid, gang)
            else:
                keep.append(sid)
        for sid in keep[desired_replicas:]:
            delete_gang(sid, gangs[sid])
        missing = desired_replicas - min(len(keep), desired_replicas)
        for _ in range(missing):
            sid = uuid.uuid4().hex[:8]
            # Per-gang shared secret for the rank-0 dispatch stream
            # (engine/gang.py handshake): provisioned as a real Secret
            # referenced via envFrom, NOT a plaintext pod-spec env value
            # — pod read access must not yield the token that joins (or
            # impersonates) the gang publisher.
            secret_name = f"model-{model.meta.name}-gang-{sid}"
            gang_secret = Secret(
                meta=ObjectMeta(
                    name=secret_name,
                    namespace=model.meta.namespace,
                    labels={mt.LABEL_MODEL: model.meta.name, "slice-id": sid},
                    owner_uids=[model.meta.uid],
                ),
                data={"KUBEAI_GANG_SECRET": uuid.uuid4().hex + uuid.uuid4().hex},
            )
            try:
                self.store.create(KIND_SECRET, gang_secret)
            except Conflict:
                pass
            hostnames = [
                f"model-{model.meta.name}-{sid}-{rank}.{desired.spec.subdomain}"
                for rank in range(hosts)
            ]
            for rank in range(hosts):
                import copy

                pod = copy.deepcopy(desired)
                pod.meta.name = f"model-{model.meta.name}-{sid}-{rank}"
                pod.meta.labels["slice-id"] = sid
                pod.meta.labels["slice-rank"] = str(rank)
                pod.meta.owner_uids = [model.meta.uid]
                pod.spec.hostname = f"model-{model.meta.name}-{sid}-{rank}"
                server = pod.spec.containers[0]
                server.env["TPU_WORKER_ID"] = str(rank)
                server.env["TPU_WORKER_HOSTNAMES"] = ",".join(hostnames)
                server.env[f"__envFromSecret_{secret_name}"] = secret_name
                try:
                    self.store.create(KIND_POD, pod)
                except Conflict:
                    pass

    def _patch_cache_mount(self, pod, model: Model) -> None:
        """Server pods mount the shared cache PVC read-only at the model's
        cache dir (ref: cache.go:436-458)."""
        from kubeai_tpu_torch.api.core_types import Volume, VolumeMount
        from kubeai_tpu_torch.controller.cache import pvc_name

        pod.spec.volumes.append(
            Volume(name="model-cache", pvc_name=pvc_name(model.spec.cache_profile))
        )
        pod.spec.containers[0].volume_mounts.append(
            VolumeMount(
                name="model-cache",
                mount_path=self.cache_reconciler.model_cache_dir(model),
                sub_path=f"{model.meta.name}-{model.meta.uid}",
                read_only=True,
            )
        )

    def _finalize(self, model: Model) -> None:
        """Deletion: drop server pods, run cache finalizer
        (ref: model_controller.go:112-133)."""
        from kubeai_tpu_torch.controller.cache import CACHE_FINALIZER

        self.store.delete_all_of(KIND_POD, model.meta.namespace, {mt.LABEL_MODEL: model.meta.name})
        from kubeai_tpu_torch.api.core_types import KIND_SECRET

        self.store.delete_all_of(
            KIND_SECRET, model.meta.namespace, {mt.LABEL_MODEL: model.meta.name}
        )
        if self.cache_reconciler is not None and model.spec.cache_profile:
            if not self.cache_reconciler.finalize(model):
                return  # eviction job still running

        def mutate(m):
            m.meta.finalizers = [f for f in m.meta.finalizers if f != CACHE_FINALIZER]

        try:
            self.store.mutate(mt.KIND_MODEL, model.meta.name, mutate, model.meta.namespace)
        except NotFound:
            pass
