"""Shared-filesystem weight cache (port of kubeai_tpu/controller/cache.py).

- one PVC per cache profile;
- a loader Job (``python -m kubeai_tpu_torch.loader``) stages the weights
  into /models/<name>-<uid> on it; with ``cacheWarmCompile`` and the
  native engine it also builds the kernel libraries into the compile
  cache (``--warm-compile-cache``);
- completion is recorded as a PVC annotation keyed by the Model's uid, so
  it survives an operator restart, and a Model re-created under the same
  name (a new uid) loads again;
- ``status.cache_loaded`` mirrors the annotation, and the reconciler
  creates no pod before it is set;
- deleting the Model runs an eviction Job under a finalizer before the
  Model is released.
"""

from __future__ import annotations

import logging

from kubeai_tpu_torch.api.core_types import (
    KIND_JOB,
    KIND_PVC,
    PVC,
    Container,
    Job,
    PodSpec,
    PVCSpec,
    job_is_completed,
)
from kubeai_tpu_torch.api.model_types import ENGINE_TPU, Model
from kubeai_tpu_torch.config.system import System
from kubeai_tpu_torch.runtime.store import AlreadyExists, NotFound, ObjectMeta, Store

log = logging.getLogger("kubeai_tpu_torch.cache")

CACHE_FINALIZER = "kubeai.org/cache-eviction"
LOADED_ANNOTATION_PREFIX = "cache-loaded.kubeai.org/"


def pvc_name(profile: str) -> str:
    return f"model-cache-{profile}"


def loader_job_name(model: Model) -> str:
    return f"load-cache-{model.meta.name}"


def evict_job_name(model: Model) -> str:
    return f"evict-cache-{model.meta.name}"


class CacheReconciler:
    def __init__(self, store: Store, system: System, namespace: str = "default"):
        self.store = store
        self.system = system
        self.namespace = namespace

    def model_cache_dir(self, model: Model) -> str:
        """ref: modelCacheDir (cache.go:424-426) — uid-scoped so a
        same-name re-create can't serve stale weights."""
        return f"/models/{model.meta.name}-{model.meta.uid}"

    # -- load path ---------------------------------------------------------

    def reconcile(self, model: Model) -> bool:
        """Returns True when the cache is loaded and pod creation may
        proceed (ref: errReturnEarly gating, cache.go:30-134). All objects
        live in the model's own namespace."""
        profile = self.system.cache_profiles.get(model.spec.cache_profile)
        if profile is None:
            raise ValueError(f"unknown cache profile {model.spec.cache_profile!r}")

        self._ensure_finalizer(model)
        pvc = self._ensure_pvc(model, profile)

        ann_key = LOADED_ANNOTATION_PREFIX + model.meta.uid
        if pvc.meta.annotations.get(ann_key):
            self._delete_job(loader_job_name(model), model.meta.namespace)
            if not model.status.cache_loaded:
                self._set_cache_loaded(model, True)
            return True

        job = self._ensure_loader_job(model)
        if job_is_completed(job):
            def mutate(p):
                p.meta.annotations[ann_key] = "true"

            self.store.mutate(KIND_PVC, pvc.meta.name, mutate, model.meta.namespace)
            self._delete_job(loader_job_name(model), model.meta.namespace)
            self._set_cache_loaded(model, True)
            return True
        return False

    # -- eviction path -----------------------------------------------------

    def finalize(self, model: Model) -> bool:
        """Drive the eviction Job; True when eviction is complete and the
        finalizer may be removed (ref: finalizeCache, cache.go:136-217)."""
        try:
            pvc = self.store.get(KIND_PVC, pvc_name(model.spec.cache_profile), model.meta.namespace)
        except NotFound:
            return True
        ann_key = LOADED_ANNOTATION_PREFIX + model.meta.uid
        if ann_key not in pvc.meta.annotations:
            self._delete_job(evict_job_name(model), model.meta.namespace)
            return True
        job = self._ensure_evict_job(model)
        if not job_is_completed(job):
            return False

        def mutate(p):
            p.meta.annotations.pop(ann_key, None)

        self.store.mutate(KIND_PVC, pvc.meta.name, mutate, model.meta.namespace)
        self._delete_job(evict_job_name(model), model.meta.namespace)
        return True

    # -- helpers -----------------------------------------------------------

    def _ensure_finalizer(self, model: Model):
        if CACHE_FINALIZER in model.meta.finalizers:
            return

        def mutate(m):
            if CACHE_FINALIZER not in m.meta.finalizers:
                m.meta.finalizers.append(CACHE_FINALIZER)

        from kubeai_tpu_torch.api.model_types import KIND_MODEL

        self.store.mutate(KIND_MODEL, model.meta.name, mutate, model.meta.namespace)
        model.meta.finalizers.append(CACHE_FINALIZER)

    def _ensure_pvc(self, model: Model, profile) -> PVC:
        name = pvc_name(model.spec.cache_profile)
        ns = model.meta.namespace
        try:
            return self.store.get(KIND_PVC, name, ns)
        except NotFound:
            pvc = PVC(
                meta=ObjectMeta(name=name, namespace=ns),
                spec=PVCSpec(
                    storage_class_name=profile.shared_filesystem_storage_class,
                    storage=profile.shared_filesystem_storage,
                ),
            )
            try:
                return self.store.create(KIND_PVC, pvc)
            except AlreadyExists:
                return self.store.get(KIND_PVC, name, ns)

    def _loader_pod_spec(self, model: Model, command: list[str]) -> PodSpec:
        from kubeai_tpu_torch.api.core_types import Volume, VolumeMount

        container = Container(
            name="loader",
            image=self.system.model_loader_image,
            command=command,
            volume_mounts=[VolumeMount(name="cache", mount_path="/models")],
        )
        return PodSpec(
            containers=[container],
            volumes=[Volume(name="cache", pvc_name=pvc_name(model.spec.cache_profile))],
            restart_policy="OnFailure",
        )

    def _ensure_loader_job(self, model: Model) -> Job:
        name = loader_job_name(model)
        ns = model.meta.namespace
        try:
            return self.store.get(KIND_JOB, name, ns)
        except NotFound:
            # Opt-in loader warm: the staging Job also AOT-compiles the
            # engine step functions for this checkpoint into the shared
            # KUBEAI_COMPILE_CACHE, keyed to the Model's own engine args
            # — hot before the first replica starts. One decision for
            # both the flag and the trailing args (they are useless
            # apart).
            warm = self.system.cache_warm_compile and model.spec.engine == ENGINE_TPU
            command = ["python", "-m", "kubeai_tpu_torch.loader"]
            if warm:
                command += ["--warm-compile-cache"]
            command += [model.spec.url, self.model_cache_dir(model)]
            if warm:
                command += [str(a) for a in model.spec.args]
            job = Job(
                meta=ObjectMeta(
                    name=name,
                    namespace=ns,
                    labels={"model": model.meta.name},
                    owner_uids=[model.meta.uid],
                ),
                spec=self._loader_pod_spec(model, command),
            )
            try:
                return self.store.create(KIND_JOB, job)
            except AlreadyExists:
                return self.store.get(KIND_JOB, name, ns)

    def _ensure_evict_job(self, model: Model) -> Job:
        name = evict_job_name(model)
        ns = model.meta.namespace
        try:
            return self.store.get(KIND_JOB, name, ns)
        except NotFound:
            job = Job(
                meta=ObjectMeta(name=name, namespace=ns, labels={"model": model.meta.name}),
                spec=self._loader_pod_spec(
                    model,
                    ["python", "-m", "kubeai_tpu_torch.loader", "--evict", self.model_cache_dir(model)],
                ),
            )
            try:
                return self.store.create(KIND_JOB, job)
            except AlreadyExists:
                return self.store.get(KIND_JOB, name, ns)

    def _delete_job(self, name: str, namespace: str = "default"):
        try:
            self.store.delete(KIND_JOB, name, namespace)
        except NotFound:
            pass

    def _set_cache_loaded(self, model: Model, loaded: bool):
        from kubeai_tpu_torch.api.model_types import KIND_MODEL

        def mutate(m):
            m.status.cache_loaded = loaded

        try:
            self.store.mutate(KIND_MODEL, model.meta.name, mutate, model.meta.namespace)
        except NotFound:
            pass
        model.status.cache_loaded = loaded
