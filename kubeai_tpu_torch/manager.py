"""Process manager: builds and wires the operator's request path (port of
kubeai_tpu/manager.py, ``Manager``).

The store, the model client, the load balancer, the model reconciler, the
proxy and its OpenAI server, and (``local_runtime=True``) the
LocalRuntime pod executor; each runs on daemon threads and stops in
reverse order. The JAX manager's other components are not ported yet and
are left out, not stubbed: the autoscaler and fleet collector, leader
election, the SLO monitor, canary, history, forecaster and incident
recorder, the messengers, the cache and adapter reconcilers and the
parked pool (ROADMAP queue 1). What would need one is refused: a System
with ``parked_replicas`` or ``streams`` at construction, and a Model with
a ``cacheProfile`` or ``adapters`` at the store's admission.

CLI:
    python -m kubeai_tpu_torch.manager --local [--port 8000]
        [--config sys.yaml] [--models file.yaml] [--catalog names]

``--config`` and ``--models`` read YAML (PyYAML, imported only then); a
Model can also be built in Python (``api.model_types.Model``) and created
in ``Manager.store``.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.config.system import System, load_system_config
from kubeai_tpu_torch.controller.controller import ModelReconciler, refuse_unported
from kubeai_tpu_torch.loadbalancer.balancer import LoadBalancer
from kubeai_tpu_torch.obs.logs import get_logger, setup_logging
from kubeai_tpu_torch.obs.otel import maybe_start_exporter, uninstall_exporter
from kubeai_tpu_torch.proxy.handler import ModelProxy
from kubeai_tpu_torch.proxy.modelclient import ModelClient
from kubeai_tpu_torch.proxy.server import OpenAIServer
from kubeai_tpu_torch.runtime.local import LocalRuntime
from kubeai_tpu_torch.runtime.store import Store

log = get_logger("kubeai_tpu_torch.manager")


def refuse_unported_system(system: System) -> None:
    """Raise ValueError for System settings whose component is not ported
    yet, naming its ROADMAP item."""
    if system.parked_replicas > 0:
        raise ValueError(
            "parkedReplicas > 0 needs the parked pool, which is not ported yet "
            "(ROADMAP queue 1, item 4: controller/parked)")
    if system.streams:
        raise ValueError(
            "streams need the messenger, which is not ported yet "
            "(ROADMAP queue 1, item 5: messenger/)")


class Manager:
    def __init__(
        self,
        system: System | None = None,
        store: Store | None = None,
        local_runtime: bool = False,
        host: str = "0.0.0.0",
        port: int = 8000,
        namespace: str = "default",
    ):
        self.system = (system or System()).default_and_validate()
        refuse_unported_system(self.system)
        self.store = store or Store()
        self.store.add_admission(mt.KIND_MODEL, refuse_unported)
        self.namespace = namespace
        self.model_client = ModelClient(
            self.store,
            namespace,
            required_consecutive_scale_downs=lambda m: self.system.autoscaling.consecutive_scale_downs_for(
                m.spec.scale_down_delay_seconds
            ),
        )
        self.lb = LoadBalancer(self.store, self.system.allow_pod_address_override)
        self.reconciler = ModelReconciler(self.store, self.system)
        self.proxy = ModelProxy(self.model_client, self.lb)
        self.api = OpenAIServer(self.proxy, self.model_client, host=host, port=port)
        self.local_runtime = LocalRuntime(self.store, namespace) if local_runtime else None
        self._otel = None

    def start(self):
        # The OTLP exporter (nothing unless KUBEAI_OTLP_ENDPOINT is set).
        self._otel = maybe_start_exporter("kubeai-operator")
        self.lb.start()
        self.reconciler.start()
        if self.local_runtime:
            self.local_runtime.start()
        self.api.start()
        log.info("manager up: api :%d", self.api.port)

    def drain(self, grace: float = 30.0):
        """Graceful termination (the SIGTERM path): stop admitting
        requests, let in-flight proxied work finish for up to *grace*
        seconds, then stop the rest."""
        self.api.drain(grace)
        self.stop()

    def stop(self):
        self.api.stop()
        if self.local_runtime:
            self.local_runtime.stop()
        self.reconciler.stop()
        self.lb.stop()
        if self._otel is not None:
            self._otel.stop()
            uninstall_exporter(self._otel)
            self._otel = None


def main(argv=None):
    parser = argparse.ArgumentParser("kubeai-tpu-torch-manager")
    parser.add_argument("--config", default=os.environ.get("CONFIG_PATH"))
    parser.add_argument("--local", action="store_true", help="run pods as local processes")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--drain-grace", type=float,
        default=float(os.environ.get("KUBEAI_DRAIN_GRACE", "30")),
        help="seconds SIGTERM lets in-flight requests finish before exit "
             "(keep below the pod's terminationGracePeriodSeconds)",
    )
    parser.add_argument("--models", default=None, help="YAML file of Model manifests to apply at boot")
    parser.add_argument(
        "--catalog", default=None,
        help="comma-separated curated catalog entries to apply at boot (see kubeai_tpu_torch.catalog)",
    )
    args = parser.parse_args(argv)
    if not args.local:
        # The Kubernetes store is not ported yet: only LocalRuntime runs pods.
        parser.error("only --local is supported (ROADMAP queue 1, item 6: runtime/k8s and KubeStore)")
    setup_logging("operator")

    system = load_system_config(args.config) if args.config else System().default_and_validate()
    if args.catalog:
        from kubeai_tpu_torch.catalog import CATALOG

        names = [n.strip() for n in args.catalog.split(",") if n.strip()]
        unknown = [n for n in names if n not in CATALOG]
        if unknown:
            parser.error(f"unknown catalog entries {unknown}; available: {sorted(CATALOG)}")
    mgr = Manager(system, local_runtime=True, host=args.host, port=args.port)
    mgr.start()

    if args.models:
        from kubeai_tpu_torch.catalog import apply_manifest_file

        apply_manifest_file(mgr.store, args.models)
    if args.catalog:
        from kubeai_tpu_torch.catalog import apply_catalog

        apply_catalog(mgr.store, names)

    # SIGTERM (the kubelet's shutdown signal) drains: readiness flips to
    # 503 first, then in-flight requests get the grace budget.
    done = threading.Event()

    def _on_term(signum, frame):
        # A handler must return at once; the drain runs on a thread.
        threading.Thread(
            target=lambda: (mgr.drain(args.drain_grace), done.set()),
            daemon=True,
        ).start()

    signal.signal(signal.SIGTERM, _on_term)

    try:
        while not done.is_set():
            done.wait(3600)
    except KeyboardInterrupt:
        mgr.stop()


if __name__ == "__main__":
    main()
