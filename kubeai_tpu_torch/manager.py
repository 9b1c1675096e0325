"""Process manager: builds and wires the operator (port of
kubeai_tpu/manager.py, ``Manager``).

The store, leader election, the model client, the load balancer, the
cache and adapter reconcilers, the parked pool (``parkedReplicas`` > 0),
the model reconciler, the fleet collector and the autoscaler, the proxy
and its OpenAI server, one messenger per ``streams`` entry (pub/sub
requests into the same balancer and model client as the proxy), and
(``local_runtime=True``) the LocalRuntime pod executor; each runs on
daemon threads, started and stopped in the JAX manager's order. The SLO
monitor (over the fleet's scrapes, ``/debug/slo``) and the canary prober
(deterministic probes through the proxy, ``/debug/canary``) run beside
the autoscaler. The operator's history store (under
``<KUBEAI_HISTORY_DIR>/operator``) takes the registry's samples and every
fleet collect; the forecaster reads it and gives the autoscaler a
forecast one cold-start lead ahead (``/debug/forecast``); the incident
recorder captures every debug surface when a trigger fires
(``/debug/incidents``, a disk ring under ``KUBEAI_INCIDENT_DIR``). Only
the lease holder's autoscaler, SLO monitor, canary, history sampler,
forecaster and recorder tick.

CLI:
    python -m kubeai_tpu_torch.manager [--local | --kube]
        [--kube-api-server URL] [--port 8000] [--config sys.yaml]
        [--models file.yaml] [--catalog names]

``--kube`` (the default inside a cluster, where KUBERNETES_SERVICE_HOST
is set) or ``--kube-api-server`` backs the store with the kube-apiserver
(``runtime/k8s.py``: the kubelet runs the pods); ``--local`` keeps the
in-memory store and runs each pod as a local process, and overrides
``--kube``. Without either the store is in memory and nothing runs the
pods. ``--config`` and ``--models`` read YAML (PyYAML, imported only
then); a Model can also be built in Python (``api.model_types.Model``)
and created in ``Manager.store``.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
import uuid

from kubeai_tpu_torch.autoscaler.autoscaler import Autoscaler
from kubeai_tpu_torch.autoscaler.fleet import FleetCollector
from kubeai_tpu_torch.autoscaler.leader import Election
from kubeai_tpu_torch.config.system import System, load_system_config
from kubeai_tpu_torch.controller.adapters import AdapterReconciler
from kubeai_tpu_torch.controller.cache import CacheReconciler
from kubeai_tpu_torch.controller.controller import ModelReconciler
from kubeai_tpu_torch.loadbalancer.balancer import LoadBalancer
from kubeai_tpu_torch.messenger.messenger import Messenger
from kubeai_tpu_torch.obs.canary import CanaryProber, install_canary, uninstall_canary
from kubeai_tpu_torch.obs.forecast import Forecaster, install_forecaster, uninstall_forecaster
from kubeai_tpu_torch.obs.history import (
    HistoryStore,
    RegistrySampler,
    history_dir_default,
    install_history,
    uninstall_history,
)
from kubeai_tpu_torch.obs.incidents import (
    IncidentRecorder,
    install_recorder,
    standard_sources,
    uninstall_recorder,
)
from kubeai_tpu_torch.obs.logs import get_logger, setup_logging
from kubeai_tpu_torch.obs.otel import maybe_start_exporter, uninstall_exporter
from kubeai_tpu_torch.obs.slo import SLOMonitor
from kubeai_tpu_torch.proxy.handler import ModelProxy
from kubeai_tpu_torch.proxy.modelclient import ModelClient
from kubeai_tpu_torch.proxy.server import OpenAIServer
from kubeai_tpu_torch.runtime.local import LocalRuntime
from kubeai_tpu_torch.runtime.store import Store

log = get_logger("kubeai_tpu_torch.manager")


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
        self.store = store or Store()
        self.namespace = namespace

        identity = f"kubeai-{uuid.uuid4().hex[:8]}"
        self.election = Election(
            self.store, identity, duration=self.system.leader_election_lease_seconds,
            namespace=namespace,
        )
        self.model_client = ModelClient(
            self.store,
            namespace,
            required_consecutive_scale_downs=lambda m: self.system.autoscaling.consecutive_scale_downs_for(
                m.spec.scale_down_delay_seconds
            ),
        )
        self.lb = LoadBalancer(self.store, self.system.allow_pod_address_override)
        self.cache_reconciler = CacheReconciler(self.store, self.system, namespace)
        self.adapter_reconciler = AdapterReconciler(
            self.store, allow_override=self.system.allow_pod_address_override or local_runtime
        )
        # The parked pool: a scale-up attaches the Model to a parked pod
        # instead of spawning one; each attach is recorded in the
        # autoscaler's decision log (wired below).
        self.parked_pool = None
        if self.system.parked_replicas > 0:
            from kubeai_tpu_torch.controller.parked import ParkedPool

            self.parked_pool = ParkedPool(self.store, self.system, namespace)
        self.reconciler = ModelReconciler(
            self.store,
            self.system,
            cache_reconciler=self.cache_reconciler,
            adapter_reconciler=self.adapter_reconciler,
            parked_pool=self.parked_pool,
        )
        # One scrape per engine endpoint per autoscaler tick, shared by
        # the scaling signal and /debug/fleet; the debug view reuses it
        # for 1.5 ticks.
        self.fleet = FleetCollector(
            self.lb,
            default_max_age=1.5 * self.system.autoscaling.interval_seconds,
        )
        self.autoscaler = Autoscaler(
            self.store,
            self.model_client,
            self.lb,
            self.election,
            interval_seconds=self.system.autoscaling.interval_seconds,
            average_window_count=self.system.autoscaling.average_window_count,
            fixed_self_metric_addrs=self.system.fixed_self_metric_addrs,
            state_name=self.system.autoscaling.state_config_map_name,
            namespace=namespace,
            fleet=self.fleet,
            parked_pool=self.parked_pool,
        )
        # The engines' histograms live in the pods: the fleet's scrapes
        # are how this monitor sees them. Only the lease holder's
        # autoscaler keeps those scrapes fresh, so only it reports.
        self.slo = SLOMonitor(
            interval_seconds=self.system.autoscaling.interval_seconds,
            remote_pages=self.fleet.parsed_pages,
            election=self.election,
        )
        if self.parked_pool is not None:
            self.parked_pool.decision_log = self.autoscaler.decisions
        self.proxy = ModelProxy(self.model_client, self.lb)
        self.api = OpenAIServer(self.proxy, self.model_client, host=host, port=port)
        self.api.decision_log = self.autoscaler.decisions
        self.api.fleet = self.fleet
        self.api.slo = self.slo
        self.api.election = self.election
        # Deterministic probes through the proxy (KUBEAI_CANARY=0 turns
        # them off); leader-gated like the SLO monitor.
        self.canary = CanaryProber(
            self.proxy, self.model_client, self.lb, election=self.election
        )
        # The operator's history: the registry's samples and each fleet
        # collect ("operator" keeps it apart from an engine's store in the
        # same directory).
        self.history = HistoryStore(
            history_dir=os.path.join(history_dir_default(), "operator"),
        )
        self.history_sampler = RegistrySampler(self.history, election=self.election)
        self.fleet.history = self.history
        # Forecasts over that history: the autoscaler's raise-only floor,
        # the parked pool's pre-warm, and traffic_anomaly triggers.
        self.forecaster = Forecaster(
            self.history, election=self.election, decision_log=self.autoscaler.decisions,
        )
        self.autoscaler.forecaster = self.forecaster
        self.autoscaler.parked_pool = self.parked_pool
        self.incidents = IncidentRecorder(
            sources=standard_sources(
                self.lb,
                self.model_client,
                fleet=self.fleet,
                decision_log=self.autoscaler.decisions,
                slo=self.slo,
                canary=self.canary,
                history=self.history,
                forecaster=self.forecaster,
            ),
            election=self.election,
            # Pages by address: the counter watch differences each
            # endpoint against its own baseline.
            remote_pages=self.fleet.parsed_pages_by_addr,
            watch_interval=self.system.autoscaling.interval_seconds,
        )
        install_recorder(self.incidents)
        install_canary(self.canary)
        install_history(self.history)
        install_forecaster(self.forecaster)
        self.messengers = [
            Messenger(
                stream.requests_url,
                stream.responses_url,
                max_handlers=stream.max_handlers,
                model_client=self.model_client,
                lb=self.lb,
                error_max_backoff=self.system.messaging_error_max_backoff_seconds,
            )
            for stream in self.system.streams
        ]
        self.local_runtime = LocalRuntime(self.store, namespace) if local_runtime else None
        self._otel = None

    def start(self):
        # The OTLP exporter (nothing unless KUBEAI_OTLP_ENDPOINT is set).
        self._otel = maybe_start_exporter("kubeai-operator")
        self.lb.start()
        if self.parked_pool is not None:
            self.parked_pool.start()
        self.reconciler.start()
        self.election.start()
        self.autoscaler.start()
        self.slo.start()
        self.history_sampler.start()
        self.forecaster.start()
        self.incidents.start()
        self.canary.start()
        if self.local_runtime:
            self.local_runtime.start()
        for m in self.messengers:
            m.start()
        self.api.start()
        log.info("manager up: api :%d", self.api.port)

    def drain(self, grace: float = 30.0):
        """Graceful termination (the SIGTERM path): stop admitting
        requests, let in-flight proxied work finish for up to *grace*
        seconds, then stop the rest."""
        self.api.drain(grace)
        self.stop()

    def stop(self):
        for m in self.messengers:
            m.stop()
        self.api.stop()
        if self.local_runtime:
            self.local_runtime.stop()
        self.canary.stop()
        self.incidents.stop()
        # Identity-checked: a newer Manager's installs (tests build
        # several in one process) stay.
        uninstall_canary(self.canary)
        uninstall_recorder(self.incidents)
        self.forecaster.stop()
        uninstall_forecaster(self.forecaster)
        self.history_sampler.stop()
        uninstall_history(self.history)
        self.slo.stop()
        self.autoscaler.stop()
        self.election.stop()
        self.reconciler.stop()
        if self.parked_pool is not None:
            self.parked_pool.stop()
        self.lb.stop()
        if self._otel is not None:
            self._otel.stop()
            uninstall_exporter(self._otel)
            self._otel = None


def main(argv=None):
    parser = argparse.ArgumentParser("kubeai-tpu-torch-manager")
    parser.add_argument("--config", default=os.environ.get("CONFIG_PATH"))
    parser.add_argument("--local", action="store_true", help="run pods as local processes")
    parser.add_argument(
        "--kube",
        action="store_true",
        default=bool(os.environ.get("KUBERNETES_SERVICE_HOST")),
        help="back the store with the kube-apiserver (the default inside a cluster)",
    )
    parser.add_argument("--kube-api-server", default=None,
                        help="the apiserver's URL (implies --kube; e.g. kubectl proxy's)")
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
    setup_logging("operator")

    system = load_system_config(args.config) if args.config else System().default_and_validate()
    if args.catalog:
        from kubeai_tpu_torch.catalog import CATALOG

        names = [n.strip() for n in args.catalog.split(",") if n.strip()]
        unknown = [n for n in names if n not in CATALOG]
        if unknown:
            parser.error(f"unknown catalog entries {unknown}; available: {sorted(CATALOG)}")
    store = None
    want_kube = args.kube or bool(args.kube_api_server)
    if want_kube and args.local:
        log.warning("--local overrides --kube: pods run as local processes on the in-memory store")
    if want_kube and not args.local:
        from kubeai_tpu_torch.runtime.k8s import KubeStore

        store = KubeStore(api_server=args.kube_api_server)
    mgr = Manager(system, store=store, local_runtime=args.local, host=args.host, port=args.port)

    # SIGTERM (the kubelet's shutdown signal) drains: readiness flips to
    # 503 first, then in-flight requests get the grace budget. The handler
    # is in place before the lease can be taken; a drain asked for during
    # start() runs once start() has returned.
    done, started = threading.Event(), threading.Event()

    def _drain():
        started.wait()
        mgr.drain(args.drain_grace)
        done.set()

    def _on_term(signum, frame):
        # A handler must return at once; the drain runs on a thread.
        threading.Thread(target=_drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    mgr.start()
    started.set()

    if args.models:
        from kubeai_tpu_torch.catalog import apply_manifest_file

        apply_manifest_file(mgr.store, args.models)
    if args.catalog:
        from kubeai_tpu_torch.catalog import apply_catalog

        apply_catalog(mgr.store, names)

    try:
        while not done.is_set():
            done.wait(3600)
    except KeyboardInterrupt:
        mgr.stop()


if __name__ == "__main__":
    main()
