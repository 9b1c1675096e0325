"""Observability (port of kubeai_tpu/obs): request tracing (trace.py), the
flight recorder and the /debug routes (recorder.py), context-stamped logs
(logs.py), the perf X-ray (perf.py), per-tenant cost accounting
(tenants.py), the metrics history (history.py) and the OTLP exporter
(otel.py) on both servers; and the operator's SLO monitor (slo.py), canary
prober (canary.py), forecaster (forecast.py), incident black box
(incidents.py) and its renderer (incident_report.py). An engine answers
the operator-side routes 404, as a JAX engine does."""

from kubeai_tpu_torch.obs.canary import (
    CanaryProber,
    handle_canary_request,
    install_canary,
    uninstall_canary,
)
from kubeai_tpu_torch.obs.forecast import (
    Forecaster,
    derive_lead_seconds,
    handle_forecast_request,
    install_forecaster,
    installed_forecaster,
    uninstall_forecaster,
)
from kubeai_tpu_torch.obs.history import (
    HistoryStore,
    RegistrySampler,
    handle_history_request,
    install_history,
    installed_history,
    sparkline,
    uninstall_history,
)
from kubeai_tpu_torch.obs.incidents import (
    IncidentRecorder,
    handle_incident_request,
    install_recorder,
    publish_trigger,
    standard_sources,
    uninstall_recorder,
)

__all__ = [
    "CanaryProber",
    "handle_canary_request",
    "install_canary",
    "uninstall_canary",
    "Forecaster",
    "derive_lead_seconds",
    "handle_forecast_request",
    "install_forecaster",
    "installed_forecaster",
    "uninstall_forecaster",
    "HistoryStore",
    "RegistrySampler",
    "handle_history_request",
    "install_history",
    "installed_history",
    "sparkline",
    "uninstall_history",
    "IncidentRecorder",
    "handle_incident_request",
    "install_recorder",
    "publish_trigger",
    "standard_sources",
    "uninstall_recorder",
]
