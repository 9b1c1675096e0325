"""The engine's observability (port of kubeai_tpu/obs): request tracing
(trace.py), the flight recorder and the /debug routes (recorder.py),
context-stamped logs (logs.py), the perf X-ray (perf.py), per-tenant cost
accounting (tenants.py), the metrics history (history.py), the OTLP
exporter (otel.py) and the incident trigger seam (incidents.py); and the
operator's SLO monitor (slo.py) and canary prober (canary.py). The JAX
package's incident recorder and forecaster are not ported (ROADMAP queue
1, item 7b); an engine answers the operator-side routes 404, as a JAX
engine does."""
