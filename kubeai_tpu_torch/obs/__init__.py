"""The engine's observability (port of kubeai_tpu/obs): request tracing
(trace.py), the flight recorder and the /debug routes (recorder.py),
context-stamped logs (logs.py), the perf X-ray (perf.py), per-tenant cost
accounting (tenants.py), the metrics history (history.py), the OTLP
exporter (otel.py) and the incident trigger seam (incidents.py). The JAX
package's operator-side surfaces (the incident recorder, canary,
forecast, SLOs) are not ported: an engine answers their routes 404, as a
JAX engine does."""
