"""The engine's observability (port of kubeai_tpu/obs): request tracing
(trace.py), the flight recorder and the /debug routes (recorder.py),
context-stamped logs (logs.py) and the perf X-ray (perf.py). The JAX
package's operator-side surfaces (incidents, canary, history, forecast,
SLOs), the tenant accountant and the OTLP exporter are not ported
(ROADMAP queue 1)."""
