"""Prometheus-style metrics registry (port of kubeai_tpu/metrics/registry.py).

Counters, gauges, callback gauges and histograms, each with labels, and
the Prometheus text exposition that the engine serves on ``GET /metrics``.
Names and help strings are the JAX engine's, so the operator's autoscaler
(``parse_prometheus_text``) reads the port's page as it reads the JAX
engine's. Stdlib only. ``snapshot()`` and ``Registry.metrics()`` are the
seams the history sampler (obs/history.py) and the OTLP exporter
(obs/otel.py) read. Exemplars are left out: nothing in the port reads
them.
"""

from __future__ import annotations

import threading
from bisect import bisect_left


def _escape_label_value(v: str) -> str:
    """Exposition-format label escaping: backslash first, then quote and
    newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def _key(self, labels: dict[str, str] | None):
        return tuple(sorted((labels or {}).items()))

    def remove(self, labels: dict[str, str] | None = None) -> None:
        """Drop one labeled series (no-op if absent)."""
        with self._lock:
            self._values.pop(self._key(labels), None)

    def value(self, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def snapshot(self) -> dict[tuple[tuple[str, str], ...], float]:
        """A point-in-time copy of every labeled series."""
        with self._lock:
            return dict(self._values)

    def collect(self) -> list[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
            for key, val in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
            return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, labels: dict[str, str] | None = None):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: dict[str, str] | None = None):
        with self._lock:
            self._values[self._key(labels)] = value


class CallbackGauge(_Metric):
    """A gauge computed by a callback when the page is rendered, so
    occupancy can never go stale between events. Registering the name
    again rebinds the callback: the latest owner wins."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = "", fn=None):
        super().__init__(name, help_)
        self._fn = fn

    def set_callback(self, fn) -> None:
        with self._lock:
            self._fn = fn

    def clear_callback(self, fn) -> None:
        """Unbind *fn* if it is still the callback (a stopped owner must
        not clobber a newer owner's binding)."""
        with self._lock:
            if self._fn is fn:
                self._fn = None

    def value(self, labels=None) -> float:
        with self._lock:
            fn = self._fn
        return float(fn()) if fn is not None else 0.0

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        try:
            lines.append(f"{self.name} {self.value()}")
        except Exception:
            pass  # a dying callback must never break the whole page
        return lines


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = sorted(buckets)
        self._obs: dict[tuple, list] = {}  # key -> [bucket_counts, sum, count]

    def observe(self, value: float, labels: dict[str, str] | None = None):
        key = self._key(labels)
        idx = bisect_left(self.buckets, value)  # "le" semantics; the last slot is +Inf
        with self._lock:
            entry = self._obs.setdefault(key, [[0] * (len(self.buckets) + 1), 0.0, 0])
            entry[0][idx] += 1
            entry[1] += value
            entry[2] += 1

    def snapshot(self) -> dict[tuple, tuple[list[int], float, int]]:
        """A point-in-time copy: key -> (per-bucket counts with the +Inf
        slot last, not cumulative, unlike the exposition; sum; count)."""
        with self._lock:
            return {k: (list(c), s, n) for k, (c, s, n) in self._obs.items()}

    def collect(self) -> list[str]:
        with self._lock:
            lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
            for key, (counts, total, n) in sorted(self._obs.items()):
                labels = dict(key)
                cum = 0
                for b, c in zip(self.buckets + [float("inf")], counts):
                    cum += c
                    lb = dict(labels)
                    lb["le"] = "+Inf" if b == float("inf") else repr(b)
                    lines.append(f"{self.name}_bucket{_fmt_labels(lb)} {cum}")
                lines.append(f"{self.name}_sum{_fmt_labels(labels)} {total}")
                lines.append(f"{self.name}_count{_fmt_labels(labels)} {n}")
            return lines


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, help_, Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, help_, Gauge)

    def callback_gauge(self, name: str, help_: str = "", fn=None) -> CallbackGauge:
        g = self._get_or_create(name, help_, CallbackGauge, lambda: CallbackGauge(name, help_, fn))
        if fn is not None:
            g.set_callback(fn)
        return g

    def histogram(self, name: str, help_: str = "",
                  buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, help_, Histogram, lambda: Histogram(name, help_, buckets))

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> dict[str, _Metric]:
        """A point-in-time copy of the name -> metric map (the history
        sampler and the exporter iterate it)."""
        with self._lock:
            return dict(self._metrics)

    def _get_or_create(self, name, help_, cls, factory=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory() if factory else cls(name, help_)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


default_registry = Registry()


def set_build_info(server: str) -> None:
    """``kubeai_build_info`` (the JAX package's build-identity series:
    value 1, identity in labels) with the port's stack in the labels."""
    import platform

    import torch

    default_registry.gauge(
        "kubeai_build_info",
        "Build identity (value 1; server/python/torch/cuda in labels)",
    ).set(1.0, labels={"server": server, "python": platform.python_version(),
                       "torch": torch.__version__, "cuda": str(torch.version.cuda)})
