"""Gray-failure latency scoring primitives (docs/robustness.md#gray-failures).

Port of kubeai_tpu/loadbalancer/health.py: the JAX package's code,
its imports in this package.

The passive breaker in group.py only sees HARD failures: an endpoint
that is alive-but-slow (thermal throttling, a sick host, a recompile
storm, one lagging gang member) keeps its breaker closed while it
silently destroys fleet p99 TTFT. This module holds the evidence
machinery the group's scorer is built on: a per-endpoint rolling
latency window (EWMA + bounded p95 sample deque + a per-scoring-window
arrival counter for the min-request floor), the fleet-median helper the
RELATIVE outlier test needs (absolute thresholds can't tell "slow
model" from "slow replica"), and the deterministic per-endpoint hash
used both to jitter half-open probes and to keep tests reproducible.

Knobs resolve ctor-arg > env > default via ``resolve_knob`` so the
operator CLI, the drills, and unit tests all configure the same way:

    KUBEAI_OUTLIER_K              p95 > k x fleet median = outlier (0 disables)
    KUBEAI_OUTLIER_MIN_REQUESTS   fresh samples required before judging
    KUBEAI_SCORING_WINDOW         seconds between scoring passes
    KUBEAI_MAX_EJECT_FRACTION     fleet share beyond which scoring disables itself
    KUBEAI_SLOW_START_WINDOW      warmup ramp seconds for new/readmitted endpoints
    KUBEAI_PROBE_JITTER           half-open cooldown spread fraction
"""

from __future__ import annotations

import math
import zlib
from collections import deque

from kubeai_tpu_torch import env_float

# Slow-start ramp: a warming endpoint starts at this share of its full
# weight and climbs linearly to 1.0 over the warmup window.
RAMP_FLOOR = 0.1
# Outlier weight ladder: each scoring window an outlier's pick weight is
# multiplied by WEIGHT_DECAY, floored at WEIGHT_FLOOR; an endpoint that
# is STILL an outlier at the floor is soft-ejected. Recovery climbs the
# same ladder in reverse (one step per clean window).
WEIGHT_DECAY = 0.5
WEIGHT_FLOOR = 0.25
# Effective-weight floor: weights bias selection, they never filter — a
# lone endpoint must still serve at any decay level, so the divisor in
# the weighted-load math is bounded away from zero.
MIN_EFFECTIVE_WEIGHT = 0.05


def resolve_knob(value, env_name: str, default: float) -> float:
    """Ctor arg wins, then the environment, then the default — groups
    are built by the LoadBalancer, by drills, and by tests, and all
    three need to reach the same knob."""
    if value is not None:
        return float(value)
    return env_float(env_name, default)


def endpoint_jitter(addr: str) -> float:
    """Deterministic hash of an endpoint address into [0, 1): the
    half-open probe spread. Stable across processes and restarts (a
    regression test can predict it), distinct for distinct addresses
    (997 is prime, so the modulus doesn't alias the port arithmetic
    of sequential pod addresses)."""
    return (zlib.crc32(addr.encode()) % 997) / 997.0


def fleet_median(values: list[float]) -> float:
    """Median of the judged endpoints' p95s — the reference point the
    relative outlier test compares against."""
    xs = sorted(values)
    n = len(xs)
    mid = n // 2
    if n % 2:
        return xs[mid]
    return (xs[mid - 1] + xs[mid]) / 2.0


class LatencyStats:
    """Rolling latency evidence for one endpoint.

    - ``ewma``: smoothed recent latency (alpha 0.3) — the trend surface
      the /debug/health view shows next to the windowed p95.
    - ``samples``: bounded deque the p95 is computed over (the scorer's
      actual decision input; bounded so one chatty endpoint costs O(1)).
    - ``window_count``: observations since the last scoring pass — the
      min-request floor, so a single slow request on an idle endpoint
      can't read as an outlier.
    - ``window_added``: deque APPENDS since the last pass (differs from
      window_count when a scrape aggregate credits many requests as one
      sample) — ``window_p95`` judges only this fresh slice, so a
      recovered endpoint isn't haunted by last window's slow samples.
    """

    __slots__ = ("ewma", "samples", "window_count", "window_added", "total")

    ALPHA = 0.3

    def __init__(self, maxlen: int = 128):
        self.ewma: float | None = None
        self.samples: deque[float] = deque(maxlen=maxlen)
        self.window_count = 0
        self.window_added = 0
        self.total = 0

    def observe(self, seconds: float, count: int = 1) -> None:
        """Feed one observation. *count* > 1 credits a scrape-derived
        aggregate (an engine-side histogram delta representing *count*
        requests) toward the min-request floor without fabricating
        *count* identical samples."""
        s = float(seconds)
        self.samples.append(s)
        self.window_count += max(int(count), 1)
        self.window_added += 1
        self.total += max(int(count), 1)
        self.ewma = s if self.ewma is None else self.ALPHA * s + (1 - self.ALPHA) * self.ewma

    def reset_window(self) -> None:
        self.window_count = 0
        self.window_added = 0

    @staticmethod
    def _p95_of(xs: list[float]) -> float | None:
        if not xs:
            return None
        xs = sorted(xs)
        idx = max(0, math.ceil(0.95 * len(xs)) - 1)
        return xs[idx]

    def p95(self) -> float | None:
        """Rolling p95 over the full bounded deque (the trend surface)."""
        return self._p95_of(list(self.samples))

    def window_p95(self) -> float | None:
        """p95 over only the samples added since the last scoring pass
        — the scorer's decision input. Judging the rolling deque would
        let one bad window's samples keep an endpoint 'slow' for many
        windows after it recovered."""
        n = min(self.window_added, len(self.samples))
        if n <= 0:
            return None
        return self._p95_of(list(self.samples)[-n:])
