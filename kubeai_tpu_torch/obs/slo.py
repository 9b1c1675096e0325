"""SLO monitor (port of kubeai_tpu/obs/slo.py): rolling-window attainment
and error-budget burn rate over configurable TTFT / end-to-end-latency /
error-rate objectives, computed from the histograms and counters the
serving path already maintains.

No new instrumentation on any hot path: the monitor snapshots the
CUMULATIVE state of existing metrics on each tick, keeps a bounded
window of snapshots, and differences newest-vs-oldest to get the
window's (good, total) counts. Latency objectives resolve their
threshold to the smallest histogram bucket bound >= the threshold,
clamping DOWN to the largest finite bucket when the threshold exceeds
every bound (counting the +Inf overflow as "good" would make the
objective vacuous); the ``effective_threshold_s`` each report carries
makes the bucket granularity explicit, never silently rounded.

The engine histograms live in ENGINE processes; on the operator they
are only visible through the fleet collector's endpoint scrapes. Pass
``remote_pages`` (e.g. ``FleetCollector.parsed_pages``) and each tick
also folds in the cumulative bucket/counter state parsed from those
pages — Prometheus exposition buckets are already cumulative, so the
window math is identical. An engine pod restart resets its counters;
negative window deltas clamp to zero (a brief dip in window volume,
not garbage).

Exposed as ``kubeai_slo_*`` gauges and ``GET /debug/slo`` on the
operator; a burn past ``KUBEAI_SLO_BURN_TRIGGER`` fires ``slo_burn``
through ``obs/incidents.publish_trigger``. `attainment_block` and
`error_rate_block` are the one-shot forms for a run's SLO block (no
window: the run is the window). ``bucket_quantile`` is shared with the
history sampler (``obs/history.py``).

Knobs (env, read at construction): KUBEAI_SLO_TTFT_SECONDS /
KUBEAI_SLO_TTFT_TARGET, KUBEAI_SLO_E2E_SECONDS / KUBEAI_SLO_E2E_TARGET,
KUBEAI_SLO_ERROR_TARGET, KUBEAI_SLO_WINDOW_SECONDS.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass

from kubeai_tpu_torch import env_float as _env_float
from kubeai_tpu_torch.metrics import Counter, Histogram, default_registry
from kubeai_tpu_torch.obs.incidents import publish_trigger

M_ATTAIN = default_registry.gauge(
    "kubeai_slo_attainment",
    "rolling-window SLO attainment fraction per objective (1.0 with no traffic)",
)
M_BURN = default_registry.gauge(
    "kubeai_slo_burn_rate",
    "error-budget burn-rate multiple per objective (1.0 = burning exactly the budget)",
)
M_WINDOW_REQS = default_registry.gauge(
    "kubeai_slo_window_requests",
    "requests observed inside the SLO rolling window per objective",
)
M_TARGET = default_registry.gauge(
    "kubeai_slo_objective_target",
    "configured attainment target per objective (constant; for dashboard math)",
)


@dataclass(frozen=True)
class SLObjective:
    name: str           # label value ("ttft", "e2e", "error_rate", ...)
    kind: str           # "latency" (histogram <= threshold) | "error" (counter outcome)
    metric: str         # metric name in the registry
    target: float       # attainment target, e.g. 0.95
    threshold_s: float | None = None  # latency objectives only
    error_label: str = "outcome"      # error objectives: label key...
    error_value: str = "error"        # ...and the value that counts as bad
    # Latency objectives over outcome-labeled histograms: only series
    # carrying this (label, value) pair count as GOOD (every series
    # still counts toward the total) — a request that errored in 0.2s
    # must violate the latency objective, not satisfy it. None = all
    # series are good candidates (unlabeled histograms).
    good_label: tuple[str, str] | None = None
    # Restrict the whole objective to series carrying this (label,
    # value) pair — e.g. one queue-wait objective per priority class
    # over the shared kubeai_qos_queue_wait_seconds histogram. Unlike
    # good_label, non-matching series are excluded from the TOTAL too:
    # they belong to a sibling objective, not to this one's traffic.
    series_label: tuple[str, str] | None = None



def default_objectives() -> list[SLObjective]:
    out = [
        SLObjective(
            name="ttft", kind="latency", metric="kubeai_engine_ttft_seconds",
            threshold_s=_env_float("KUBEAI_SLO_TTFT_SECONDS", 2.0),
            target=_env_float("KUBEAI_SLO_TTFT_TARGET", 0.95),
        ),
        SLObjective(
            name="e2e", kind="latency", metric="kubeai_request_e2e_seconds",
            threshold_s=_env_float("KUBEAI_SLO_E2E_SECONDS", 30.0),
            target=_env_float("KUBEAI_SLO_E2E_TARGET", 0.99),
            good_label=("outcome", "ok"),
        ),
        SLObjective(
            name="error_rate", kind="error", metric="kubeai_engine_requests_total",
            target=_env_float("KUBEAI_SLO_ERROR_TARGET", 0.999),
        ),
    ]
    # Per-class queue-wait objectives (docs/qos.md): one slice of the
    # shared class-labeled histogram each. Interactive's budget is tight
    # (preemption exists to keep it), batch's is deliberately loose —
    # batch WAITING is the design, batch starving forever is not.
    for cls, thr_default, tgt_default in (
        ("interactive", 0.5, 0.99),
        ("standard", 2.0, 0.95),
        ("batch", 30.0, 0.9),
    ):
        out.append(SLObjective(
            name=f"qos_wait_{cls}", kind="latency",
            metric="kubeai_qos_queue_wait_seconds",
            threshold_s=_env_float(f"KUBEAI_SLO_QOS_{cls.upper()}_SECONDS", thr_default),
            target=_env_float(f"KUBEAI_SLO_QOS_{cls.upper()}_TARGET", tgt_default),
            series_label=("class", cls),
        ))
    return out


def bucket_quantile(bounds, counts, q: float) -> float | None:
    """Quantile estimate from per-bucket observation counts
    (NON-cumulative, +Inf slot last — ``Histogram.snapshot()`` layout):
    the upper bound of the bucket the q-th observation lands in. Returns
    None with no observations. A quantile landing in the +Inf overflow
    clamps DOWN to the largest finite bound — the estimate is then a
    floor, honest the same way the latency objectives' threshold clamp
    is: it can understate a spike, never invent one. Shared by the SLO
    math and the history sampler's p50/p95 derivation, so the two can't
    disagree about what a histogram says."""
    total = sum(counts)
    if total <= 0 or not bounds:
        return None
    target = q * total
    cum = 0.0
    finite = list(bounds)
    for b, c in zip(finite + [float("inf")], counts):
        cum += c
        if cum >= target - 1e-9:
            return float(b) if b != float("inf") else float(finite[-1])
    return float(finite[-1])


def burn_rate(attainment: float, target: float) -> float:
    """Error-budget burn multiple: 1.0 = failing exactly (1-target) of
    requests; >1 = budget burning faster than it accrues."""
    if target >= 1.0:
        return 0.0 if attainment >= 1.0 else float("inf")
    return (1.0 - attainment) / (1.0 - target)


def attainment_block(values_s: list[float], threshold_s: float, target: float, failures: int = 0) -> dict:
    """One-shot SLO block over raw latency samples (bench/loadgen: no
    windowing — the run IS the window). *failures* are requests that
    produced no latency sample at all (errored/vanished): they count
    toward the total and against the objective — a failed request can
    never satisfy a latency SLO."""
    n = len(values_s) + failures
    good = sum(1 for v in values_s if v <= threshold_s)
    att = good / n if n else 1.0
    return {
        "objective_s": threshold_s,
        "target": target,
        "requests": n,
        "attainment": round(att, 4),
        "burn_rate": round(burn_rate(att, target), 3),
    }


def error_rate_block(failures: int, total: int, target: float = 0.999) -> dict:
    att = (total - failures) / total if total else 1.0
    return {
        "target": target,
        "requests": total,
        "failures": failures,
        "attainment": round(att, 4),
        "burn_rate": round(burn_rate(att, target), 3),
    }


def _page_cumulative(page: dict, obj: SLObjective) -> tuple[float, float, float | None]:
    """(good, total, effective_threshold) from one parsed /metrics page
    (``parse_prometheus_text`` output). Exposition histogram buckets are
    CUMULATIVE, so "good" is the value of the chosen bucket directly —
    smallest finite ``le`` >= threshold, clamped down to the largest
    finite one when the threshold exceeds them all (same rule as the
    local registry path)."""
    if obj.kind == "latency":
        total = sum(
            v
            for labels, v in page.get(obj.metric + "_count", [])
            if obj.series_label is None
            or labels.get(obj.series_label[0]) == obj.series_label[1]
        )
        groups: dict[tuple, list[tuple[float, float]]] = {}
        for labels, v in page.get(obj.metric + "_bucket", []):
            try:
                le = float(labels.get("le", ""))
            except ValueError:
                continue
            key = tuple(
                sorted((k, lv) for k, lv in labels.items() if k != "le")
            )
            groups.setdefault(key, []).append((le, v))
        good = 0.0
        eff: float | None = None
        for key, items in groups.items():
            if obj.series_label is not None and obj.series_label not in key:
                continue  # another objective's slice of this histogram
            if obj.good_label is not None and obj.good_label not in key:
                continue  # non-good series still counted in total above
            finite = sorted(p for p in items if p[0] != float("inf"))
            if not finite:
                continue
            chosen = next(
                (p for p in finite if p[0] >= obj.threshold_s), finite[-1]
            )
            good += chosen[1]
            eff = chosen[0] if eff is None else min(eff, chosen[0])
        return good, total, eff
    bad = total = 0.0
    for labels, v in page.get(obj.metric, []):
        if obj.series_label is not None and labels.get(
            obj.series_label[0]
        ) != obj.series_label[1]:
            continue
        total += v
        if labels.get(obj.error_label) == obj.error_value:
            bad += v
    return total - bad, total, None


class SLOMonitor:
    """Ticks on its own daemon thread (or externally via ``tick()`` with
    an injected clock in tests); serves ``report()`` to /debug/slo."""

    def __init__(
        self,
        objectives: list[SLObjective] | None = None,
        registry=None,
        window_seconds: float | None = None,
        interval_seconds: float = 10.0,
        clock=time.monotonic,
        remote_pages=None,
        election=None,
    ):
        self.objectives = list(objectives) if objectives is not None else default_objectives()
        self.registry = registry or default_registry
        # Callable returning parsed remote /metrics pages (the fleet
        # collector's last endpoint scrapes) — how the operator sees
        # engine-side histograms. None = local registry only.
        self._remote_pages = remote_pages
        # Leader gate: with a remote source, only the leader's
        # autoscaler tick keeps the fleet scrapes warm — a non-leader
        # replica ticking anyway would difference mostly-empty pages
        # and export vacuously GREEN kubeai_slo_* series (the exact
        # failure this monitor exists to prevent). Gated replicas set
        # no gauges at all: an absent series is honest, a 1.0 is a lie.
        self._election = election
        self._was_leader = False
        self.window = (
            window_seconds
            if window_seconds is not None
            else _env_float("KUBEAI_SLO_WINDOW_SECONDS", 300.0)
        )
        self.interval = interval_seconds
        self._clock = clock
        # Incident trigger: a burn rate at/above this multiple (with at
        # least the minimum window volume — a 1-request window burning
        # "fast" is noise) publishes an slo_burn trigger to the incident
        # recorder, which captures the correlated cross-layer snapshot.
        self.burn_trigger = _env_float("KUBEAI_SLO_BURN_TRIGGER", 4.0)
        self.trigger_min_requests = _env_float("KUBEAI_SLO_TRIGGER_MIN", 10.0)
        self._lock = threading.Lock()
        # (t, {objective: (good, total)}) cumulative snapshots; the
        # oldest in-window snapshot is the delta baseline.
        self._snaps: deque[tuple[float, dict[str, tuple[float, float]]]] = deque()
        self._state: dict[str, dict] = {}
        self._running = False
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        for o in self.objectives:
            M_TARGET.set(o.target, labels={"slo": o.name})
        # Seed the window baseline NOW so the first periodic tick
        # reports real deltas instead of a vacuous empty window. (With a
        # remote source, engine history predating this process can land
        # in the first window — it ages out as the window fills.)
        try:
            self._snaps.append((
                self._clock(),
                {o.name: self._cumulative(o)[:2] for o in self.objectives},
            ))
        except Exception:  # pragma: no cover - seeding is best-effort
            pass

    # -- cumulative reads --------------------------------------------------

    def _cumulative(self, obj: SLObjective) -> tuple[float, float, float | None]:
        """(good, total, effective_threshold) cumulative since process
        start for *obj*, summed over the local registry AND any remote
        scrape pages; a metric missing everywhere reads as no traffic."""
        good, total, eff = self._local_cumulative(obj)
        if self._remote_pages is not None:
            try:
                pages = self._remote_pages()
            except Exception:  # pragma: no cover - source must not kill ticks
                pages = []
            for page in pages:
                g, t, e = _page_cumulative(page, obj)
                good += g
                total += t
                # Mixed bucket layouts (rolling upgrade): each source
                # clamps independently; report the TIGHTEST bound in use
                # so a fleet half-measured at a lower bucket is visible.
                if e is not None:
                    eff = e if eff is None else min(eff, e)
        return good, total, eff

    def _local_cumulative(self, obj: SLObjective) -> tuple[float, float, float | None]:
        m = self.registry.get(obj.metric)
        if obj.kind == "latency":
            if not isinstance(m, Histogram):
                return 0.0, 0.0, None
            # Smallest bucket bound >= threshold; clamp DOWN to the
            # largest finite bucket when the threshold exceeds them all
            # (the +Inf slot holds every violation — counting it "good"
            # would pin attainment at 1.0 no matter how slow requests
            # get). Clamping tightens the objective, conservatively.
            k = min(bisect_left(m.buckets, obj.threshold_s), len(m.buckets) - 1)
            effective = m.buckets[k]
            good = total = 0.0
            for key, (counts, _, n) in m.snapshot().items():
                if obj.series_label is not None and obj.series_label not in key:
                    continue
                total += n
                if obj.good_label is None or obj.good_label in key:
                    good += sum(counts[: k + 1])
            return good, total, effective
        if not isinstance(m, Counter):
            return 0.0, 0.0, None
        bad = total = 0.0
        for key, v in m.snapshot().items():
            if obj.series_label is not None and obj.series_label not in key:
                continue
            total += v
            if (obj.error_label, obj.error_value) in key:
                bad += v
        return total - bad, total, None

    # -- ticking -----------------------------------------------------------

    def tick(self) -> None:
        now = self._clock()
        cum = {}
        eff: dict[str, float | None] = {}
        for o in self.objectives:
            good, total, effective = self._cumulative(o)
            cum[o.name] = (good, total)
            eff[o.name] = effective
        crossings: list[dict] = []
        with self._lock:
            self._snaps.append((now, cum))
            # Keep the snapshot that STARTS the window as the baseline:
            # drop entries only once a newer one is also outside it.
            while len(self._snaps) >= 2 and self._snaps[1][0] <= now - self.window:
                self._snaps.popleft()
            base_t, base = self._snaps[0]
            for o in self.objectives:
                g0, t0 = base.get(o.name, (0.0, 0.0))
                g1, t1 = cum[o.name]
                good_d, total_d = max(g1 - g0, 0.0), max(t1 - t0, 0.0)
                att = good_d / total_d if total_d > 0 else 1.0
                burn = burn_rate(att, o.target)
                labels = {"slo": o.name}
                M_ATTAIN.set(round(att, 6), labels=labels)
                M_BURN.set(round(burn, 6), labels=labels)
                M_WINDOW_REQS.set(total_d, labels=labels)
                self._state[o.name] = {
                    "name": o.name,
                    "kind": o.kind,
                    "metric": o.metric,
                    "threshold_s": o.threshold_s,
                    "effective_threshold_s": eff[o.name],
                    "target": o.target,
                    "window_seconds": round(now - base_t, 3),
                    "requests": total_d,
                    "good": good_d,
                    "attainment": round(att, 6),
                    "burn_rate": round(burn, 4),
                }
                if (
                    total_d >= self.trigger_min_requests
                    and burn >= self.burn_trigger
                ):
                    crossings.append({
                        "slo": o.name,
                        "burn_rate": round(burn, 3),
                        "attainment": round(att, 6),
                        "window_requests": total_d,
                        "threshold": self.burn_trigger,
                    })
        # Publish OUTSIDE the lock: the capture worker reads report()
        # (which takes it); publish itself never blocks, but there is no
        # reason to hold state hostage while the bus debounces.
        for c in crossings:
            publish_trigger("slo_burn", detail=c, key=c["slo"])

    def report(self) -> dict:
        """The /debug/slo payload."""
        leading = (
            self._election is None or self._election.is_leader.is_set()
        )
        with self._lock:
            return {
                "window_seconds": self.window,
                "interval_seconds": self.interval,
                # False = this replica's loop is leader-gated and idle;
                # ask the lease holder for live numbers.
                "active": leading,
                "objectives": [
                    self._state.get(o.name, {"name": o.name, "pending": True})
                    for o in self.objectives
                ],
            }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, name="slo-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._stop_evt.set()  # interrupt the interval sleep immediately
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while self._running:
            if self._stop_evt.wait(self.interval):
                return
            self._gated_tick()

    def _gated_tick(self) -> None:
        """One periodic iteration: skip while not leader, and on
        (re)gaining leadership restart the window — every retained
        snapshot predates our scrapes, so differencing against it would
        compress the engines' ALL-TIME history into "the window",
        exactly during a failover incident. Takeover costs one vacuous
        interval, then deltas are real."""
        if (
            self._election is not None
            and not self._election.is_leader.is_set()
        ):
            if self._was_leader:
                # Demoted: our series must DISAPPEAR, not freeze at the
                # last led value (a stale attainment next to the new
                # leader's live one is the misleading-series failure the
                # gate exists to prevent).
                for o in self.objectives:
                    labels = {"slo": o.name}
                    M_ATTAIN.remove(labels)
                    M_BURN.remove(labels)
                    M_WINDOW_REQS.remove(labels)
                with self._lock:
                    self._state.clear()
            self._was_leader = False
            return
        if self._election is not None and not self._was_leader:
            with self._lock:
                self._snaps.clear()
            self._was_leader = True
        try:
            self.tick()
        except Exception:  # pragma: no cover - defensive
            import logging

            logging.getLogger("kubeai_tpu_torch.slo").exception("slo tick failed")
