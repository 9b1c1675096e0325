"""Per-model endpoint group: in-flight accounting + blocking endpoint await.

Port of kubeai_tpu/loadbalancer/group.py: the JAX package's code,
its imports in this package.

Behavioral parity with the reference's endpoint group
(ref: internal/loadbalancer/group.go): requests block until the group has
at least one endpoint (the scale-from-zero cold-start path), a strategy
picks an endpoint, its in-flight counter is incremented, and the caller
gets a completion callback that decrements it. Go's closed-channel
broadcast is expressed here as a Condition + generation counter.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from kubeai_tpu_torch.loadbalancer.chwbl import HashRing, chwbl_choose
from kubeai_tpu_torch.loadbalancer.health import (
    MIN_EFFECTIVE_WEIGHT,
    RAMP_FLOOR,
    WEIGHT_DECAY,
    WEIGHT_FLOOR,
    LatencyStats,
    endpoint_jitter,
    fleet_median,
    resolve_knob,
)

from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.obs.incidents import publish_trigger
from kubeai_tpu_torch.obs.logs import get_logger

log = get_logger("kubeai_tpu_torch.loadbalancer")

LEAST_LOAD = "LeastLoad"
PREFIX_HASH = "PrefixHash"
# Baseline strategy for benchmark comparisons (the reference benchmarks
# against a k8s Service's round-robin; here it's selectable in-process:
# docs/benchmarks/prefix-aware-load-balancing.md methodology).
ROUND_ROBIN = "RoundRobin"

# CHWBL lookup telemetry (parity: the reference's
# kubeai_inference_requests_hash_lookup_* instruments,
# ref: internal/metrics/metrics.go:16-27). Handles resolved once — this
# sits on the per-request routing hot path.
_M_LOOKUP_INITIAL = default_registry.counter(
    "kubeai_inference_requests_hash_lookup_initial_total",
    "ring lookups landing on each initial endpoint",
)
_M_LOOKUP_FINAL = default_registry.counter(
    "kubeai_inference_requests_hash_lookup_final_total",
    "ring lookups resolving to each endpoint",
)
_M_LOOKUP_DEFAULT = default_registry.counter(
    "kubeai_inference_requests_hash_lookup_default_total",
    "lookups that fell back past the load bound",
)
_M_LOOKUP_ITER = default_registry.histogram(
    "kubeai_inference_requests_hash_lookup_iterations",
    "ring slots walked per lookup",
    buckets=(1, 4, 16, 64, 256, 1024, 4096),
)

# Passive endpoint health (circuit breaking): per-endpoint state gauge
# (0=closed, 1=half_open, 2=open, 3=soft_ejected) and an ejection
# counter — the observable evidence of the eject -> half-open -> close
# lifecycle. soft_ejected is the gray-failure rung: the endpoint is
# alive but a latency outlier; it shares the open state's half-open
# readmission machinery but still serves batch-class traffic.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
BREAKER_SOFT_EJECTED = "soft_ejected"
_STATE_VALUE = {
    BREAKER_CLOSED: 0,
    BREAKER_HALF_OPEN: 1,
    BREAKER_OPEN: 2,
    BREAKER_SOFT_EJECTED: 3,
}
_M_ENDPOINT_STATE = default_registry.gauge(
    "kubeai_endpoint_state",
    "circuit-breaker state per endpoint (0=closed, 1=half_open, 2=open, 3=soft_ejected)",
)
_M_EJECTIONS = default_registry.counter(
    "kubeai_endpoint_ejections_total",
    "endpoints ejected by the passive-health circuit breaker",
)
_M_HEALTH_SCORE = default_registry.gauge(
    "kubeai_endpoint_health_score",
    "latency-derived routing health per endpoint (1.0=full weight, 0.0=ejected)",
)
_M_SOFT_EJECTIONS = default_registry.counter(
    "kubeai_endpoint_soft_ejections_total",
    "endpoints soft-ejected as fleet-relative latency outliers",
)


def _record_chwbl_stats(stats: dict) -> None:
    """Initial is recorded for every lookup (the reference records it
    before the walk, balance_chwbl.go:22-27); final/iterations/default
    only for resolved lookups (no-endpoint returns record nothing more,
    balance_chwbl.go:84)."""
    if stats.get("initial"):
        _M_LOOKUP_INITIAL.inc(labels={"endpoint": stats["initial"]})
    if not stats.get("final"):
        return
    _M_LOOKUP_FINAL.inc(labels={"endpoint": stats["final"]})
    if stats.get("default"):
        _M_LOOKUP_DEFAULT.inc(labels={"endpoint": stats["final"]})
    _M_LOOKUP_ITER.observe(stats.get("iterations", 0))


@dataclass
class Endpoint:
    address: str
    adapters: set[str] = field(default_factory=set)
    # Disaggregated phase role ("prefill" | "decode") from the pod's
    # kubeai.org/role label; "" on unified pods. Selection PREFERS a
    # requested role but fails open across pools (see get_best_addr).
    role: str = ""
    in_flight: int = 0
    # Passive-health circuit breaker (fed by the proxy's per-attempt
    # outcomes via EndpointGroup.report_result):
    breaker_state: str = BREAKER_CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0  # clock() when the breaker last opened
    probe_started: float | None = None  # half-open probe in flight since
    # Gray-failure defense (docs/robustness.md#gray-failures): pick
    # weight decayed by the latency scorer (1.0 = full share), the
    # slow-start ramp anchor (None = not warming), and the rolling
    # latency evidence the scorer judges.
    weight: float = 1.0
    warmup_started: float | None = None
    stats: LatencyStats = field(default_factory=LatencyStats)
    # Flap defense: when this endpoint last closed its breaker (None =
    # never ejected, or stable long enough to forget), and how many
    # times it re-ejected shortly after a readmission. The streak
    # escalates the probe cooldown geometrically so a replica flapping
    # faster than the cooldown converges to ejected instead of winning
    # a probe (and real traffic) every cycle.
    readmitted_at: float | None = None
    reopen_streak: int = 0


class EndpointGroup:
    def __init__(
        self,
        chwbl_replication: int = 256,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 10.0,
        clock=time.monotonic,
        name: str = "",
        outlier_k: float | None = None,
        outlier_min_requests: float | None = None,
        scoring_window: float | None = None,
        max_eject_fraction: float | None = None,
        slow_start_window: float | None = None,
        probe_jitter: float | None = None,
        breaker_cooldown_max: float | None = None,
    ):
        """*breaker_threshold* consecutive failed attempts eject an
        endpoint for *breaker_cooldown* seconds; after the cooldown it
        goes half-open and admits ONE probe request — success closes the
        breaker, failure re-ejects. ``breaker_threshold <= 0`` disables
        breaking. *clock* is injectable so tests drive cooldowns with a
        fake clock instead of sleeps. *name* is the model this group
        serves — incident triggers and the routing snapshot carry it.

        Gray-failure knobs (None resolves from the environment, see
        health.py): *outlier_k* — an endpoint whose windowed p95 exceeds
        k x the fleet median is an outlier (<=0 disables scoring);
        *outlier_min_requests* — fresh samples required per window
        before an endpoint is judged; *scoring_window* — seconds between
        scoring passes; *max_eject_fraction* — if a pass would leave
        more than this share of the fleet ejected, scoring disables
        itself entirely (the PR 3 fail-open invariant, now for latency);
        *slow_start_window* — warmup ramp for new/readmitted endpoints;
        *probe_jitter* — spread fraction applied to half-open cooldowns
        so a burst-ejected fleet doesn't re-probe in lockstep;
        *breaker_cooldown_max* — ceiling for the flap-escalated probe
        cooldown (re-ejections shortly after readmission double the
        effective cooldown up to this cap, so a flapping replica is
        quarantined geometrically instead of oscillating)."""
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._endpoints: dict[str, Endpoint] = {}
        self._total_in_flight = 0
        self._generation = 0
        self._rr_counter = 0
        self._ring = HashRing(replication=chwbl_replication)
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._clock = clock
        self.name = name
        self.outlier_k = resolve_knob(outlier_k, "KUBEAI_OUTLIER_K", 3.0)
        self.outlier_min_requests = int(
            resolve_knob(outlier_min_requests, "KUBEAI_OUTLIER_MIN_REQUESTS", 8)
        )
        self.scoring_window = resolve_knob(scoring_window, "KUBEAI_SCORING_WINDOW", 5.0)
        self.max_eject_fraction = resolve_knob(
            max_eject_fraction, "KUBEAI_MAX_EJECT_FRACTION", 1.0 / 3.0
        )
        self.slow_start_window = resolve_knob(
            slow_start_window, "KUBEAI_SLOW_START_WINDOW", 10.0
        )
        self.probe_jitter = resolve_knob(probe_jitter, "KUBEAI_PROBE_JITTER", 0.25)
        self.breaker_cooldown_max = resolve_knob(
            breaker_cooldown_max, "KUBEAI_BREAKER_COOLDOWN_MAX", 60.0
        )
        self._last_score = self._clock()
        self._fleet_median_p95: float | None = None
        self._scoring_disabled_reason: str | None = None
        self._soft_ejections = 0
        # Recent endpoint picks (routing observability): (clock t, pod
        # name, strategy) ring — deque appends are atomic under the GIL
        # and the pick path already holds the group lock.
        self._picks: deque[tuple[float, str, str]] = deque(maxlen=512)

    # -- balancing ---------------------------------------------------------

    def get_best_addr(
        self,
        strategy: str = LEAST_LOAD,
        prefix: str = "",
        adapter: str = "",
        mean_load_factor: float = 1.25,
        timeout: float | None = None,
        cancelled: threading.Event | None = None,
        exclude: set[str] | None = None,
        role: str = "",
        priority: str = "",
    ):
        """Block until an endpoint is available and return
        ``(address, done_fn)``; ``done_fn`` must be called when the request
        completes to release the in-flight slot.

        *role* is a phase-role PREFERENCE (disaggregated serving): healthy
        same-role endpoints win, then healthy endpoints of any role —
        a request must fall back to unified serving on the surviving
        pool when its whole role pool is ejected, never 503 — and only
        a total outage reaches the breaker-ignoring fail-open rungs.

        *priority* is the request's QoS class: batch-class traffic may
        still route to soft-ejected (latency-outlier) endpoints — batch
        is preemptible and replay-protected, so sick-but-alive capacity
        becomes the bulk tier instead of idling.

        Raises TimeoutError on deadline, and RuntimeError if *cancelled* is
        set while waiting.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            await_change = False
            while True:
                while await_change or not self._endpoints:
                    gen = self._generation
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError("timed out awaiting model endpoints")
                    if cancelled is None:
                        self._cond.wait(remaining)
                    else:
                        # Wake periodically to observe cancellation.
                        self._cond.wait(min(remaining, 0.1) if remaining is not None else 0.1)
                        if cancelled.is_set():
                            raise RuntimeError("request cancelled while awaiting endpoints")
                    if self._generation != gen:
                        await_change = False

                # Preference ladder: avoid endpoints that already failed
                # THIS request (exclude) and endpoints the breaker has
                # ejected — but fail OPEN rather than deadlock: when every
                # endpoint is excluded/ejected, a total-outage group still
                # routes (the alternative is every request blocking until
                # the cooldown, which turns a blip into an outage).
                # Rung order with a role preference: fresh same-role >
                # fresh any-role > already-failed endpoints > anything
                # (breaker ignored). A fresh endpoint on the OTHER pool
                # beats re-picking one that already failed this request
                # — and an ejected role pool loses to the healthy other
                # pool, so the breaker-ignoring rungs drop the role
                # filter too.
                rungs = [(role, exclude, False)]
                if role:
                    rungs.append(("", exclude, False))
                if exclude:
                    rungs.append((role, None, False))
                    if role:
                        rungs.append(("", None, False))
                rungs.append(("", exclude, True))
                if exclude:
                    rungs.append(("", None, True))
                name = None
                for r_role, r_exclude, r_ignore in rungs:
                    name = self._choose(
                        strategy, prefix, adapter, mean_load_factor, r_exclude,
                        ignore_breaker=r_ignore, role=r_role, priority=priority,
                    )
                    if name is not None:
                        break
                if name is None:
                    # No endpoint can serve this request (e.g. adapter not
                    # yet loaded anywhere) — wait for the endpoint set to
                    # change (ref: group.go:78-80 recursion).
                    await_change = True
                    continue

                ep = self._endpoints[name]
                if ep.breaker_state == BREAKER_HALF_OPEN:
                    # This request IS the probe: until its outcome is
                    # reported, other requests skip this endpoint.
                    ep.probe_started = self._clock()
                ep.in_flight += 1
                self._total_in_flight += 1
                self._picks.append((self._clock(), name, strategy))

                def done(_name=name):
                    with self._lock:
                        e = self._endpoints.get(_name)
                        if e is not None:
                            e.in_flight -= 1
                        self._total_in_flight -= 1

                return ep.address, done

    def _choose(
        self,
        strategy: str,
        prefix: str,
        adapter: str,
        mean_load_factor: float,
        exclude: set[str] | None = None,
        ignore_breaker: bool = False,
        role: str = "",
        priority: str = "",
    ):
        # Single source of truth for retry exclusion + breaker ejection
        # + role filtering; None when none applies (keeps the CHWBL fast
        # path allocation-free in the healthy steady state).
        now = self._clock()
        self._maybe_score(now)
        breaker_live = (
            not ignore_breaker
            and self.breaker_threshold > 0
            and any(
                ep.breaker_state != BREAKER_CLOSED
                for ep in self._endpoints.values()
            )
        )
        allowed = None
        if exclude or breaker_live or role:
            def allowed(name):
                ep = self._endpoints[name]
                if role and ep.role != role:
                    return False
                if exclude and ep.address in exclude:
                    return False
                if breaker_live and not self._breaker_allows(ep, now):
                    # Degraded-mode routing: a soft-ejected endpoint is
                    # slow, not dead — batch traffic (preemptible,
                    # replay-protected) may still use it.
                    if not (
                        priority == "batch"
                        and ep.breaker_state == BREAKER_SOFT_EJECTED
                    ):
                        return False
                return True

        if strategy == PREFIX_HASH:
            stats: dict = {}
            # Weighted bounded load: a decayed/warming endpoint's
            # in-flight is inflated relative to its weight so the CHWBL
            # bound walks past stragglers sooner. Loads are normalized
            # by the MEAN weight so a uniformly warming fleet (every
            # weight equal) sees exactly the unweighted bound.
            endpoint_load = lambda n: self._endpoints[n].in_flight
            if any(
                ep.weight < 1.0 or ep.warmup_started is not None
                for ep in self._endpoints.values()
            ):
                weights = {
                    n: self._effective_weight(ep, now)
                    for n, ep in self._endpoints.items()
                }
                mean_w = sum(weights.values()) / len(weights)
                endpoint_load = lambda n: self._endpoints[n].in_flight * (
                    mean_w / max(weights[n], MIN_EFFECTIVE_WEIGHT)
                )
            name = chwbl_choose(
                self._ring,
                key=adapter + prefix,
                load_factor=mean_load_factor,
                adapter=adapter,
                has_adapter=lambda n, a: a in self._endpoints[n].adapters,
                endpoint_load=endpoint_load,
                total_load=self._total_in_flight,
                n_endpoints=len(self._endpoints),
                allowed=allowed,
                stats=stats,
            )
            _record_chwbl_stats(stats)
            return name
        if strategy == ROUND_ROBIN:
            names = sorted(
                n for n, ep in self._endpoints.items()
                if (not adapter or adapter in ep.adapters)
                and (allowed is None or allowed(n))
            )
            if not names:
                return None
            self._rr_counter += 1
            return names[self._rr_counter % len(names)]
        if strategy == LEAST_LOAD:
            # Ties broken randomly: retries after an upstream failure must
            # be able to land on a different endpoint (the reference gets
            # this implicitly from Go's randomized map iteration).
            # Weighted: key = (in_flight + 1) / effective_weight — a
            # half-weight endpoint looks twice as loaded, so it wins
            # only when genuinely idler. With uniform weights the keys
            # are identical floats and tie sets match the unweighted
            # behavior exactly.
            candidates: list[str] = []
            best_load = None
            for name, ep in self._endpoints.items():
                if adapter and adapter not in ep.adapters:
                    continue
                if allowed is not None and not allowed(name):
                    continue
                key = (ep.in_flight + 1) / self._effective_weight(ep, now)
                if best_load is None or key < best_load:
                    best_load = key
                    candidates = [name]
                elif key == best_load:
                    candidates.append(name)
            return random.choice(candidates) if candidates else None
        raise ValueError(f"unknown load balancing strategy: {strategy!r}")

    # -- gray-failure latency scoring ---------------------------------------

    def observe_latency(self, addr: str, seconds: float, count: int = 1) -> None:
        """Feed one latency observation (TTFT or attempt latency,
        seconds) for *addr*. Sources: the proxy's per-attempt outcome
        path and the FleetCollector's engine-histogram scrape deltas
        (*count* credits an aggregate toward the min-request floor)."""
        if seconds < 0:
            return
        with self._cond:
            ep = next(
                (e for e in self._endpoints.values() if e.address == addr), None
            )
            if ep is None:
                return
            ep.stats.observe(seconds, count=count)
            self._maybe_score(self._clock())

    def _effective_weight(self, ep: Endpoint, now: float) -> float:
        """Pick weight after the slow-start ramp (lock held). Warming
        endpoints climb linearly from RAMP_FLOOR x weight to full
        weight over the warmup window; the ramp anchor is cleared once
        complete so the steady state pays nothing."""
        w = ep.weight
        if ep.warmup_started is not None:
            if self.slow_start_window <= 0:
                ep.warmup_started = None
            else:
                frac = (now - ep.warmup_started) / self.slow_start_window
                if frac >= 1.0:
                    ep.warmup_started = None
                else:
                    w *= RAMP_FLOOR + (1.0 - RAMP_FLOOR) * max(frac, 0.0)
        return max(w, MIN_EFFECTIVE_WEIGHT)

    def _start_warmup(self, ep: Endpoint, now: float) -> None:
        if self.slow_start_window > 0:
            ep.warmup_started = now

    def _maybe_score(self, now: float) -> None:
        """Run a scoring pass if the window has elapsed (lock held).
        Driven from the selection and observation paths — no timer
        thread, matching the breaker's lazy-transition idiom."""
        if self.outlier_k <= 0:
            return
        if now - self._last_score < self.scoring_window:
            return
        self._score(now)

    def _score(self, now: float) -> None:
        """One scoring pass (lock held): judge endpoints with enough
        fresh evidence against k x the fleet median p95, walk outliers
        down the weight ladder (1.0 -> 0.5 -> 0.25 -> soft-eject),
        recover non-outliers one rung per clean window, and disable
        scoring entirely when ejections would exceed the max fraction
        (whole-fleet-slow means the MODEL is slow, not a replica)."""
        self._last_score = now
        eps = list(self._endpoints.values())
        n = len(eps)
        judged: list[tuple[Endpoint, float]] = []
        starved: list[Endpoint] = []
        for ep in eps:
            # Judge the WINDOW p95 (fresh samples only): the rolling
            # deque is the trend surface, but letting one bad window's
            # samples linger in the decision input would keep a
            # recovered endpoint decayed for many windows afterwards.
            p95 = ep.stats.window_p95()
            # The min-request floor gates ENTERING the decay ladder: one
            # slow request on an idle endpoint is not an outlier. An
            # endpoint already decayed is judged on any fresh sample —
            # its own reduced pick share has removed the traffic the
            # floor was calibrated for, and holding it to the floor
            # would freeze the ladder mid-descent (unconvictable and
            # unrecoverable on a rung it can't earn off).
            floor = self.outlier_min_requests if ep.weight >= 1.0 else 1
            if p95 is not None and ep.stats.window_count >= floor:
                judged.append((ep, p95))
            elif (
                p95 is None
                and ep.weight < 1.0
                and ep.breaker_state == BREAKER_CLOSED
            ):
                # Decayed AND no samples at all this window: its reduced
                # share may itself be why nothing arrived. Absence of
                # traffic is not exoneration — the last verdict stands
                # and the ladder continues below (only when the rest of
                # the fleet provides judging context).
                starved.append(ep)
            ep.stats.reset_window()
        if n < 2 or len(judged) < 2:
            # Insufficient evidence is NOT recovery: existing decisions
            # stand (they age out via the half-open cooldown), we just
            # can't make new ones this window.
            self._fleet_median_p95 = None
            self._publish_scores(now)
            return
        median = fleet_median([p for _, p in judged])
        self._fleet_median_p95 = median
        outlier_ids = {
            id(ep) for ep, p95 in judged if p95 > self.outlier_k * median > 0
        }
        ejected = sum(1 for ep in eps if ep.breaker_state != BREAKER_CLOSED)
        new_outliers = [
            ep for ep, _ in judged
            if id(ep) in outlier_ids and ep.breaker_state == BREAKER_CLOSED
        ] + starved  # starved decayed endpoints stay on their trajectory
        if new_outliers and (ejected + len(new_outliers)) > self.max_eject_fraction * n:
            # Fail open: too much of the fleet looks like an "outlier"
            # — the comparison is meaningless, so scoring stands down
            # completely and routing behaves exactly as without it.
            self._scoring_disabled_reason = (
                f"would eject {ejected + len(new_outliers)}/{n} endpoints "
                f"(max fraction {self.max_eject_fraction:.2f})"
            )
            for ep in eps:
                ep.weight = 1.0
                if ep.breaker_state == BREAKER_SOFT_EJECTED:
                    self._set_state(ep, BREAKER_CLOSED)
                    ep.probe_started = None
                    ep.warmup_started = None
            self._publish_scores(now)
            return
        self._scoring_disabled_reason = None

        def descend(ep: Endpoint, p95_s: float, was_starved: bool) -> None:
            if ep.weight > WEIGHT_FLOOR + 1e-9:
                ep.weight = max(ep.weight * WEIGHT_DECAY, WEIGHT_FLOOR)
                return
            # Still an outlier at the weight floor: soft-eject into the
            # breaker's half-open readmission machinery.
            self._set_state(ep, BREAKER_SOFT_EJECTED)
            ep.opened_at = now
            ep.probe_started = None
            self._note_reopen(ep, now)
            self._soft_ejections += 1
            _M_SOFT_EJECTIONS.inc(labels={"endpoint": ep.address})
            publish_trigger(
                "endpoint_degraded", model=self.name,
                detail={
                    "endpoint": ep.address, "role": ep.role,
                    "p95_s": round(p95_s, 4),
                    "fleet_median_p95_s": round(median, 4),
                    "outlier_k": self.outlier_k,
                    "weight": ep.weight,
                    "starved": was_starved,
                },
            )

        for ep, p95 in judged:
            if ep.breaker_state != BREAKER_CLOSED:
                continue
            if id(ep) in outlier_ids:
                descend(ep, p95, False)
            elif ep.weight < 1.0:
                # Clean window: climb back one rung.
                ep.weight = min(ep.weight / WEIGHT_DECAY, 1.0)
        for ep in starved:
            # No fresh evidence this window: continue the ladder on the
            # rolling p95 (the evidence that decayed it). A wrong
            # continuation is self-correcting — the half-open probe
            # readmits through slow-start once the cooldown elapses.
            descend(ep, ep.stats.p95() or 0.0, True)
        self._publish_scores(now)

    def _publish_scores(self, now: float) -> None:
        """Refresh the kubeai_endpoint_health_score gauge (lock held):
        0.0 for ejected endpoints, otherwise the effective pick weight."""
        for ep in self._endpoints.values():
            if ep.breaker_state in (BREAKER_OPEN, BREAKER_SOFT_EJECTED):
                score = 0.0
            else:
                score = round(self._effective_weight(ep, now), 4)
            _M_HEALTH_SCORE.set(score, labels={"endpoint": ep.address})

    def health_snapshot(self) -> dict:
        """The /debug/health view of this group: scoring config + state
        and per-endpoint latency evidence, weights, and ramp status."""
        with self._lock:
            now = self._clock()
            return {
                "scoring": {
                    "enabled": self.outlier_k > 0,
                    "outlier_k": self.outlier_k,
                    "min_requests": self.outlier_min_requests,
                    "window_s": self.scoring_window,
                    "max_eject_fraction": round(self.max_eject_fraction, 3),
                    "slow_start_s": self.slow_start_window,
                    "fleet_median_p95_s": (
                        round(self._fleet_median_p95, 4)
                        if self._fleet_median_p95 is not None
                        else None
                    ),
                    "disabled_reason": self._scoring_disabled_reason,
                    "soft_ejections": self._soft_ejections,
                },
                "endpoints": [
                    {
                        "name": name,
                        "address": ep.address,
                        "role": ep.role,
                        "state": ep.breaker_state,
                        "weight": round(ep.weight, 3),
                        "effective_weight": round(
                            self._effective_weight(ep, now), 3
                        ),
                        "warming": ep.warmup_started is not None,
                        "p95_s": (
                            round(p95, 4)
                            if (p95 := ep.stats.p95()) is not None
                            else None
                        ),
                        "ewma_s": (
                            round(ep.stats.ewma, 4)
                            if ep.stats.ewma is not None
                            else None
                        ),
                        "samples": len(ep.stats.samples),
                        "window_samples": ep.stats.window_count,
                        "observed_total": ep.stats.total,
                    }
                    for name, ep in sorted(self._endpoints.items())
                ],
            }

    # -- passive health / circuit breaking ---------------------------------

    def _set_state(self, ep: Endpoint, state: str) -> None:
        prev = ep.breaker_state
        ep.breaker_state = state
        _M_ENDPOINT_STATE.set(_STATE_VALUE[state], labels={"endpoint": ep.address})
        if prev == state:
            return
        # Every breaker/health-ladder transition through the one choke
        # point: leaving CLOSED is a WARNING (capacity just shrank, and
        # the ring surfaces it at /debug/logs), re-admission is INFO.
        fn = log.warning if state != BREAKER_CLOSED else log.info
        fn(
            "endpoint breaker %s -> %s", prev, state,
            extra={
                "model": self.name,
                "endpoint": ep.address,
                "role": ep.role,
                "weight": round(ep.weight, 3),
            },
        )

    def _stable_window(self) -> float:
        """How long an endpoint must hold CLOSED after readmission before
        a subsequent ejection counts as fresh bad luck instead of a
        flap continuation (and before the reopen streak resets)."""
        return 2.0 * self.breaker_cooldown

    def _note_reopen(self, ep: Endpoint, now: float) -> None:
        """Bookkeep an open/soft-eject transition for flap escalation
        (lock held). Re-ejection within the stable window of the last
        readmission extends the streak. Anything else leaves the streak
        UNCHANGED — in particular a failed half-open probe, where the
        endpoint spent the whole interval ejected: time spent open
        proves nothing about stability, so it must not forgive a
        flapper mid-quarantine. Forgiveness happens only on the success
        path, after the endpoint HOLDS closed through the stable
        window (see report_result)."""
        if (
            ep.readmitted_at is not None
            and now - ep.readmitted_at < self._stable_window()
        ):
            ep.reopen_streak += 1
            # One strike per readmission cycle: the follow-on probe
            # failures of this same quarantine don't double-count.
            ep.readmitted_at = None

    def _probe_cooldown(self, ep: Endpoint) -> float:
        """Cooldown before *ep* may half-open, with a deterministic
        per-endpoint spread: endpoints ejected in the same burst would
        otherwise all re-probe at the same instant across every model
        (synchronized probe storms against a recovering backend). The
        jitter is a stable hash of the address, so tests with a fake
        clock can predict it and restarts don't reshuffle it.

        A reopen streak (re-ejections shortly after readmission — a
        FLAPPING replica) doubles the cooldown per strike, capped at
        breaker_cooldown_max: without this, a replica flapping faster
        than the base cooldown wins a half-open probe during every
        healthy phase and keeps re-entering the pick rotation."""
        base = self.breaker_cooldown * (
            1.0 + self.probe_jitter * endpoint_jitter(ep.address)
        )
        if ep.reopen_streak > 0:
            # The cap never shrinks the base cooldown (a group tuned to
            # a long base, e.g. the drills' 300s, keeps it).
            cap = max(self.breaker_cooldown_max, base)
            base = min(base * (2.0 ** min(ep.reopen_streak, 16)), cap)
        return base

    def _breaker_allows(self, ep: Endpoint, now: float) -> bool:
        """Whether the breaker lets a NEW request pick *ep* (lock held).
        Lazily transitions open/soft_ejected -> half_open when the
        cooldown elapses — there is no timer thread; selection time is
        when it matters."""
        if ep.breaker_state == BREAKER_CLOSED:
            return True
        if ep.breaker_state in (BREAKER_OPEN, BREAKER_SOFT_EJECTED):
            if now - ep.opened_at < self._probe_cooldown(ep):
                return False
            self._set_state(ep, BREAKER_HALF_OPEN)
            ep.probe_started = None
        # Half-open: one probe at a time. A probe whose outcome never got
        # reported (caller died) stops blocking after a cooldown.
        return (
            ep.probe_started is None
            or now - ep.probe_started >= self.breaker_cooldown
        )

    def report_result(self, addr: str, ok: bool, started_at: float | None = None) -> None:
        """Feed one request-attempt outcome for *addr* (the proxy calls
        this per attempt — connect errors and 5xx are failures). Drives
        closed -> open (threshold consecutive failures), half_open ->
        closed (probe success) and half_open -> open (probe failure).

        *started_at* (same clock as the group's) marks when the attempt
        began: a SUCCESS from an attempt that started before the breaker
        last opened is stale evidence — e.g. a long stream that connected
        minutes ago exhausting cleanly after the endpoint started failing
        — and must not close a fresh ejection. Failures always count."""
        with self._cond:
            ep = next(
                (e for e in self._endpoints.values() if e.address == addr), None
            )
            if ep is None:
                return
            now = self._clock()
            if ok:
                if ep.breaker_state == BREAKER_SOFT_EJECTED:
                    # Soft ejection means SLOW, not failing: batch-tier
                    # successes prove liveness, not recovered latency.
                    # Only the half-open probe (after the cooldown, with
                    # a fresh scoring verdict to follow) readmits.
                    ep.consecutive_failures = 0
                    return
                if (
                    ep.breaker_state != BREAKER_CLOSED
                    and started_at is not None
                    and started_at < ep.opened_at
                ):
                    return  # pre-ejection evidence; ignore entirely
                ep.consecutive_failures = 0
                if ep.breaker_state != BREAKER_CLOSED:
                    self._set_state(ep, BREAKER_CLOSED)
                    ep.probe_started = None
                    # Stamp the readmission: a re-ejection inside the
                    # stable window marks this endpoint as flapping and
                    # escalates its next cooldown (_note_reopen).
                    ep.readmitted_at = now
                    # Readmission gets a slow-start ramp, not an
                    # instant full share — a cold/recovering replica
                    # at full LeastLoad weight can re-trip itself.
                    self._start_warmup(ep, now)
                elif (
                    ep.readmitted_at is not None
                    and now - ep.readmitted_at >= self._stable_window()
                ):
                    # Held CLOSED through the stable window: forgiven.
                    ep.readmitted_at = None
                    ep.reopen_streak = 0
                return
            ep.consecutive_failures += 1
            if (
                ep.breaker_state == BREAKER_SOFT_EJECTED
                and self.breaker_threshold > 0
                and ep.consecutive_failures >= self.breaker_threshold
            ):
                # A latency outlier that starts HARD-failing under its
                # batch tier escalates to a full ejection (no traffic).
                self._set_state(ep, BREAKER_OPEN)
                ep.opened_at = now
                ep.probe_started = None
                self._note_reopen(ep, now)
                _M_EJECTIONS.inc(labels={"endpoint": ep.address})
                publish_trigger(
                    "breaker_ejection", model=self.name,
                    detail={
                        "endpoint": ep.address, "role": ep.role,
                        "transition": "soft_ejected->open",
                        "consecutive_failures": ep.consecutive_failures,
                    },
                )
            elif ep.breaker_state == BREAKER_HALF_OPEN:
                # The probe failed: straight back to ejected, with the
                # flap streak noted — repeated probe failures right
                # after readmissions are the oscillation signature.
                self._set_state(ep, BREAKER_OPEN)
                ep.opened_at = now
                ep.probe_started = None
                self._note_reopen(ep, now)
                _M_EJECTIONS.inc(labels={"endpoint": ep.address})
                # Incident trigger (enqueue-only — safe under _cond): a
                # failed half-open probe means the endpoint is STILL
                # dead after a full cooldown.
                publish_trigger(
                    "breaker_ejection", model=self.name,
                    detail={
                        "endpoint": ep.address, "role": ep.role,
                        "transition": "half_open->open",
                        "consecutive_failures": ep.consecutive_failures,
                    },
                )
            elif (
                ep.breaker_state == BREAKER_CLOSED
                and self.breaker_threshold > 0
                and ep.consecutive_failures >= self.breaker_threshold
            ):
                self._set_state(ep, BREAKER_OPEN)
                ep.opened_at = now
                self._note_reopen(ep, now)
                _M_EJECTIONS.inc(labels={"endpoint": ep.address})
                publish_trigger(
                    "breaker_ejection", model=self.name,
                    detail={
                        "endpoint": ep.address, "role": ep.role,
                        "transition": "closed->open",
                        "consecutive_failures": ep.consecutive_failures,
                    },
                )

    def breaker_snapshot(self) -> list[dict]:
        """Per-endpoint breaker view for the /debug/endpoints surface."""
        with self._lock:
            now = self._clock()
            return [
                {
                    "name": name,
                    "address": ep.address,
                    # Phase role so an ejected prefill replica is
                    # attributable to its pool in every debug surface.
                    "role": ep.role,
                    "state": ep.breaker_state,
                    "consecutive_failures": ep.consecutive_failures,
                    "in_flight": ep.in_flight,
                    "opened_age_s": (
                        round(now - ep.opened_at, 3)
                        if ep.breaker_state != BREAKER_CLOSED
                        else None
                    ),
                    "weight": round(ep.weight, 3),
                    "warming": ep.warmup_started is not None,
                    # Flap evidence: >0 means this endpoint re-ejected
                    # within the stable window of a readmission and its
                    # probe cooldown is escalated accordingly.
                    "reopen_streak": ep.reopen_streak,
                }
                for name, ep in sorted(self._endpoints.items())
            ]

    # -- routing observability ---------------------------------------------

    def routing_snapshot(self) -> dict:
        """The /debug/routing view of this group: the CHWBL ring's
        per-endpoint virtual-node counts, live in-flight load vs the
        group mean (the bounded-load check's inputs), and the recent
        pick distribution — PrefixHash-vs-LeastLoad behavior inspectable
        at runtime instead of only in benchmarks."""
        with self._lock:
            now = self._clock()
            vnodes = self._ring.vnode_counts()
            n = len(self._endpoints)
            mean = self._total_in_flight / n if n else 0.0
            picks = list(self._picks)
            pick_counts: dict[str, int] = {}
            strategies: dict[str, int] = {}
            for _, name, strategy in picks:
                pick_counts[name] = pick_counts.get(name, 0) + 1
                strategies[strategy] = strategies.get(strategy, 0) + 1
            return {
                "ring_slots": len(self._ring),
                "replication": self._ring.replication,
                "total_in_flight": self._total_in_flight,
                "mean_in_flight": round(mean, 3),
                "endpoints": [
                    {
                        "name": name,
                        "address": ep.address,
                        "role": ep.role,
                        "in_flight": ep.in_flight,
                        "vnodes": vnodes.get(name, 0),
                        # >1.0 = this endpoint is above the group mean —
                        # the CHWBL bound (mean_load_factor, default
                        # 1.25) walks past it.
                        "load_factor": (
                            round(ep.in_flight / mean, 3) if mean > 0 else 0.0
                        ),
                        "breaker_state": ep.breaker_state,
                        "recent_picks": pick_counts.get(name, 0),
                    }
                    for name, ep in sorted(self._endpoints.items())
                ],
                "recent_picks": {
                    "window_seconds": (
                        round(now - picks[0][0], 3) if picks else 0.0
                    ),
                    "total": len(picks),
                    "by_strategy": strategies,
                },
            }

    # -- membership --------------------------------------------------------

    def reconcile_endpoints(self, observed: dict[str, Endpoint]) -> None:
        """Converge group membership to *observed* (name -> Endpoint).
        In-flight counts on surviving endpoints are preserved; counts on
        removed endpoints drain naturally via their done callbacks
        (ref: group.go:108-137)."""
        with self._cond:
            # One timestamp for the whole pass: endpoints arriving in
            # the same reconcile must ramp IDENTICALLY, so LeastLoad
            # tie-breaking among them stays random during warmup.
            now = self._clock()
            for name, obs in observed.items():
                cur = self._endpoints.get(name)
                if cur is not None:
                    cur.adapters = set(obs.adapters)
                    cur.role = obs.role
                else:
                    ep = Endpoint(
                        address=obs.address, adapters=set(obs.adapters),
                        role=obs.role,
                    )
                    # Every arrival — fresh pod, parked attach, scale-up
                    # — gets the slow-start ramp: a just-attached replica
                    # with cold caches must not receive full LeastLoad
                    # share instantly.
                    self._start_warmup(ep, now)
                    self._endpoints[name] = ep
                    self._ring.add(name)
            for name in list(self._endpoints):
                if name not in observed:
                    self._ring.remove(name)
                    ep = self._endpoints.pop(name)
                    # A departed endpoint must not show "open" on the
                    # state gauge (or a stale health score) forever.
                    _M_ENDPOINT_STATE.set(
                        _STATE_VALUE[BREAKER_CLOSED],
                        labels={"endpoint": ep.address},
                    )
                    _M_HEALTH_SCORE.set(1.0, labels={"endpoint": ep.address})
            if observed:
                self._generation += 1
                self._cond.notify_all()

    def get_all_addrs(self) -> list[str]:
        with self._lock:
            return [ep.address for ep in self._endpoints.values()]

    def endpoint_roles(self) -> dict[str, str]:
        """address -> phase role ("" for unified pods) — the fleet
        collector's role dimension for /debug/fleet and the per-pool
        autoscaling signals."""
        with self._lock:
            return {ep.address: ep.role for ep in self._endpoints.values()}

    def total_in_flight(self) -> int:
        with self._lock:
            return self._total_in_flight

    def endpoint_loads(self) -> dict[str, int]:
        with self._lock:
            return {name: ep.in_flight for name, ep in self._endpoints.items()}
