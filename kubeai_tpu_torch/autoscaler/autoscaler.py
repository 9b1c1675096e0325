"""Moving-average autoscaler (port of kubeai_tpu/autoscaler/autoscaler.py).

A leader-gated ticker sums ``kubeai_inference_requests_active`` per model
over every operator replica's ``/metrics`` (this process's registry when
there are no peers), takes the max with the engines' own queued + active
work from the fleet scrape, feeds per-model fixed-window moving averages
and scales to ceil(avg / targetRequests). A disaggregated Model gets one
decision per phase-role pool (disagg/signals.py). Averages persist to an
``AutoscalerState`` record so a restarted operator resumes them. Every
decision goes to the ``DecisionLog`` (``GET /debug/autoscaler``).
"""

from __future__ import annotations

import math
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field

from kubeai_tpu_torch.autoscaler.movingaverage import SimpleMovingAverage
from kubeai_tpu_torch.metrics import ACTIVE_REQUESTS, default_registry, parse_prometheus_text
from kubeai_tpu_torch.obs.incidents import publish_trigger
from kubeai_tpu_torch.obs.logs import get_logger
from kubeai_tpu_torch.runtime.store import AlreadyExists, NotFound, ObjectMeta, Store

log = get_logger("kubeai_tpu_torch.autoscaler")

KIND_STATE = "AutoscalerState"
ENGINE_QUEUE_METRIC = "kubeai_engine_queue_depth"

# Capacity-observability surface: every tick's decision math is recorded
# (DecisionLog -> GET /debug/autoscaler) AND exported as metrics, so
# "why did the autoscaler do that" is answerable after the fact.
M_DESIRED = default_registry.gauge(
    "kubeai_autoscaler_desired_replicas",
    "replicas the last tick computed per model (ceil(window avg / target), pre-clamp)",
)
M_SIGNAL = default_registry.gauge(
    "kubeai_autoscaler_signal",
    "raw autoscaling signal per model by source (proxy = summed active gauge, "
    "engine = fleet queue+active scrape, combined = max of both)",
)
M_SCRAPE_FAILURES = default_registry.counter(
    "kubeai_autoscaler_scrape_failures_total",
    "failed telemetry scrapes by scope (peer = operator replica, engine = engine pod)",
)
M_TICK = default_registry.histogram(
    "kubeai_autoscaler_tick_seconds",
    "wall time of one autoscaler tick (scrapes + decisions + state save)",
)


class DecisionLog:
    """Bounded ring of per-model scaling decision records, served at
    GET /debug/autoscaler on the operator."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._records: deque[dict] = deque(maxlen=capacity)

    def append(self, record: dict) -> None:
        with self._lock:
            self._records.append(record)

    def snapshot(self, limit: int | None = None, model: str | None = None) -> list[dict]:
        """Most-recent-first records, optionally filtered by model.
        None/zero/negative *limit* means unbounded (the ring cap is the
        real bound) — a negative must not slice from the tail."""
        with self._lock:
            out = list(self._records)
        out.reverse()
        if model:
            out = [r for r in out if r.get("model") == model]
        return out[:limit] if limit is not None and limit > 0 else out


@dataclass
class AutoscalerState:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    # model -> average at last save (ref: state.go modelAverages)
    averages: dict[str, float] = field(default_factory=dict)


def _fetch_metrics_text(addr: str, timeout: float) -> str:
    url = addr if addr.startswith("http") else f"http://{addr}/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def scrape_metrics(addr: str, timeout: float = 3.0) -> dict[str, float]:
    """GET metrics from one peer; returns model -> active count
    (ref: metrics.go:36-71)."""
    return parse_scraped_text(_fetch_metrics_text(addr, timeout))


ENGINE_ACTIVE_METRIC = "kubeai_engine_active_slots"


def scrape_engine_load(addr: str, timeout: float = 3.0) -> float:
    """GET an ENGINE pod's /metrics and return queued + active work as the
    engine itself sees it."""
    parsed = parse_prometheus_text(_fetch_metrics_text(addr, timeout))
    return sum(v for _, v in parsed.get(ENGINE_QUEUE_METRIC, [])) + sum(
        v for _, v in parsed.get(ENGINE_ACTIVE_METRIC, [])
    )


def engine_queue_scraper(lb, timeout: float = 2.0, max_workers: int = 8):
    """Build the autoscaler's engine-load callback over the load balancer's
    endpoint view. Pods are scraped concurrently so dead endpoints cost one
    timeout per tick, not one per pod; unreachable pods contribute zero.
    Uses the process-wide long-lived scrape executor (building a fresh
    ThreadPoolExecutor per model per tick paid thread spawn/teardown on
    every scaling decision). Prefer wiring a FleetCollector (fleet.py),
    which shares one scrape per endpoint with the /debug/fleet plane."""
    from kubeai_tpu_torch.autoscaler.fleet import shared_scrape_executor

    def scrape(model_name: str) -> float:
        addrs = lb.get_all_addresses(model_name)
        if not addrs:
            return 0.0

        def one(addr):
            try:
                return scrape_engine_load(addr, timeout=timeout)
            except Exception:
                M_SCRAPE_FAILURES.inc(labels={"scope": "engine"})
                return 0.0

        return float(sum(shared_scrape_executor(max_workers).map(one, addrs)))

    return scrape


def parse_scraped_text(text: str) -> dict[str, float]:
    parsed = parse_prometheus_text(text)
    out: dict[str, float] = {}
    for labels, value in parsed.get(ACTIVE_REQUESTS, []):
        model = labels.get("request_model", "")
        if model:
            out[model] = out.get(model, 0.0) + value
    return out


class Autoscaler:
    def __init__(
        self,
        store: Store,
        model_client,
        load_balancer,
        election,
        interval_seconds: float = 10.0,
        average_window_count: int = 60,
        fixed_self_metric_addrs: list[str] | None = None,
        state_name: str = "kubeai-autoscaler-state",
        namespace: str = "default",
        engine_queue_scrape=None,
        fleet=None,
        decision_capacity: int = 512,
        clock=time.time,
        forecaster=None,
        parked_pool=None,
    ):
        self.store = store
        self.model_client = model_client
        self.lb = load_balancer
        self.election = election
        self.interval = interval_seconds
        self.window = average_window_count
        self.fixed_addrs = fixed_self_metric_addrs or []
        self.state_name = state_name
        self.namespace = namespace
        # Engine-load signal: a FleetCollector (one scrape per endpoint
        # per tick, shared with /debug/fleet) or the legacy per-model
        # scrape closure. When only the collector is given, expose its
        # scrape through the legacy attribute too so existing callers
        # keep working.
        self.fleet = fleet
        if engine_queue_scrape is None and fleet is not None:
            engine_queue_scrape = fleet.scrape_model
        self.engine_queue_scrape = engine_queue_scrape
        # Predictive signal (obs/forecast.py): when wired, the unified
        # tick fuses desired = max(reactive, forecast-at-lead-time). The
        # forecast may only RAISE the reactive floor; the parked pool is
        # asked to pre-warm ahead of predicted ramps.
        self.forecaster = forecaster
        self.parked_pool = parked_pool
        # Per-tick decision audit (GET /debug/autoscaler); *clock* is the
        # wall-clock source for record timestamps, injectable in tests.
        self.decisions = DecisionLog(decision_capacity)
        self._clock = clock
        self._averages: dict[str, SimpleMovingAverage] = {}
        # Consecutive no_pool_telemetry ticks per model#role: the
        # incident trigger fires only on a CONFIRMED hold (2nd tick in
        # a row) so a one-tick scrape blip or a pool that is still
        # starting up doesn't churn the incident ring.
        self._hold_streak: dict[str, int] = {}
        # Set by stop(): the loop waits on it between ticks, so a stop
        # returns at once instead of after the rest of an interval.
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._load_state()

    # -- persistence (ref: state.go) ---------------------------------------

    def _load_state(self):
        try:
            state = self.store.get(KIND_STATE, self.state_name, self.namespace)
            for model, avg in state.averages.items():
                self._averages[model] = SimpleMovingAverage([avg] * self.window)
            log.info("preloaded autoscaler state for %d models", len(state.averages))
        except NotFound:
            pass

    def _save_state(self):
        averages = {m: a.calculate() for m, a in self._averages.items()}
        try:
            state = self.store.get(KIND_STATE, self.state_name, self.namespace)
            state.averages = averages
            self.store.update(KIND_STATE, state, check_version=False)
        except NotFound:
            try:
                self.store.create(
                    KIND_STATE,
                    AutoscalerState(
                        meta=ObjectMeta(name=self.state_name, namespace=self.namespace),
                        averages=averages,
                    ),
                )
            except AlreadyExists:
                pass

    # -- loop --------------------------------------------------------------

    def start(self):
        self._stopped.clear()
        self._thread = threading.Thread(target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        while not self._stopped.wait(self.interval):
            if not self.election.is_leader.is_set():
                continue  # leader-gated (ref: autoscaler.go:96-99)
            try:
                self.tick()
            except Exception:
                log.exception("autoscaler tick failed")

    def tick(self):
        t0 = time.monotonic()
        models = self.model_client.list_all_models()
        actives, peer_failures = self._aggregate_metrics_detailed()
        enabled = [m for m in models if not m.spec.autoscaling_disabled]
        # Streaks for models no longer in the store must not survive:
        # a model deleted mid-hold and later RECREATED would otherwise
        # inherit the dead deployment's streak and fire autoscaler_hold
        # on its first (normal, still-starting) blind tick, defeating
        # the two-consecutive-tick confirmation.
        live = {m.meta.name for m in models}
        for k in [k for k in self._hold_streak if k.split("#", 1)[0] not in live]:
            del self._hold_streak[k]
        fleet_view = None
        if self.fleet is not None:
            # ONE scrape per endpoint for the whole tick; the same
            # snapshot backs /debug/fleet until the next tick. ALL
            # models (autoscaling-disabled included): the fleet view is
            # observability, and a partial cache would force the debug
            # plane to re-scrape on every GET.
            fleet_view = self.fleet.collect([m.meta.name for m in models])
        for model in enabled:
            name = model.meta.name
            dz = getattr(model.spec, "disaggregation", None)
            if dz is not None and dz.enabled and self._has_role_endpoints(name):
                # Disaggregated: one decision per phase-role pool, each
                # on its own signal (prefill queue-wait vs decode
                # occupancy) — the whole point of the split.
                self._tick_disagg(model, fleet_view, peer_failures)
                continue
            # Unified path — including disagg-SPECCED models whose pods
            # carry no role labels (the controller ignores the mode on
            # multi-host gangs, or a mode flip hasn't rolled yet): they
            # must keep scaling on spec.replicas, not sit unmanaged
            # while per-pool ticks hold on no_pool_telemetry forever.
            self._clear_pool_series(name)
            avg = self._averages.get(name)
            if avg is None:
                avg = SimpleMovingAverage([0.0] * self.window)
                self._averages[name] = avg
            # Proxied requests are counted by the active gauge for their
            # whole lifetime INCLUDING time queued inside engines, so
            # engine-side load is a subset of it, not an addition — adding
            # would double-count saturation. max() covers the case the
            # gauge can't see: traffic reaching engines without passing
            # any operator replica.
            proxy_signal = actives.get(name, 0.0)
            engine_signal = None
            engine_failures: list[str] = []
            if fleet_view is not None:
                view = fleet_view.get(name)
                if view is not None:
                    engine_signal = view["aggregate"]["load"]
                    engine_failures = [
                        e["address"] for e in view["endpoints"] if not e["ok"]
                    ]
            elif self.engine_queue_scrape is not None:
                engine_signal = self.engine_queue_scrape(name)
            signal = (
                max(proxy_signal, engine_signal)
                if engine_signal is not None
                else proxy_signal
            )
            avg.next(signal)
            mean = avg.calculate()
            target = max(model.spec.target_requests, 1)
            reactive_desired = math.ceil(mean / target)
            desired, source, forecast_detail = self._fuse_forecast(
                name, reactive_desired, target, signal
            )
            outcome = self.model_client.scale(name, desired)
            if not isinstance(outcome, dict):
                # A subclassed/stubbed client that doesn't return the
                # decision detail still gets an audit record.
                outcome = {}
            record = {
                "t": self._clock(),
                "model": name,
                "signal": {
                    "proxy": round(proxy_signal, 3),
                    "engine": (
                        round(engine_signal, 3) if engine_signal is not None else None
                    ),
                    "combined": round(signal, 3),
                },
                "window_avg": round(mean, 3),
                "target_requests": target,
                "desired": desired,
                "reactive_desired": reactive_desired,
                "source": source,
                "forecast": forecast_detail,
                "clamped": outcome.get("clamped"),
                "current": outcome.get("current"),
                "applied": outcome.get("applied"),
                "applied_replicas": outcome.get("replicas"),
                "reason": outcome.get("reason"),
                "consecutive_scale_downs": outcome.get("consecutive_scale_downs"),
                "required_consecutive": outcome.get("required_consecutive"),
                "scrape_failures": {
                    "peers": peer_failures,
                    "engines": engine_failures,
                },
            }
            self.decisions.append(record)
            # One structured line per APPLIED scale change — steady-state
            # no-op ticks stay out of the logs (the decision ring has them).
            if outcome.get("applied"):
                log.info(
                    "scale decision applied",
                    extra={
                        "model": name,
                        "desired": desired,
                        "applied_replicas": outcome.get("replicas"),
                        "window_avg": round(mean, 3),
                        "reason": outcome.get("reason"),
                    },
                )
            # Incident trigger: desired exceeded the clamp — the model
            # WANTS more capacity than maxReplicas allows. A min-clamp
            # (desired < clamped) is idle normality, not an incident.
            clamped = outcome.get("clamped")
            if clamped is not None and clamped < desired:
                publish_trigger(
                    "autoscaler_clamp", model=name,
                    detail={
                        "desired": desired, "clamped": clamped,
                        "window_avg": round(mean, 3),
                    },
                )
            labels = {"model": name}
            M_DESIRED.set(desired, labels=labels)
            M_SIGNAL.set(proxy_signal, labels={**labels, "source": "proxy"})
            if engine_signal is not None:
                M_SIGNAL.set(engine_signal, labels={**labels, "source": "engine"})
            M_SIGNAL.set(signal, labels={**labels, "source": "combined"})
        self._save_state()
        M_TICK.observe(time.monotonic() - t0)

    def _fuse_forecast(self, name: str, reactive_desired: int, target: int, signal: float):
        """Fuse the predictive signal: desired = max(reactive,
        forecast-at-lead-time). Returns (desired, source, detail) where
        source says which signal won. Guardrails live here: the
        forecast may only RAISE the reactive floor (a low forecast
        never scales below what live traffic demands), and a model
        whose forecast is auto-disabled (MAPE breach) contributes
        nothing but the audit detail saying why."""
        fc = self.forecaster
        if fc is None:
            return reactive_desired, "reactive", None
        try:
            fa = fc.signal_at_lead(name)
        except Exception:
            log.exception("forecast signal failed for %s", name)
            return reactive_desired, "reactive", None
        if fa is None:
            return reactive_desired, "reactive", None
        detail = {
            "lead_seconds": fa.get("lead_seconds"),
            "mape": fa.get("mape"),
            "disabled": bool(fa.get("disabled")),
            "actual_signal": round(signal, 3),
        }
        if fa.get("disabled"):
            detail["disabled_reason"] = fa.get("disabled_reason")
            return reactive_desired, "reactive", detail
        rate = fa.get("rate")
        if rate is None:
            return reactive_desired, "reactive", detail
        forecast_desired = math.ceil(rate / target)
        detail.update({
            "rate": round(rate, 3),
            "lower": round(fa.get("lower", 0.0), 3),
            "upper": round(fa.get("upper", 0.0), 3),
            "desired": forecast_desired,
        })
        if forecast_desired <= reactive_desired:
            return reactive_desired, "reactive", detail
        # The ramp is coming before a cold replica could: pre-warm
        # parked capacity now so scale-up becomes an attach, not a boot.
        pool = self.parked_pool
        if pool is not None:
            try:
                pool.request_prewarm(
                    forecast_desired - reactive_desired,
                    model=name,
                    ttl_seconds=fa.get("lead_seconds", 60.0) + 2 * self.interval,
                    detail={
                        "forecast_rate": round(rate, 3),
                        "reactive_desired": reactive_desired,
                        "forecast_desired": forecast_desired,
                    },
                )
            except Exception:
                log.exception("parked pre-warm request failed for %s", name)
        return forecast_desired, "forecast", detail

    def _has_role_endpoints(self, name: str) -> bool:
        """Whether the model's serving pods are actually role-planned:
        at least one endpoint carries a phase-role label. The spec can
        ASK for disaggregation while the controller serves unified
        (multi-host gangs; a mode flip mid-rollout) — the endpoint
        labels are the ground truth of what is deployed. A model with
        no endpoints at all reads unified too: disagg pools are floored
        at 1, so a genuinely disaggregated model is only transiently
        endpoint-less, and the unified tick's spec.replicas mutation is
        a no-op for the role planner."""
        roles_fn = getattr(self.lb, "get_endpoint_roles", None)
        if not callable(roles_fn):
            return False
        try:
            return any(roles_fn(name).values())
        except Exception:
            return False

    def _clear_pool_series(self, name: str) -> None:
        """Drop per-pool gauge series for a model served unified this
        tick — a model flipped back from disaggregated must not export
        its final pre-flip pool saturation forever. The hold streaks go
        with them: a pool that no longer exists isn't "still blind", and
        a later flip back to disagg must re-confirm from zero."""
        for role in ("prefill", "decode"):
            labels = {"model": name, "pool": role}
            M_DESIRED.remove(labels=labels)
            self._hold_streak.pop(f"{name}#{role}", None)
            for source in ("prefill_queue_wait", "decode_occupancy"):
                M_SIGNAL.remove(labels={**labels, "source": source})

    def _tick_disagg(self, model, fleet_view, peer_failures: list[str]) -> None:
        """Per-pool decisions for a disaggregated model: prefill scales
        on queue-wait pressure, decode on slot/KV-page occupancy
        (disagg/signals.py), each through its own moving-
        average window (state key ``model#role``) and its own
        consecutive-scale-down gate. Emits one DecisionLog record per
        pool per tick with the phase signal breakdown — the audit
        answers "why did THIS pool scale" independently. A pool with no
        reachable telemetry this tick holds (recorded, not guessed)."""
        from kubeai_tpu_torch.disagg import ROLE_DECODE, ROLE_PREFILL, pool_replicas
        from kubeai_tpu_torch.disagg import signals as dsig

        name = model.meta.name
        dz = model.spec.disaggregation
        # The mirror of _clear_pool_series: a model that just flipped
        # unified → disaggregated must not keep exporting its final
        # pre-flip model-level desired/signal values forever.
        M_DESIRED.remove(labels={"model": name})
        for source in ("proxy", "engine", "combined"):
            M_SIGNAL.remove(labels={"model": name, "source": source})
        view = fleet_view.get(name) if fleet_view is not None else None
        pools = (view or {}).get("pools") or {}
        for role in (ROLE_PREFILL, ROLE_DECODE):
            key = f"{name}#{role}"
            avg = self._averages.get(key)
            if avg is None:
                avg = SimpleMovingAverage([0.0] * self.window)
                self._averages[key] = avg
            engine_failures = [
                e["address"]
                for e in (view or {}).get("endpoints", [])
                if e.get("role") == role and not e.get("ok", True)
            ]
            record = {
                "t": self._clock(),
                "model": name,
                "pool": role,
                "scrape_failures": {
                    "peers": peer_failures,
                    "engines": engine_failures,
                },
            }
            agg = pools.get(role)
            if agg is None or not agg.get("endpoints"):
                # No reachable pool telemetry: holding is a decision
                # too — record it so a silent pool is visible in the
                # audit instead of reading as "never considered".
                record.update(
                    {
                        "signal": None,
                        "window_avg": None,
                        "desired": None,
                        "applied": False,
                        "reason": "no_pool_telemetry",
                        "current": pool_replicas(dz, role),
                    }
                )
                self.decisions.append(record)
                # A silent pool is an incident in waiting: the
                # autoscaler is flying blind on this phase role. Fire
                # only once CONFIRMED (two consecutive blind ticks — a
                # single scrape blip is not evidence). The current>0
                # guard is defensive only: validation floors pools at 1
                # today, but a legitimately zero-replica pool (future
                # scale-to-zero) must not page anyone.
                # >= (not ==): while the pool stays blind, every tick
                # keeps publishing and the recorder's debounce folds the
                # repeats into suppressed_repeats — an hour-long hold
                # must not leave the same footprint as a 2-tick one.
                streak = self._hold_streak.get(key, 0) + 1
                self._hold_streak[key] = streak
                if streak >= 2 and record["current"] > 0:
                    publish_trigger(
                        "autoscaler_hold", model=name,
                        detail={"pool": role, "reason": "no_pool_telemetry"},
                        key=key,
                    )
                continue
            self._hold_streak.pop(key, None)  # telemetry is back
            if role == ROLE_PREFILL:
                sig = dsig.prefill_signal(agg)
                target = max(dz.prefill_target_queue, 1)
                avg.next(sig["combined"])
                mean = avg.calculate()
                desired = dsig.desired_prefill(mean, dz)
                source = "prefill_queue_wait"
            else:
                sig = dsig.decode_signal(agg)
                target = max(min(dz.decode_target_occupancy_pct, 100), 1)
                avg.next(sig["combined"])
                mean = avg.calculate()
                # Proportional control scales the pool size the
                # occupancy was MEASURED over — the reachable endpoints
                # — not the spec size: with 2 of 4 replicas alive at
                # 95%, desired is ceil(2*95/80), not ceil(4*95/80).
                live = int(agg.get("endpoints", 0)) or pool_replicas(dz, role)
                desired = dsig.desired_decode(mean, live, dz)
                source = "decode_occupancy"
            # Stubbed/subclassed clients without the per-pool entry
            # point still get an audit record.
            scale_fn = getattr(self.model_client, "scale_pool", None)
            outcome = scale_fn(name, role, desired) if callable(scale_fn) else {}
            if not isinstance(outcome, dict):
                outcome = {}
            record.update(
                {
                    "signal": {**sig, "source": source},
                    "window_avg": round(mean, 3),
                    "target": target,
                    "desired": desired,
                    "clamped": outcome.get("clamped"),
                    "current": outcome.get("current"),
                    "applied": outcome.get("applied"),
                    "applied_replicas": outcome.get("replicas"),
                    "reason": outcome.get("reason"),
                    "consecutive_scale_downs": outcome.get("consecutive_scale_downs"),
                    "required_consecutive": outcome.get("required_consecutive"),
                }
            )
            self.decisions.append(record)
            clamped = outcome.get("clamped")
            if clamped is not None and clamped < desired:
                publish_trigger(
                    "autoscaler_clamp", model=name,
                    detail={
                        "pool": role, "desired": desired, "clamped": clamped,
                        "window_avg": round(mean, 3),
                    },
                    key=f"{name}#{role}",
                )
            labels = {"model": name, "pool": role}
            M_DESIRED.set(desired, labels=labels)
            M_SIGNAL.set(sig["combined"], labels={**labels, "source": source})

    def aggregate_metrics(self) -> dict[str, float]:
        """Sum active requests across every operator replica
        (ref: aggregateAllMetrics, metrics.go:15-34)."""
        return self._aggregate_metrics_detailed()[0]

    def _aggregate_metrics_detailed(self) -> tuple[dict[str, float], list[str]]:
        """Peer-scrape totals PLUS the addresses that failed this tick —
        the per-peer failure attribution the decision audit records."""
        addrs = self.fixed_addrs or self.lb.get_self_ips()
        totals: dict[str, float] = {}
        failures: list[str] = []
        if not addrs:
            # Single-process mode: read our own registry directly.
            return parse_scraped_text(default_registry.render()), failures
        for addr in addrs:
            try:
                for model, v in scrape_metrics(addr).items():
                    totals[model] = totals.get(model, 0.0) + v
            except Exception as e:
                log.warning("scrape %s failed: %s", addr, e)
                failures.append(addr)
                M_SCRAPE_FAILURES.inc(labels={"scope": "peer"})
        return totals, failures
