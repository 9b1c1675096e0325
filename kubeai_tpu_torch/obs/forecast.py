"""Forecasts over the operator's history store (port of
kubeai_tpu/obs/forecast.py): a seasonal-naive fit with an EWMA-like level
and trend turns each Model's request-rate and token-rate series into a
curve with a prediction interval, and scores every forecast against what
came.

- ``GET /debug/forecast[?model=&points=]``: each Model's curve, interval,
  accuracy and anomaly state (404 where no forecaster is installed).
- ``kubeai_forecast_{rate,upper,lower,anomaly_score,mape}`` gauges
  (labels ``model``, ``signal``) and ``kubeai_forecast_auto_disabled``: a
  Model whose rolling MAPE passes ``KUBEAI_FORECAST_MAPE_DISABLE`` (0.6)
  over ``KUBEAI_FORECAST_MIN_SCORED`` forecasts is disabled until it
  falls below three quarters of it.
- ``traffic_anomaly`` incidents after ``KUBEAI_FORECAST_ANOMALY_TICKS``
  ticks outside the interval.
- The autoscaler: ``Forecaster.signal_at_lead`` is the in-flight
  requests forecast one lead ahead, fused as ``max(reactive, forecast)``.

The lead is how long a new replica takes to serve: ``KUBEAI_FORECAST_LEAD``,
else a live ``ColdStartTimeline``'s ready seconds, else a cold-start
profile (JSON with ``parked_attach_s`` / ``fast_warm_s`` / ``serial_s`` /
``phases.ready_s``) only when one is named (``profile_path`` or
``KUBEAI_COLD_START_PROFILE``), else 60 s. Unlike the JAX forecaster it
never reads ``BENCH_cold_start.json`` from the working directory: that
file measures the JAX engine, not this one.

Buckets under a gap (restart, leadership change, sampler stall) are left
out of the fit and the scoring, and widen the interval. Only the lease
holder ticks.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from urllib.parse import parse_qs

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.obs.incidents import publish_trigger

log = logging.getLogger("kubeai_tpu_torch.forecast")

# Request-rate signal: the SAME gauge the autoscaler's proxy signal
# sums, so forecast and reactive signal share units (in-flight
# requests) and ceil(forecast / target) is directly comparable.
REQUEST_SERIES_PREFIX = "kubeai_inference_requests_active{"
TOKEN_SERIES_SUFFIX = ".tokens_per_second"

SIGNALS = ("requests", "tokens")

M_RATE = default_registry.gauge(
    "kubeai_forecast_rate",
    "forecast traffic at lead time per model/signal (requests = in-flight, tokens = tok/s)",
)
M_UPPER = default_registry.gauge(
    "kubeai_forecast_upper",
    "upper prediction-interval bound at lead time per model/signal",
)
M_LOWER = default_registry.gauge(
    "kubeai_forecast_lower",
    "lower prediction-interval bound at lead time per model/signal",
)
M_ANOMALY = default_registry.gauge(
    "kubeai_forecast_anomaly_score",
    "distance of observed traffic beyond the prediction interval in sigma units (0 = inside)",
)
M_MAPE = default_registry.gauge(
    "kubeai_forecast_mape",
    "rolling mean absolute percentage error of matured forecasts per model/signal",
)
M_DISABLED = default_registry.gauge(
    "kubeai_forecast_auto_disabled",
    "1 while a model's forecast is auto-disabled for MAPE breach (guardrail engaged)",
)


def derive_lead_seconds(profile_path: str | None = None, timeline=None,
                        default: float = 60.0) -> float:
    """How far ahead the forecast looks: ``KUBEAI_FORECAST_LEAD``, a live
    ColdStartTimeline's ready seconds, the named cold-start profile
    (*profile_path*, else ``KUBEAI_COLD_START_PROFILE`` when set: parked
    attach when measured, else the warmed start, else the serial one),
    else *default*."""
    env = os.environ.get("KUBEAI_FORECAST_LEAD", "")
    if env:
        try:
            return max(float(env), 1.0)
        except ValueError:
            pass
    if timeline is not None:
        try:
            ready = float(timeline.snapshot().get("ready_s") or 0.0)
            if ready > 0:
                return ready
        except Exception:
            pass
    path = profile_path or os.environ.get("KUBEAI_COLD_START_PROFILE", "")
    if not path:
        return default
    try:
        with open(path, encoding="utf-8") as f:
            prof = json.load(f)
        for key in ("parked_attach_s", "fast_warm_s", "serial_s"):
            v = prof.get(key)
            if isinstance(v, (int, float)) and v > 0:
                return float(v)
        v = (prof.get("phases") or {}).get("ready_s")
        if isinstance(v, (int, float)) and v > 0:
            return float(v)
    except (OSError, ValueError):
        pass
    return default


def _overlaps_gap(t: float, step: float, gaps: list[dict]) -> bool:
    for g in gaps:
        if t < g["until"] and t + step > g["since"]:
            return True
    return False


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return s[mid]
    return (s[mid - 1] + s[mid]) / 2.0


class _Fit:
    """One model+signal fit: a robust (per-bin median) seasonal
    baseline, recent level/trend, residual sigma, and the
    gap-widening factor."""

    __slots__ = (
        "step", "season", "bins", "seasonal_vals",
        "level", "trend", "sigma", "widen", "obs", "n_obs",
    )

    def __init__(self, step: float, season: float, bins: int):
        self.step = step
        self.season = season
        self.bins = bins
        self.seasonal_vals: list[list[float]] = [[] for _ in range(bins)]
        self.level = 0.0
        self.trend = 0.0
        self.sigma = 0.0
        self.widen = 1.0
        self.obs: dict[float, float] = {}
        self.n_obs = 0

    def phase(self, t: float) -> int:
        return int((t % self.season) / self.step) % self.bins

    def seasonal(self, t: float) -> float | None:
        # Median, not mean: with >= 3 seasons in the window, one
        # anomalous season cannot drag a bin that the clean seasons
        # agree on — which would otherwise poison the residual sigma
        # for a whole season after a flood ends.
        vals = self.seasonal_vals[self.phase(t)]
        if not vals:
            return None
        return _median(vals)

    def predict(self, t: float, now: float) -> tuple[float, float, float, float]:
        """-> (pred, lower, upper, sigma_eff) for target time *t*."""
        h = max(t - now, 0.0)
        base = self.seasonal(t)
        base_now = self.seasonal(now)
        # Level correction: how far the recent level sits off its own
        # seasonal expectation, decayed toward pure seasonal over one
        # season ahead — a hot afternoon shifts tonight's forecast up,
        # but not next week's.
        offset = self.level - base_now if base_now is not None else 0.0
        decay = max(0.0, 1.0 - h / self.season)
        drift = self.trend * min(h, self.season / 4.0)
        empty_bin = base is None
        if empty_bin:
            # No season ever observed this phase (gaps, young store):
            # persist the level instead of inventing a zero trough.
            pred = self.level + drift
        else:
            pred = base + offset * decay + drift
        pred = max(pred, 0.0)
        sigma_eff = self.sigma * self.widen * math.sqrt(1.0 + h / self.season)
        if empty_bin:
            sigma_eff *= 2.0
        half = 2.0 * sigma_eff  # ~95% band
        return pred, max(pred - half, 0.0), pred + half, sigma_eff


class _SignalState:
    """Per model+signal bookkeeping across ticks."""

    __slots__ = (
        "fit", "curve", "curve_t", "pending", "scored", "recent",
        "last_obs", "last_obs_t", "anomaly_score", "anomaly_streak",
    )

    def __init__(self):
        self.fit: _Fit | None = None
        self.curve: list[tuple[float, float, float, float, float]] = []
        self.curve_t: float = 0.0
        # target bucket t -> (made_at, pred, lo, hi); earliest forecast
        # per bucket wins — scoring measures genuinely-ahead predictions.
        self.pending: dict[float, tuple[float, float, float, float]] = {}
        self.scored: deque = deque(maxlen=240)
        # (t, observed, pred, lo, hi) per tick, for sparkline rendering.
        self.recent: deque = deque(maxlen=180)
        self.last_obs: float | None = None
        self.last_obs_t: float = 0.0
        self.anomaly_score: float = 0.0
        self.anomaly_streak: int = 0

    def mape(self) -> float | None:
        if not self.scored:
            return None
        return sum(a for a, _ in self.scored) / len(self.scored)

    def coverage(self) -> float | None:
        if not self.scored:
            return None
        return sum(1.0 for _, c in self.scored if c) / len(self.scored)


class Forecaster:
    """Leader-gated forecasting + anomaly scoring over a HistoryStore.

    ``tick()`` is the whole engine: discover models, fit, emit curves +
    gauges, score matured forecasts, update anomaly streaks, publish
    ``traffic_anomaly``, and flip the per-model auto-disable guardrail.
    Runs on a daemon thread (``start()``) or is ticked externally with
    injected clocks in tests/drills."""

    def __init__(
        self,
        history,
        election=None,
        decision_log=None,
        interval_seconds: float | None = None,
        season_seconds: float | None = None,
        bins: int | None = None,
        horizon_seconds: float | None = None,
        lead_seconds: float | None = None,
        fit_seasons: int | None = None,
        timeline=None,
        clock=time.monotonic,
        wall=time.time,
    ):
        self.history = history
        self.election = election
        self.decision_log = decision_log
        self.interval = (
            interval_seconds
            if interval_seconds is not None
            else max(env_float("KUBEAI_FORECAST_INTERVAL", 15.0), 0.25)
        )
        self.season = (
            season_seconds
            if season_seconds is not None
            else max(env_float("KUBEAI_FORECAST_SEASON_SECONDS", 86400.0), 8.0)
        )
        self.bins = int(bins or env_float("KUBEAI_FORECAST_BINS", 144))
        self.bins = max(self.bins, 8)
        self.horizon = (
            horizon_seconds
            if horizon_seconds is not None
            else min(
                max(env_float("KUBEAI_FORECAST_HORIZON", self.season / 8.0),
                    2.0 * self.interval),
                self.season,
            )
        )
        self.lead = (
            lead_seconds
            if lead_seconds is not None
            else derive_lead_seconds(timeline=timeline)
        )
        self.lead = min(max(self.lead, 1.0), self.horizon)
        self.fit_seasons = int(fit_seasons or env_float("KUBEAI_FORECAST_FIT_SEASONS", 3))
        self.mape_disable = env_float("KUBEAI_FORECAST_MAPE_DISABLE", 0.6)
        self.min_scored = int(env_float("KUBEAI_FORECAST_MIN_SCORED", 12))
        self.anomaly_threshold = env_float("KUBEAI_FORECAST_ANOMALY_SCORE", 1.0)
        self.anomaly_ticks = int(env_float("KUBEAI_FORECAST_ANOMALY_TICKS", 3))
        self.gap_widen = env_float("KUBEAI_FORECAST_GAP_WIDEN", 2.0)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._states: dict[tuple[str, str], _SignalState] = {}
        self._disabled: dict[str, str] = {}  # model -> reason
        self._last_tick_wall: float = 0.0
        self.ticks = 0
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._running = False

    # -- discovery ---------------------------------------------------------

    def models(self) -> list[str]:
        found: set[str] = set()
        for name in self.history.series_names():
            if name.startswith(REQUEST_SERIES_PREFIX):
                for part in name[len(REQUEST_SERIES_PREFIX):-1].split(","):
                    k, _, v = part.partition("=")
                    if k == "request_model" and v:
                        found.add(v)
            elif name.startswith("fleet.") and name.endswith(TOKEN_SERIES_SUFFIX):
                body = name[len("fleet."):-len(TOKEN_SERIES_SUFFIX)]
                if "." not in body:  # per-model aggregate, not per-endpoint/pool
                    found.add(body)
        return sorted(found)

    def _series_for(self, model: str, signal: str) -> list[str]:
        if signal == "requests":
            needle_mid = f"request_model={model},"
            needle_end = f"request_model={model}}}"
            return [
                n for n in self.history.series_names()
                if n.startswith(REQUEST_SERIES_PREFIX)
                and (needle_mid in n or n.endswith(needle_end))
            ]
        return [
            n for n in self.history.series_names()
            if n == f"fleet.{model}{TOKEN_SERIES_SUFFIX}"
        ]

    # -- fit ---------------------------------------------------------------

    def _fit_signal(self, model: str, signal: str, now: float) -> _Fit | None:
        names = self._series_for(model, signal)
        if not names:
            return None
        step = max(self.season / self.bins, self.history.tiers[0][0])
        since = max(now - self.fit_seasons * self.season, now - 7 * 86400.0)
        q = self.history.query(names, since=since, until=now, step=step)
        gaps = q.get("gaps") or []
        fit = _Fit(step=step, season=self.season, bins=self.bins)
        # Sum the per-bucket mean across matching series (request_type
        # label fan-out), aligned to step boundaries.
        merged: dict[float, float] = {}
        for s in q["series"].values():
            for row in s["points"]:
                t, n, total = row[0], row[1], row[2]
                if n <= 0:
                    continue
                b = t - (t % step)
                merged[b] = merged.get(b, 0.0) + total / n
        # Honesty: a bucket under a gap is unknown, not zero.
        obs = {
            t: v for t, v in merged.items()
            if not _overlaps_gap(t, step, gaps)
        }
        if len(obs) < 3:
            return None
        fit.obs = obs
        fit.n_obs = len(obs)
        for t, v in obs.items():
            fit.seasonal_vals[fit.phase(t)].append(v)
        ts = sorted(obs)
        # Residual sigma vs the seasonal expectation, over the window —
        # ROBUST (median absolute deviation): a flood or outage sitting
        # inside the fit window must not inflate sigma and widen the
        # band enough to hide itself; only the typical spread counts.
        resid = []
        for t in ts:
            base = fit.seasonal(t)
            if base is not None:
                resid.append(obs[t] - base)
        if len(resid) >= 3:
            med = _median(resid)
            fit.sigma = 1.4826 * _median([abs(r - med) for r in resid])
        peak = max(
            (_median(v) for v in fit.seasonal_vals if v),
            default=0.0,
        )
        fit.sigma = max(fit.sigma, 0.1 * peak, 0.25)
        # Level/trend see WINSORIZED observations: the recent level may
        # drift inside the seasonal band, but an observation the fit
        # itself would flag as anomalous (beyond ~2 sigma of seasonal)
        # must not teach the level to chase it — otherwise a single
        # refit assimilates a flood into the offset, the band swallows
        # it, and the anomaly score resets before the sustained-ticks
        # trigger can ever fire.
        def clamped(t: float) -> float:
            v = obs[t]
            base = fit.seasonal(t)
            if base is None:
                return v
            lim = 2.0 * fit.sigma
            return min(max(v, base - lim), base + lim)

        k = max(3, self.bins // 16)
        tail = ts[-k:]
        fit.level = sum(clamped(t) for t in tail) / len(tail)
        if len(tail) >= 4:
            half = len(tail) // 2
            a = sum(clamped(t) for t in tail[:half]) / half
            b = sum(clamped(t) for t in tail[half:]) / (len(tail) - half)
            span = max((tail[-1] - tail[0]) / 2.0, step)
            fit.trend = (b - a) / span * step  # per-step drift
        # Gaps widen the interval proportionally to how much of the fit
        # window they swallowed.
        window = max(now - since, step)
        gap_s = 0.0
        for g in gaps:
            lo = max(g["since"], since)
            hi = min(g["until"], now)
            if hi > lo:
                gap_s += hi - lo
        fit.widen = 1.0 + self.gap_widen * min(gap_s / window, 1.0)
        return fit

    # -- tick --------------------------------------------------------------

    def tick(self) -> None:
        if self.election is not None and not self.election.is_leader.is_set():
            return  # followers compute nothing
        now = self._wall()
        with self._lock:
            self._last_tick_wall = now
            self.ticks += 1
            for model in self.models():
                for signal in SIGNALS:
                    try:
                        self._tick_signal(model, signal, now)
                    except Exception:
                        log.exception(
                            "forecast tick failed for %s/%s", model, signal
                        )
                self._update_disable(model, now)
                self._update_anomaly(model, now)

    def _tick_signal(self, model: str, signal: str, now: float) -> None:
        st = self._states.setdefault((model, signal), _SignalState())
        fit = self._fit_signal(model, signal, now)
        if fit is None:
            return
        st.fit = fit
        step = fit.step
        # Latest observation (for anomaly scoring + recent window).
        fresh = [t for t in fit.obs if t >= now - 3 * step]
        if fresh:
            t_obs = max(fresh)
            st.last_obs, st.last_obs_t = fit.obs[t_obs], t_obs
        # Score matured pending forecasts against what actually happened.
        scored_now = 0
        last_scored: tuple[float, float, float, bool] | None = None
        for target in sorted(st.pending):
            if target > now - step:
                break
            made_at, pred, lo, hi = st.pending.pop(target)
            actual = fit.obs.get(target)
            if actual is None:
                continue  # gap or missing bucket: unscorable, not an error
            floor = max(1.0, 0.05 * max(fit.level, 1.0))
            ape = abs(pred - actual) / max(abs(actual), floor)
            inside = lo <= actual <= hi
            st.scored.append((ape, inside))
            scored_now += 1
            last_scored = (pred, actual, ape, inside)
        # Horizon curve from now to now+horizon.
        curve = []
        t = now - (now % step)
        while t <= now + self.horizon:
            pred, lo, hi, sig = fit.predict(t, now)
            curve.append((t, pred, lo, hi, sig))
            if t > now + step / 2 and t not in st.pending:
                st.pending[t] = (now, pred, lo, hi)
            t += step
        if len(st.pending) > 1024:
            for key in sorted(st.pending)[: len(st.pending) - 1024]:
                del st.pending[key]
        st.curve, st.curve_t = curve, now
        # Anomaly: observed now vs the interval covering now.
        pred_now, lo_now, hi_now, sig_now = fit.predict(
            st.last_obs_t if st.last_obs is not None else now, now
        )
        if st.last_obs is not None and st.last_obs_t >= now - 3 * step:
            obs = st.last_obs
            if obs > hi_now:
                st.anomaly_score = (obs - hi_now) / max(sig_now, 1e-9)
            elif obs < lo_now:
                st.anomaly_score = (lo_now - obs) / max(sig_now, 1e-9)
            else:
                st.anomaly_score = 0.0
            st.recent.append((now, obs, pred_now, lo_now, hi_now))
        else:
            st.anomaly_score = 0.0
            st.recent.append((now, None, pred_now, lo_now, hi_now))
        # Gauges + audit trail.
        at_lead = self._point_at(st, now + self.lead)
        labels = {"model": model, "signal": signal}
        if at_lead is not None:
            M_RATE.set(at_lead[1], labels)
            M_LOWER.set(at_lead[2], labels)
            M_UPPER.set(at_lead[3], labels)
        M_ANOMALY.set(st.anomaly_score, labels)
        mape = st.mape()
        if mape is not None:
            M_MAPE.set(mape, labels)
        if scored_now and last_scored and self.decision_log is not None:
            pred, actual, ape, inside = last_scored
            self.decision_log.append({
                "t": now,
                "model": model,
                "source": "forecast",
                "action": "forecast_scored",
                "signal_kind": signal,
                "scored": scored_now,
                "predicted": round(pred, 3),
                "actual": round(actual, 3),
                "error_pct": round(100.0 * ape, 1),
                "in_interval": inside,
                "mape": round(mape, 4) if mape is not None else None,
            })

    @staticmethod
    def _point_at(st: _SignalState, t: float):
        best = None
        for row in st.curve:
            if best is None or abs(row[0] - t) < abs(best[0] - t):
                best = row
        return best

    def _update_disable(self, model: str, now: float) -> None:
        """MAPE guardrail on the operational (requests) signal: breach
        disables the forecast for this model; hysteresis re-enables it
        once accuracy recovers."""
        st = self._states.get((model, "requests"))
        mape = st.mape() if st is not None else None
        scored = len(st.scored) if st is not None else 0
        was = model in self._disabled
        if (
            not was
            and mape is not None
            and scored >= self.min_scored
            and mape > self.mape_disable
        ):
            reason = (
                f"rolling MAPE {mape:.2f} > {self.mape_disable:.2f} "
                f"over {scored} scored forecasts"
            )
            self._disabled[model] = reason
            M_DISABLED.set(1.0, {"model": model})
            log.warning("forecast auto-disabled for %s: %s", model, reason)
            if self.decision_log is not None:
                self.decision_log.append({
                    "t": now,
                    "model": model,
                    "source": "forecast",
                    "action": "forecast_auto_disable",
                    "reason": reason,
                    "mape": round(mape, 4),
                    "threshold": self.mape_disable,
                })
        elif was and mape is not None and mape < 0.75 * self.mape_disable:
            del self._disabled[model]
            M_DISABLED.set(0.0, {"model": model})
            log.info("forecast re-enabled for %s (MAPE %.2f)", model, mape)
            if self.decision_log is not None:
                self.decision_log.append({
                    "t": now,
                    "model": model,
                    "source": "forecast",
                    "action": "forecast_reenable",
                    "mape": round(mape, 4),
                    "threshold": self.mape_disable,
                })

    def _update_anomaly(self, model: str, now: float) -> None:
        score = 0.0
        worst = None
        for signal in SIGNALS:
            st = self._states.get((model, signal))
            if st is not None and st.anomaly_score > score:
                score, worst = st.anomaly_score, (signal, st)
        streak_holder = self._states.get((model, "requests"))
        if streak_holder is None:
            return
        if score >= self.anomaly_threshold:
            streak_holder.anomaly_streak += 1
        else:
            streak_holder.anomaly_streak = 0
            return
        if streak_holder.anomaly_streak == self.anomaly_ticks and worst is not None:
            signal, st = worst
            _, obs, pred, lo, hi = st.recent[-1] if st.recent else (0, None, 0, 0, 0)
            publish_trigger(
                "traffic_anomaly",
                model=model,
                detail={
                    "signal": signal,
                    "observed": round(obs, 3) if obs is not None else None,
                    "predicted": round(pred, 3),
                    "lower": round(lo, 3),
                    "upper": round(hi, 3),
                    "score": round(score, 2),
                    "sustained_ticks": streak_holder.anomaly_streak,
                },
                key=f"traffic_anomaly:{model}",
            )

    # -- consumers ---------------------------------------------------------

    def signal_at_lead(self, model: str) -> dict | None:
        """The autoscaler's forecast signal: predicted in-flight
        requests one cold-start lead ahead, or None when there is no
        usable forecast (no fit yet, stale, or auto-disabled)."""
        with self._lock:
            disabled = self._disabled.get(model)
            st = self._states.get((model, "requests"))
            if st is None or not st.curve:
                return None
            age = self._wall() - st.curve_t
            if age > 4 * self.interval + 1.0:
                return None  # stale: leadership moved or forecaster wedged
            out = {
                "lead_seconds": self.lead,
                "made_t": st.curve_t,
                "age_s": round(age, 3),
                "mape": st.mape(),
                "disabled": disabled is not None,
            }
            if disabled is not None:
                out["disabled_reason"] = disabled
                return out
            point = self._point_at(st, st.curve_t + self.lead)
            if point is None:
                return None
            out.update({
                "rate": point[1],
                "lower": point[2],
                "upper": point[3],
            })
            return out

    def report(self, model: str | None = None, points: int = 64) -> dict:
        leading = (
            self.election is None or self.election.is_leader.is_set()
        )
        out = {
            "active": leading,
            "interval_seconds": self.interval,
            "season_seconds": self.season,
            "horizon_seconds": self.horizon,
            "lead_seconds": self.lead,
            "bins": self.bins,
            "ticks": self.ticks,
            "mape_disable_threshold": self.mape_disable,
            "anomaly_score_threshold": self.anomaly_threshold,
            "models": {},
        }
        with self._lock:
            names = sorted({m for m, _ in self._states})
            for name in names:
                if model and name != model:
                    continue
                entry: dict = {
                    "disabled": name in self._disabled,
                    "signals": {},
                }
                if name in self._disabled:
                    entry["disabled_reason"] = self._disabled[name]
                for signal in SIGNALS:
                    st = self._states.get((name, signal))
                    if st is None or st.fit is None:
                        continue
                    curve = st.curve
                    stride = max(1, len(curve) // points)
                    entry["signals"][signal] = {
                        "made_t": st.curve_t,
                        "step_seconds": st.fit.step,
                        "level": round(st.fit.level, 3),
                        "trend_per_step": round(st.fit.trend, 4),
                        "sigma": round(st.fit.sigma, 3),
                        "interval_widen": round(st.fit.widen, 3),
                        "observed": st.last_obs,
                        "anomaly_score": round(st.anomaly_score, 3),
                        "anomaly_streak": st.anomaly_streak,
                        "accuracy": {
                            "mape": st.mape(),
                            "interval_coverage": st.coverage(),
                            "scored": len(st.scored),
                            "pending": len(st.pending),
                        },
                        "curve": [
                            [round(t, 3), round(p, 3), round(lo, 3), round(hi, 3)]
                            for t, p, lo, hi, _ in curve[::stride]
                        ],
                        "recent": [
                            [
                                round(t, 3),
                                round(o, 3) if o is not None else None,
                                round(p, 3),
                                round(lo, 3),
                                round(hi, 3),
                            ]
                            for t, o, p, lo, hi in st.recent
                        ],
                    }
                out["models"][name] = entry
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="forecaster", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._stop_evt.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while self._running:
            if self._stop_evt.wait(self.interval):
                return
            try:
                self.tick()
            except Exception:  # pragma: no cover - defensive
                log.exception("forecaster tick failed")


# ---------------------------------------------------------------------------
# Process-global install point (mirrors incidents/history): both HTTP
# servers chain handle_forecast_request; only the operator Manager
# installs a Forecaster, so engines answer an honest 404.

_forecaster: Forecaster | None = None


def install_forecaster(fc: Forecaster) -> None:
    global _forecaster
    _forecaster = fc


def uninstall_forecaster(fc: Forecaster) -> None:
    global _forecaster
    if _forecaster is fc:
        _forecaster = None


def installed_forecaster() -> Forecaster | None:
    return _forecaster


def handle_forecast_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    if path != "/debug/forecast":
        return None
    fc = _forecaster
    if fc is None:
        return (
            404,
            "application/json",
            json.dumps({
                "error": "no forecaster installed on this process (operator-side surface)"
            }).encode(),
        )
    params = parse_qs(query or "")
    model = (params.get("model") or [None])[0]
    try:
        points = int((params.get("points") or ["64"])[0])
    except ValueError:
        points = 64
    body = json.dumps(
        fc.report(model=model, points=max(points, 2)), indent=1
    ).encode()
    return 200, "application/json", body
