"""The embedded metrics history (port of kubeai_tpu/obs/history.py):
bounded, tiered time series of every metric the registry carries, served
at ``GET /debug/history?series=&since=&step=`` by the engine server and
the operator's proxy.

- **Tiers.** Each series keeps fixed-width buckets in several tiers
  (5 s x 1 h, 60 s x 12 h, 600 s x 7 d). A bucket holds ``count, sum,
  min, max, last``, so a coarse tier still shows the worst value inside
  it.
- **Sampling** (``RegistrySampler``, every ``KUBEAI_HISTORY_INTERVAL``
  seconds, 5 by default, 0.25 at least): counters become rates over the
  interval (a counter that goes backwards re-anchors), gauges and
  callback gauges are sampled as values, and the key histograms become
  ``_p50`` / ``_p95`` series from the bucket counts added since the last
  tick.
- **Bounds.** At most ``KUBEAI_HISTORY_MAX_SERIES`` series (more are
  counted and dropped); on disk a ring of at most
  ``KUBEAI_HISTORY_MAX_FILES`` snapshots under ``KUBEAI_HISTORY_DIR``
  (written to a temporary name and renamed), at most one write per
  ``KUBEAI_HISTORY_FLUSH_SECONDS``, and one at stop. The file format is
  the JAX store's: each package reads the other's files.
- **Gaps.** A store that loads an earlier process's history marks the
  restart as a gap, a sampler whose ticks stalled marks the stall, and
  a sampler given an *election* marks each change of leadership.
  Queries return the gap markers beside the points.
- **The operator's side.** The Manager's store (under
  ``<KUBEAI_HISTORY_DIR>/operator``) also takes each fleet collect
  (``record_fleet``: ``fleet.<model>[.<addr>|.pool.<role>].<key>``
  series, so a dead pod's trajectory outlives it), and every incident
  embeds its ``context_block()``: the last
  ``KUBEAI_INCIDENT_CONTEXT_SECONDS`` of a few key series.

The ``history.disk`` failpoint (kubeai_tpu_torch/faults.py) fails a
write: the store then keeps its history in memory only.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from urllib.parse import parse_qs

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.faults import fault
from kubeai_tpu_torch.metrics import CallbackGauge, Counter, Gauge, Histogram, default_registry
from kubeai_tpu_torch.obs.slo import bucket_quantile

log = logging.getLogger("kubeai_tpu_torch.history")

# (bucket seconds, buckets) per tier, finest first.
DEFAULT_TIERS: tuple[tuple[float, int], ...] = (
    (5.0, 720),
    (60.0, 720),
    (600.0, 1008),
)

# A bucket is a list (they are written to disk as they are):
# [t_bucket_start, count, sum, min, max, last]
_T, _N, _SUM, _MIN, _MAX, _LAST = range(6)

# The histograms that get p50/p95 series.
KEY_HISTOGRAMS: tuple[str, ...] = (
    "kubeai_engine_ttft_seconds",
    "kubeai_engine_tpot_seconds",
    "kubeai_request_e2e_seconds",
)


# The incident context's series: prefixes of the live series names (the
# block rides inside every persisted incident, so the set stays small).
CONTEXT_SERIES_PREFIXES: tuple[str, ...] = (
    "kubeai_engine_mfu",
    "kubeai_engine_tokens_per_second",
    "kubeai_fleet_tokens_per_second",
    "kubeai_engine_stall_seconds_total",
    "kubeai_engine_queue_depth",
    "kubeai_fleet_queue_depth",
    "kubeai_engine_requests_total",
    "kubeai_slo_burn_rate",
    "kubeai_tenant_share",
    "kubeai_endpoint_state",
    "kubeai_endpoint_health_score",
)

# A breaker state as a series value.
_BREAKER = {"closed": 0.0, "half_open": 1.0, "open": 2.0, "soft_ejected": 3.0}


def history_dir_default() -> str:
    """``KUBEAI_HISTORY_DIR``, else ``kubeai-history`` in the temporary
    directory."""
    return (os.environ.get("KUBEAI_HISTORY_DIR", "")
            or os.path.join(tempfile.gettempdir(), "kubeai-history"))


def _series_name(name: str, key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


def _merge(bucket: list, value: float) -> None:
    bucket[_N] += 1
    bucket[_SUM] += value
    if value < bucket[_MIN]:
        bucket[_MIN] = value
    if value > bucket[_MAX]:
        bucket[_MAX] = value
    bucket[_LAST] = value


class _Series:
    __slots__ = ("tiers",)

    def __init__(self, tier_spec: tuple[tuple[float, int], ...]):
        self.tiers: list[deque] = [deque(maxlen=n) for _, n in tier_spec]

    def add(self, tier_spec, t: float, value: float) -> None:
        for (step, _), buckets in zip(tier_spec, self.tiers):
            b0 = t - (t % step)
            if buckets and buckets[-1][_T] >= b0:
                # The open bucket, or a late sample for a closed one (it
                # folds into the tail: bucket order stays monotone).
                _merge(buckets[-1], value)
            else:
                buckets.append([b0, 1, value, value, value, value])


class HistoryStore:
    """Bounded, tiered, persisted time-series store. Thread-safe: one
    lock, and sampling and queries cost O(buckets)."""

    def __init__(
        self,
        history_dir: str | None = None,
        tiers: tuple[tuple[float, int], ...] = DEFAULT_TIERS,
        max_series: int | None = None,
        max_files: int | None = None,
        flush_seconds: float | None = None,
        wall=time.time,
    ):
        self.history_dir = history_dir if history_dir is not None else history_dir_default()
        self.tiers = tuple(sorted(tiers))
        self.max_series = (max_series if max_series is not None
                           else int(env_float("KUBEAI_HISTORY_MAX_SERIES", 1024)))
        self.max_files = (max_files if max_files is not None
                          else int(env_float("KUBEAI_HISTORY_MAX_FILES", 4)))
        self.flush_seconds = (flush_seconds if flush_seconds is not None
                              else env_float("KUBEAI_HISTORY_FLUSH_SECONDS", 60.0))
        self._wall = wall
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self.dropped_series = 0
        self._last_sample_t: float | None = None
        self._last_flush: float | None = None
        # Gap markers {"since", "until", "reason"}, bounded.
        self._gaps: deque[dict] = deque(maxlen=64)
        if self.history_dir:
            self._load()

    # -- ingest ------------------------------------------------------------

    def record(self, name: str, value: float, t: float | None = None) -> None:
        if value is None:
            return
        t = self._wall() if t is None else t
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                s = self._series[name] = _Series(self.tiers)
            s.add(self.tiers, t, float(value))
            if self._last_sample_t is None or t > self._last_sample_t:
                self._last_sample_t = t

    def record_fleet(self, views: dict, t: float | None = None) -> None:
        """Record one FleetCollector collect: each model's aggregate, each
        scraped endpoint's values, breaker state and health score, and
        each pool's aggregate, as ``fleet.<model>...`` series."""
        t = self._wall() if t is None else t
        agg_keys = ("queue_depth", "active_slots", "tokens_per_second", "free_pages",
                    "headroom_requests", "prefix_hit_ratio")
        ep_keys = ("queue_depth", "active_slots", "tokens_per_second", "pages_used",
                   "prefix_hit_ratio")
        for model, view in (views or {}).items():
            agg = view.get("aggregate") or {}
            for k in agg_keys:
                v = agg.get(k)
                if isinstance(v, (int, float)):
                    self.record(f"fleet.{model}.{k}", v, t=t)
            for ep in view.get("endpoints") or []:
                addr = ep.get("address")
                if not addr or not ep.get("ok"):
                    continue
                for k in ep_keys:
                    v = ep.get(k)
                    if isinstance(v, (int, float)):
                        self.record(f"fleet.{model}.{addr}.{k}", v, t=t)
                bs = _BREAKER.get(ep.get("breaker_state") or "")
                if bs is not None:
                    self.record(f"fleet.{model}.{addr}.breaker_state", bs, t=t)
                hs = ep.get("health_score")
                if isinstance(hs, (int, float)):
                    self.record(f"fleet.{model}.{addr}.health_score", hs, t=t)
            for role, pagg in (view.get("pools") or {}).items():
                for k in agg_keys:
                    v = pagg.get(k)
                    if isinstance(v, (int, float)):
                        self.record(f"fleet.{model}.pool.{role}.{k}", v, t=t)

    def mark_gap(self, reason: str, since: float | None = None, t: float | None = None) -> None:
        """Record an interval without data (a restart, a stalled
        sampler): queries report it rather than let it read as zero."""
        t = self._wall() if t is None else t
        with self._lock:
            if since is None:
                since = self._last_sample_t if self._last_sample_t is not None else t
            self._gaps.append({"since": round(float(since), 3), "until": round(float(t), 3),
                               "reason": reason})

    # -- read --------------------------------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def gaps(self, since: float = 0.0) -> list[dict]:
        with self._lock:
            return [g for g in self._gaps if g["until"] >= since]

    def _pick_tier(self, since: float, step: float | None, now: float) -> int:
        """The finest tier whose retention covers *since*; with a step,
        the coarsest covering tier that is still no coarser than it."""
        covering = [i for i, (s, n) in enumerate(self.tiers) if now - s * n <= since]
        if not covering:
            return len(self.tiers) - 1
        best = covering[0]
        if step is not None and step > 0:
            for i in covering:
                if self.tiers[i][0] <= step:
                    best = i
        return best

    def query(self, names: list[str], since: float, until: float | None = None,
              step: float | None = None) -> dict:
        """Each series' buckets in [since, until] from the best tier,
        merged to *step*-wide buckets when asked (count and sum add, min
        and max fold, last is the latest). Rows are
        ``[t, count, sum, min, max, last]``."""
        now = self._wall()
        until = now if until is None else until
        tier_idx = self._pick_tier(since, step, now)
        tier_step = self.tiers[tier_idx][0]
        eff_step = max(step or 0.0, tier_step)
        out: dict[str, dict] = {}
        with self._lock:
            for name in names:
                s = self._series.get(name)
                if s is None:
                    continue
                rows: list[list] = []
                for b in s.tiers[tier_idx]:
                    if b[_T] + tier_step < since or b[_T] > until:
                        continue
                    if eff_step > tier_step:
                        m0 = b[_T] - (b[_T] % eff_step)
                        if rows and rows[-1][_T] == m0:
                            r = rows[-1]
                            r[_N] += b[_N]
                            r[_SUM] += b[_SUM]
                            r[_MIN] = min(r[_MIN], b[_MIN])
                            r[_MAX] = max(r[_MAX], b[_MAX])
                            r[_LAST] = b[_LAST]
                            continue
                        rows.append([m0] + list(b[1:]))
                    else:
                        rows.append(list(b))
                out[name] = {"tier_step_seconds": tier_step, "step_seconds": eff_step,
                             "points": rows}
        return {
            "since": since,
            "until": until,
            "columns": ["t", "count", "sum", "min", "max", "last"],
            "series": out,
            "gaps": self.gaps(since=since),
        }

    def context_block(self, seconds: float | None = None, max_series: int = 48) -> dict:
        """An incident's look back: the last *seconds*
        (``KUBEAI_INCIDENT_CONTEXT_SECONDS``, 600 by default) of the
        context series and the ``fleet.`` ones, at most *max_series*."""
        seconds = (seconds if seconds is not None
                   else env_float("KUBEAI_INCIDENT_CONTEXT_SECONDS", 600.0))
        now = self._wall()
        wanted = [n for n in self.series_names()
                  if n.startswith(CONTEXT_SERIES_PREFIXES) or n.startswith("fleet.")]
        truncated = max(len(wanted) - max_series, 0)
        doc = self.query(wanted[:max_series], since=now - seconds, until=now)
        doc["window_seconds"] = seconds
        doc["captured_at"] = now
        if truncated:
            doc["series_truncated"] = truncated
        return doc

    def report(self) -> dict:
        """The /debug/history payload without a query: the series, the
        tiers, the bounds and the directory."""
        with self._lock:
            n_series = len(self._series)
            n_buckets = sum(len(t) for s in self._series.values() for t in s.tiers)
        return {
            "series": self.series_names(),
            "tiers": [{"step_seconds": s, "buckets": n, "span_seconds": s * n}
                      for s, n in self.tiers],
            "series_count": n_series,
            "bucket_count": n_buckets,
            "max_series": self.max_series,
            "dropped_series": self.dropped_series,
            "history_dir": self.history_dir,
            "gaps": list(self._gaps),
            "query": "/debug/history?series=<name|prefix*>[,<...>]&since=<epoch|seconds-ago>"
                     "&step=<seconds>",
        }

    # -- persistence -------------------------------------------------------

    def save(self, force: bool = False) -> None:
        """Write a snapshot into the disk ring, at most once per flush
        interval unless *force*. A failed write leaves the history in
        memory only."""
        if not self.history_dir:
            return
        now = self._wall()
        with self._lock:
            if (not force and self._last_flush is not None
                    and now - self._last_flush < self.flush_seconds):
                return
            self._last_flush = now
            doc = {
                "v": 1,
                "saved_at": now,
                "last_sample_t": self._last_sample_t,
                "tiers": list(self.tiers),
                "gaps": list(self._gaps),
                "series": {name: [list(map(list, t)) for t in s.tiers]
                           for name, s in self._series.items()},
            }
        final = os.path.join(self.history_dir, f"history-{int(now * 1000):013d}.json")
        tmp = final + ".tmp"
        try:
            # An armed history.disk raises FaultError, an OSError: the
            # branch below is the broken-disk path.
            fault("history.disk")
            os.makedirs(self.history_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, final)
            self._prune_disk()
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            log.warning("history persist failed (%s); kept in memory only", e)

    def _prune_disk(self) -> None:
        # Zero-padded epoch-ms names: lexicographic order is time order.
        names = []
        for n in os.listdir(self.history_dir):
            if not n.startswith("history-"):
                continue
            if n.endswith(".json.tmp"):
                try:
                    os.remove(os.path.join(self.history_dir, n))
                except OSError:
                    pass
            elif n.endswith(".json"):
                names.append(n)
        names.sort()
        for n in names[: max(len(names) - self.max_files, 0)]:
            try:
                os.remove(os.path.join(self.history_dir, n))
            except OSError:
                pass

    def _load(self) -> None:
        """Restore the newest readable snapshot and mark [its last
        sample, now] as a restart gap."""
        if not os.path.isdir(self.history_dir):
            return
        try:
            names = sorted(n for n in os.listdir(self.history_dir)
                           if n.startswith("history-") and n.endswith(".json"))
        except OSError:
            return
        for name in reversed(names):
            try:
                with open(os.path.join(self.history_dir, name)) as f:
                    doc = json.load(f)
                series = doc.get("series") or {}
                n_loaded = 0
                with self._lock:
                    for sname, tiers in series.items():
                        if len(self._series) >= self.max_series:
                            break
                        s = _Series(self.tiers)
                        for buckets, dq in zip(tiers, s.tiers):
                            for b in buckets[-(dq.maxlen or 0):]:
                                if isinstance(b, list) and len(b) == 6:
                                    dq.append([float(b[0]), int(b[1])] + [float(x) for x in b[2:]])
                        self._series[sname] = s
                        n_loaded += 1
                    for g in (doc.get("gaps") or [])[-32:]:
                        if isinstance(g, dict):
                            self._gaps.append(g)
                    last_t = doc.get("last_sample_t")
                    if isinstance(last_t, (int, float)):
                        self._last_sample_t = float(last_t)
                if isinstance(doc.get("last_sample_t"), (int, float)):
                    self.mark_gap("restart", since=float(doc["last_sample_t"]))
                log.info("history restored: %d series from %s", n_loaded, name)
                return
            except (OSError, ValueError, TypeError):
                continue  # a corrupt snapshot: try the next newest


class RegistrySampler:
    """Samples the registry into a HistoryStore every *interval* seconds
    on a daemon thread (``start()``), or when ``tick()`` is called (tests,
    with an injected clock and wall). With an *election* (an object with
    an ``is_leader`` Event) each change of leadership marks a gap."""

    def __init__(self, store: HistoryStore, registry=None, interval_seconds: float | None = None,
                 histograms: tuple[str, ...] = KEY_HISTOGRAMS, clock=time.monotonic,
                 wall=time.time, election=None):
        self.store = store
        self.registry = registry or default_registry
        self.interval = (interval_seconds if interval_seconds is not None
                         else max(env_float("KUBEAI_HISTORY_INTERVAL", 5.0), 0.25))
        self.histograms = tuple(histograms)
        self._clock = clock
        self._wall = wall
        self._election = election
        self._was_leader: bool | None = None
        # (metric, label key) -> (monotonic t, cumulative) counter anchors.
        self._anchors: dict[tuple[str, tuple], tuple[float, float]] = {}
        # metric -> {label key: (counts, sum, n)} histogram snapshots.
        self._hist_snaps: dict[str, dict] = {}
        self._last_tick: float | None = None
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

    def tick(self) -> None:
        now = self._clock()
        wall_t = self._wall()
        # A sampler that went quiet marks the hole instead of letting the
        # next bucket span it.
        if self._last_tick is not None and now - self._last_tick > 3 * self.interval:
            self.store.mark_gap("sampler_stall", since=wall_t - (now - self._last_tick),
                                t=wall_t)
        self._last_tick = now
        if self._election is not None:
            leading = self._election.is_leader.is_set()
            if self._was_leader is not None and leading != self._was_leader:
                self.store.mark_gap("leadership_change", since=wall_t, t=wall_t)
            self._was_leader = leading
        for name, metric in self.registry.metrics().items():
            try:
                if isinstance(metric, Counter):
                    self._sample_counter(name, metric, now, wall_t)
                elif isinstance(metric, CallbackGauge):
                    self.store.record(name, metric.value(), t=wall_t)
                elif isinstance(metric, Gauge):
                    for key, v in metric.snapshot().items():
                        self.store.record(_series_name(name, key), v, t=wall_t)
                elif isinstance(metric, Histogram) and name in self.histograms:
                    self._sample_histogram(name, metric, wall_t)
            except Exception:  # one broken metric must not starve the rest
                log.exception("history sample failed for %s", name)
        self.store.save()

    def _sample_counter(self, name: str, metric: Counter, now: float, wall_t: float) -> None:
        for key, total in metric.snapshot().items():
            akey = (name, key)
            prev = self._anchors.get(akey)
            self._anchors[akey] = (now, total)
            if prev is None:
                continue  # the first sighting only anchors
            t0, c0 = prev
            if total < c0:
                continue  # a reset: re-anchored above
            dt = now - t0
            if dt <= 0:
                continue
            self.store.record(_series_name(name, key), (total - c0) / dt, t=wall_t)

    def _sample_histogram(self, name: str, metric: Histogram, wall_t: float) -> None:
        cur = metric.snapshot()
        prev = self._hist_snaps.get(name)
        self._hist_snaps[name] = cur
        if prev is None:
            return
        # Label sets fold together: one p50/p95 pair per histogram.
        n_buckets = len(metric.buckets) + 1
        deltas = [0.0] * n_buckets
        for key, (counts, _, _) in cur.items():
            base = prev.get(key, ([0] * n_buckets, 0.0, 0))[0]
            for i, c in enumerate(counts):
                d = c - (base[i] if i < len(base) else 0)
                if d > 0:
                    deltas[i] += d
        if sum(deltas) <= 0:
            return
        for q, suffix in ((0.5, "_p50"), (0.95, "_p95")):
            v = bucket_quantile(metric.buckets, deltas, q)
            if v is not None:
                self.store.record(name + suffix, v, t=wall_t)

    def start(self) -> None:
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, name="history-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.store.save(force=True)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval):
            try:
                self.tick()
            except Exception:
                log.exception("history sampler tick failed")


# ---------------------------------------------------------------------------
# The process's store: the engine server installs one at start unless one
# is installed already, and the /debug route reads it.

_store: HistoryStore | None = None


def install_history(store: HistoryStore) -> None:
    global _store
    _store = store


def uninstall_history(store: HistoryStore) -> None:
    """Identity-checked: a stopped owner must not clobber a newer one."""
    global _store
    if _store is store:
        _store = None


def installed_history() -> HistoryStore | None:
    return _store


_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float | None], width: int = 60) -> str:
    """A text sparkline of *values* (None, no bucket, is '·'), scaled
    min..max; a flat series renders mid-height. Past *width* values each
    cell shows the max of its values, so a spike stays visible."""
    if not values:
        return ""
    if len(values) > width:
        cells: list[float | None] = []
        per = len(values) / width
        for i in range(width):
            chunk = [v for v in values[int(i * per): max(int((i + 1) * per), int(i * per) + 1)]
                     if v is not None]
            cells.append(max(chunk) if chunk else None)
        values = cells
    present = [v for v in values if v is not None]
    if not present:
        return "·" * len(values)
    lo, hi = min(present), max(present)
    span = hi - lo
    out = []
    for v in values:
        if v is None:
            out.append("·")
        elif span <= 0:
            out.append(_BLOCKS[3])
        else:
            out.append(_BLOCKS[min(int((v - lo) / span * (len(_BLOCKS) - 1) + 0.5),
                                   len(_BLOCKS) - 1)])
    return "".join(out)


def handle_history_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    """``GET /debug/history``: the store's report, or with ``series=``
    (names, or prefixes ending in ``*``) a range query from ``since=``
    (an epoch time, or seconds ago below 1e9; 600 s ago by default) at
    ``step=`` seconds."""
    if path != "/debug/history":
        return None
    store = _store
    if store is None:
        return 404, "application/json", json.dumps(
            {"error": {"message": "no history store installed on this process"}}).encode()
    q = parse_qs(query or "")

    def floatq(name: str) -> float | None:
        try:
            return float(q[name][0])
        except (KeyError, ValueError, IndexError):
            return None

    raw_series = [part for val in q.get("series", []) for part in val.split(",") if part]
    if not raw_series:
        return 200, "application/json", json.dumps(store.report()).encode()
    names: list[str] = []
    all_names = store.series_names()
    for pat in raw_series:
        if pat.endswith("*"):
            names.extend(n for n in all_names if n.startswith(pat[:-1]))
        else:
            names.append(pat)  # an unknown name answers with no points
    now = store._wall()
    since = floatq("since")
    if since is None:
        since = now - 600.0
    elif since < 1e9:
        since = now - since
    body = json.dumps(store.query(names, since=since, step=floatq("step"))).encode()
    return 200, "application/json", body
