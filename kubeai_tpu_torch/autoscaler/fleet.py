"""Fleet scrape collector (port of kubeai_tpu/autoscaler/fleet.py): one
``/metrics`` scrape per engine endpoint per tick, shared by the
autoscaler's engine-load signal and the operator's ``GET /debug/fleet``.

One long-lived pool of daemon scrape threads; each endpoint fetched once
per collect; per-endpoint tokens/s from the generated-token counter's
deltas between collects; the load balancer's breaker and latency-health
state merged in; per-model aggregate gauges and a headroom estimate.
With ``history`` set (the Manager sets its store), each collect is also
recorded there (``HistoryStore.record_fleet``), so a dead pod's
trajectory outlives the pod.
"""

from __future__ import annotations

import queue
import threading
import time

from kubeai_tpu_torch.metrics import default_registry, parse_prometheus_text
from kubeai_tpu_torch.obs.perf import TokenRateWindow

# Engine-side gauges/counters the collector reads off each endpoint's
# /metrics page (all exported by the engine, engine/core.py).
_QUEUE = "kubeai_engine_queue_depth"
_ACTIVE = "kubeai_engine_active_slots"
_SLOTS_TOTAL = "kubeai_engine_slots_total"
_PAGES_USED = "kubeai_engine_kv_pages_used"
_PAGES_CACHED = "kubeai_engine_kv_pages_cached"
_PAGES_TOTAL = "kubeai_engine_kv_pages_total"
_GEN_TOKENS = "kubeai_engine_generated_tokens_total"
_HBM_USED = "kubeai_engine_hbm_used_bytes"
_HBM_LIMIT = "kubeai_engine_hbm_limit_bytes"
_PREFIX_CACHED = "kubeai_engine_prefix_cached_tokens_total"
_PREFIX_LOOKUP = "kubeai_engine_prefix_lookup_tokens_total"
_CACHED_EVICTIONS = "kubeai_engine_kv_cached_evictions_total"
# Engine-side TTFT histogram (sum/count): scrape deltas feed the load
# balancer's gray-failure latency scorer with engine-observed evidence,
# complementing the proxy's own per-attempt observations.
_TTFT_SUM = "kubeai_engine_ttft_seconds_sum"
_TTFT_COUNT = "kubeai_engine_ttft_seconds_count"
# Exported by qos/stats.py, scraped here so the autoscaler
# can tell deferrable batch backlog apart from interactive pressure.
_QOS_QUEUE = "kubeai_qos_queue_depth"

M_FLEET_ACTIVE = default_registry.gauge(
    "kubeai_fleet_active_slots",
    "decode slots in use across the model's endpoints (fleet scrape sum)",
)
M_FLEET_QUEUE = default_registry.gauge(
    "kubeai_fleet_queue_depth",
    "requests queued inside engines across the model's endpoints",
)
M_FLEET_FREE_PAGES = default_registry.gauge(
    "kubeai_fleet_free_pages",
    "unreferenced KV pool pages across the model's endpoints",
)
M_FLEET_TPS = default_registry.gauge(
    "kubeai_fleet_tokens_per_second",
    "fleet decode throughput per model (generated-token counter deltas between collects)",
)
M_FLEET_HEADROOM = default_registry.gauge(
    "kubeai_fleet_headroom_requests",
    "estimated additional concurrent requests the model's fleet can absorb "
    "(free slots bounded by free KV pages at the observed pages-per-request)",
)
M_FLEET_PREFIX_RATIO = default_registry.gauge(
    "kubeai_fleet_prefix_hit_ratio",
    "fleet-wide prefix-cache hit ratio per model: cumulative cached tokens "
    "over cumulative looked-up prompt tokens across the model's endpoints "
    "(0 with no lookups yet)",
)
# Same metric the autoscaler's peer scrape increments (scope label keeps
# the sources apart); registering here is idempotent get-or-create.
M_SCRAPE_FAILURES = default_registry.counter(
    "kubeai_autoscaler_scrape_failures_total",
    "failed telemetry scrapes by scope (peer = operator replica, engine = engine pod)",
)

class DaemonScrapePool:
    """map()-style executor whose workers are DAEMON threads. A
    stdlib ThreadPoolExecutor's workers are non-daemon (joined at
    interpreter exit), which for a process-long scrape pool both blocks
    shutdown behind an in-flight scrape timeout and reads as a thread
    leak to the chaos suite's auditor."""

    def __init__(self, max_workers: int = 8, thread_name_prefix: str = "kubeai-scrape"):
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._prefix = thread_name_prefix
        self._n_workers = 0
        self._grow_lock = threading.Lock()
        self.grow_to(max_workers)

    def grow_to(self, max_workers: int) -> None:
        """Ensure at least *max_workers* workers exist (workers never
        die, so this only ever adds). The shared singleton honors the
        LARGEST size any caller asked for instead of silently pinning
        the first caller's."""
        with self._grow_lock:
            for i in range(self._n_workers, max_workers):
                threading.Thread(
                    target=self._worker, name=f"{self._prefix}-{i}", daemon=True
                ).start()
            self._n_workers = max(self._n_workers, max_workers)

    def _worker(self) -> None:
        while True:
            fn, arg, out, idx, done = self._q.get()
            try:
                out[idx] = (True, fn(arg))
            except BaseException as e:  # re-raised on the caller's thread
                out[idx] = (False, e)
            finally:
                done.release()

    def map(self, fn, iterable) -> list:
        """Eager, order-preserving map (the lazy-iterator subtlety of
        Executor.map is not needed by any scrape caller)."""
        items = list(iterable)
        out: list = [None] * len(items)
        done = threading.Semaphore(0)
        for i, item in enumerate(items):
            self._q.put((fn, item, out, i, done))
        for _ in items:
            done.acquire()
        results = []
        for ok, val in out:
            if not ok:
                raise val
            results.append(val)
        return results


_EXECUTOR: DaemonScrapePool | None = None
_EXECUTOR_LOCK = threading.Lock()


def shared_scrape_executor(max_workers: int = 8) -> DaemonScrapePool:
    """The ONE long-lived scrape executor. The old engine_queue_scraper
    built (and tore down) a fresh ThreadPoolExecutor per model per tick;
    every scraping path now shares this pool."""
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = DaemonScrapePool(
                max_workers=max_workers, thread_name_prefix="kubeai-scrape"
            )
        else:
            _EXECUTOR.grow_to(max_workers)
        return _EXECUTOR


def _default_fetch(addr: str, timeout: float) -> str:
    import urllib.request

    url = addr if addr.startswith("http") else f"http://{addr}/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


class FleetCollector:
    """Scrapes every endpoint of the given models once per ``collect()``
    and retains the snapshot so the debug plane reuses the autoscaler's
    tick scrape instead of re-fetching. *fetch* and *clock* are
    injectable for tests."""

    def __init__(self, lb, timeout: float = 2.0, max_workers: int = 8, clock=time.monotonic, fetch=None, default_max_age: float = 15.0):
        self.lb = lb
        self.timeout = timeout
        self.max_workers = max_workers
        # /debug/fleet serves the cached snapshot while younger than
        # this; the manager sets it from the autoscaler interval so the
        # tick's scrape is the steady-state source and dashboard polling
        # can't re-scrape the fleet between ticks.
        self.default_max_age = default_max_age
        self._clock = clock
        self._fetch = fetch or (lambda addr: _default_fetch(addr, self.timeout))
        self._lock = threading.Lock()
        # Serializes whole collects (single-flight): concurrent
        # /debug/fleet GETs on a stale cache must not each launch a
        # fleet scrape, and overlapping collects would write sub-
        # interval token deltas into the tokens/sec derivation.
        self._collect_lock = threading.Lock()
        self._last: dict[str, dict] = {}
        self._last_at: float | None = None
        # addr -> TokenRateWindow over the generated-token counter: the
        # SAME sliding-window implementation backing the engine-side
        # kubeai_engine_tokens_per_second gauge (obs/perf.py), so the
        # two derivations agree by construction — counter resets
        # (engine restart) re-anchor instead of going negative.
        self._prev_tokens: dict[str, TokenRateWindow] = {}
        # addr -> (ttft_sum, ttft_count) from the last collect: the
        # between-collects delta mean is this scrape's latency evidence
        # for the gray-failure scorer. Counter resets (engine restart)
        # re-anchor instead of feeding a negative delta.
        self._prev_ttft: dict[str, tuple[float, float]] = {}
        # addr -> full parsed /metrics page from the last collect — the
        # SLO monitor's remote source (engine histograms live in engine
        # processes; the operator only sees them through these scrapes).
        self._last_pages: dict[str, dict] = {}
        # addr -> last time a collect targeted it. Endpoints leave the
        # fleet silently (scale-down, pod replacement gets a fresh
        # port), so per-addr state must age out or weeks of pod churn
        # grow these dicts — and the SLO monitor's per-tick page scan —
        # without bound.
        self._addr_seen: dict[str, float] = {}
        self.addr_ttl = 600.0
        # model -> phase roles whose per-pool gauge series exist, so a
        # pool that disappears (mode flipped back to unified) has its
        # series REMOVED rather than frozen at the last pre-flip value.
        self._pool_roles: dict[str, set[str]] = {}
        # The operator's HistoryStore (set by the Manager), or None.
        self.history = None

    # -- scraping ----------------------------------------------------------

    def _scrape_one(self, model: str, addr: str) -> dict:
        now = self._clock()
        with self._lock:
            self._addr_seen[addr] = now
        try:
            parsed = parse_prometheus_text(self._fetch(addr))
        except Exception as e:
            M_SCRAPE_FAILURES.inc(labels={"scope": "engine"})
            with self._lock:
                self._last_pages.pop(addr, None)
            return {"address": addr, "ok": False, "error": str(e)[:200]}
        with self._lock:
            self._last_pages[addr] = parsed

        def val(name: str) -> float:
            return sum(v for _, v in parsed.get(name, []))

        prefix_lookup = val(_PREFIX_LOOKUP)
        prefix_cached = val(_PREFIX_CACHED)
        tokens_total = val(_GEN_TOKENS)
        win = self._prev_tokens.get(addr)
        if win is None:
            # span=0 keeps exactly the anchor pair (the previous scrape
            # and this one): rate = delta since the last collect, so an
            # endpoint that goes idle reads 0 on its very next scrape —
            # matching the engine gauge, which resets on idle — instead
            # of decaying an old burst across a longer window.
            win = self._prev_tokens[addr] = TokenRateWindow(span=0.0)
        win.observe_total(tokens_total, now)
        tps = win.rate(now)
        return {
            "address": addr,
            "ok": True,
            "queue_depth": val(_QUEUE),
            "active_slots": val(_ACTIVE),
            "slots_total": val(_SLOTS_TOTAL),
            "pages_used": val(_PAGES_USED),
            "pages_cached": val(_PAGES_CACHED),
            "pages_total": val(_PAGES_TOTAL),
            "tokens_per_second": round(tps, 3),
            "hbm_used_bytes": val(_HBM_USED),
            "hbm_limit_bytes": val(_HBM_LIMIT),
            # Per-replica prefix-cache evidence (ROADMAP item 5b): the
            # hit RATIO, not just the raw hit counter — cumulative, so
            # it reads as "lifetime share of prompt tokens served from
            # shared KV on this replica".
            "prefix_lookup_tokens": prefix_lookup,
            "prefix_cached_tokens": prefix_cached,
            "prefix_hit_ratio": (
                round(prefix_cached / prefix_lookup, 4)
                if prefix_lookup > 0
                else None
            ),
            "kv_cached_evictions": val(_CACHED_EVICTIONS),
            "ttft_sum": val(_TTFT_SUM),
            "ttft_count": val(_TTFT_COUNT),
            # Per-class QoS backlog (qos/): which lanes the
            # queued work sits in — a batch-only backlog is deferrable
            # bulk, an interactive backlog is an SLO emergency.
            "qos_backlog": {
                labels.get("class", ""): v
                for labels, v in parsed.get(_QOS_QUEUE, [])
                if labels.get("class")
            },
        }

    @staticmethod
    def _aggregate(endpoints: list[dict]) -> dict:
        ok = [e for e in endpoints if e["ok"]]
        agg = {
            k: round(sum(e[k] for e in ok), 3)
            for k in (
                "queue_depth", "active_slots", "slots_total", "pages_used",
                "pages_cached", "pages_total", "tokens_per_second",
                "prefix_lookup_tokens", "prefix_cached_tokens",
                "kv_cached_evictions",
            )
        }
        agg["endpoints"] = len(ok)
        agg["failed_endpoints"] = len(endpoints) - len(ok)
        qos: dict[str, float] = {}
        for e in ok:
            for cls, v in (e.get("qos_backlog") or {}).items():
                qos[cls] = round(qos.get(cls, 0.0) + v, 3)
        agg["qos_backlog"] = qos
        agg["prefix_hit_ratio"] = (
            round(agg["prefix_cached_tokens"] / agg["prefix_lookup_tokens"], 4)
            if agg["prefix_lookup_tokens"] > 0
            else None
        )
        agg["free_pages"] = max(agg["pages_total"] - agg["pages_used"], 0.0)
        # Headroom estimate: free slots, bounded by how many more
        # sequences the free KV pages can back at the fleet's observed
        # pages-per-active-request. With no live requests the page bound
        # is unknowable — free slots alone is the estimate.
        free_slots = max(agg["slots_total"] - agg["active_slots"], 0.0)
        if agg["active_slots"] > 0 and agg["pages_used"] > 0:
            pages_per_req = agg["pages_used"] / agg["active_slots"]
            agg["headroom_requests"] = round(
                min(free_slots, agg["free_pages"] / pages_per_req), 1
            )
        else:
            agg["headroom_requests"] = free_slots
        # The autoscaler's engine-load signal: queued + active work.
        agg["load"] = agg["queue_depth"] + agg["active_slots"]
        return agg

    def collect(self, models: list[str]) -> dict[str, dict]:
        """One scrape per endpoint of *models*; returns (and caches)
        model -> {"endpoints": [...], "aggregate": {...}}. Collects are
        serialized — see _collect_lock."""
        with self._collect_lock:
            return self._collect(models)

    def _collect(self, models: list[str]) -> dict[str, dict]:
        jobs = [
            (model, addr)
            for model in models
            for addr in self.lb.get_all_addresses(model)
        ]
        ex = shared_scrape_executor(self.max_workers)
        scraped = list(ex.map(lambda j: (j[0], self._scrape_one(*j)), jobs))
        breaker: dict[str, dict[str, str]] = {}
        snap_fn = getattr(self.lb, "breaker_snapshot", None)
        if callable(snap_fn):
            for model, eps in snap_fn().items():
                breaker[model] = {e["address"]: e["state"] for e in eps}
        # Engine-observed TTFT deltas feed the balancer's latency
        # scorer BEFORE the health snapshot below is taken, so each
        # collect's evidence shows up in the same collect's view.
        observe_fn = getattr(self.lb, "observe_latency", None)
        for model, rec in scraped:
            if not rec.get("ok"):
                continue
            addr = rec["address"]
            cur = (rec.get("ttft_sum", 0.0), rec.get("ttft_count", 0.0))
            prev = self._prev_ttft.get(addr)
            self._prev_ttft[addr] = cur
            if prev is None or not callable(observe_fn):
                continue
            d_sum, d_count = cur[0] - prev[0], cur[1] - prev[1]
            if d_count > 0 and d_sum >= 0:
                try:
                    observe_fn(model, addr, d_sum / d_count, count=int(d_count))
                except Exception:
                    pass  # scoring must never break the scrape path
        # Latency-health view (gray-failure scoring) merged per
        # endpoint like the breaker state. Guarded: fake balancers.
        health: dict[str, dict[str, float]] = {}
        health_fn = getattr(self.lb, "health_snapshot", None)
        if callable(health_fn):
            try:
                for model, snap in health_fn().items():
                    health[model] = {
                        e["address"]: (
                            0.0
                            if e["state"] in ("open", "soft_ejected")
                            else e["effective_weight"]
                        )
                        for e in snap.get("endpoints", [])
                    }
            except Exception:
                health = {}
        # Phase roles (disaggregated pools) per endpoint — "" on
        # unified pods. Guarded: tests wire fake balancers.
        roles_fn = getattr(self.lb, "get_endpoint_roles", None)
        views: dict[str, dict] = {}
        for model in models:
            roles = roles_fn(model) if callable(roles_fn) else {}
            eps = [rec for m, rec in scraped if m == model]
            for e in eps:
                e["breaker_state"] = breaker.get(model, {}).get(e["address"])
                e["role"] = roles.get(e["address"], "")
                e["health_score"] = health.get(model, {}).get(e["address"])
            agg = self._aggregate(eps)
            views[model] = {"endpoints": eps, "aggregate": agg}
            # Role-dimensioned sub-aggregates: the per-pool autoscaling
            # signals AND the /debug/fleet pool view read these.
            role_set = sorted({e["role"] for e in eps if e.get("role")})
            if role_set:
                views[model]["pools"] = {
                    role: self._aggregate([e for e in eps if e["role"] == role])
                    for role in role_set
                }
            labels = {"model": model}
            M_FLEET_ACTIVE.set(agg["active_slots"], labels=labels)
            M_FLEET_QUEUE.set(agg["queue_depth"], labels=labels)
            M_FLEET_FREE_PAGES.set(agg["free_pages"], labels=labels)
            M_FLEET_TPS.set(agg["tokens_per_second"], labels=labels)
            M_FLEET_HEADROOM.set(agg["headroom_requests"], labels=labels)
            M_FLEET_PREFIX_RATIO.set(
                agg["prefix_hit_ratio"] or 0.0, labels=labels
            )
            # Per-pool series (extra `pool` label) so a saturated decode
            # pool is visible even when the prefill pool has headroom.
            for role, pagg in views[model].get("pools", {}).items():
                plabels = {"model": model, "pool": role}
                M_FLEET_ACTIVE.set(pagg["active_slots"], labels=plabels)
                M_FLEET_QUEUE.set(pagg["queue_depth"], labels=plabels)
                M_FLEET_HEADROOM.set(pagg["headroom_requests"], labels=plabels)
            for role in self._pool_roles.get(model, set()) - set(role_set):
                plabels = {"model": model, "pool": role}
                M_FLEET_ACTIVE.remove(labels=plabels)
                M_FLEET_QUEUE.remove(labels=plabels)
                M_FLEET_HEADROOM.remove(labels=plabels)
            self._pool_roles[model] = set(role_set)
        with self._lock:
            self._last = views
            self._last_at = self._clock()
            # Age out per-addr state for endpoints no collect has
            # targeted within the TTL (they left the fleet).
            cutoff = self._last_at - self.addr_ttl
            for addr in [a for a, t in self._addr_seen.items() if t < cutoff]:
                self._addr_seen.pop(addr, None)
                self._prev_tokens.pop(addr, None)
                self._prev_ttft.pop(addr, None)
                self._last_pages.pop(addr, None)
        if self.history is not None:
            try:
                self.history.record_fleet(views)
            except Exception:
                pass  # a history sink's fault must never break the scrape
        return views

    # -- consumers ---------------------------------------------------------

    def scrape_model(self, model: str) -> float:
        """Legacy engine_queue_scrape-shaped entry point: the model's
        queued + active engine work (fresh scrape)."""
        view = self.collect([model]).get(model)
        return float(view["aggregate"]["load"]) if view else 0.0

    def parsed_pages(self) -> list[dict]:
        """The last collect's fully parsed /metrics pages (one per
        reachable endpoint) — the SLOMonitor's remote metric source.
        Cumulative engine counters reset when a pod restarts; the
        monitor clamps negative window deltas to zero, so a restart
        reads as a brief dip in window volume, not as garbage."""
        with self._lock:
            return list(self._last_pages.values())

    def parsed_pages_by_addr(self) -> dict[str, dict]:
        """Same pages keyed by endpoint address — for consumers that
        difference counters PER SOURCE (the incident recorder's watch):
        an endpoint whose scrape failed for one tick and then recovered
        must be recognized as the same source, or its whole cumulative
        history reads as a one-interval spike."""
        with self._lock:
            return dict(self._last_pages)

    def debug_view(self, models: list[str], max_age: float | None = None) -> dict:
        """The /debug/fleet payload. Reuses the last collect when it is
        fresher than *max_age* (default: the collector's configured age,
        sized to the autoscaler interval so the leader's tick scrape is
        the steady-state source); re-collects otherwise. On non-leader
        replicas (no tick warming the cache) the GET itself refreshes —
        still bounded to one fleet scrape per *max_age* per replica,
        however fast dashboards poll."""
        max_age = self.default_max_age if max_age is None else max_age

        def fresh_snapshot():
            with self._lock:
                last, last_at = self._last, self._last_at
            now = self._clock()
            if (
                last_at is not None
                and now - last_at <= max_age
                and set(models) <= set(last)
            ):
                return now, last_at, last
            return now, last_at, None

        now, last_at, last = fresh_snapshot()
        if last is None:
            with self._collect_lock:
                # Single-flight: a concurrent caller may have refreshed
                # while we waited for the lock — re-check before scraping.
                now, last_at, last = fresh_snapshot()
                if last is None:
                    last = self._collect(models)
                    last_at = now
        return {
            "age_seconds": round(max(now - last_at, 0.0), 3),
            "models": {m: last[m] for m in models if m in last},
        }
