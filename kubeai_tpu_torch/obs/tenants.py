"""Per-tenant usage metering and cost attribution (port of the engine's
side of kubeai_tpu/obs/tenants.py).

- **Identity.** The proxy hashes a tenant id from the caller's
  credentials and stamps it on ``X-KubeAI-Tenant``; the engine takes it
  as given (``sanitize_tenant`` keeps it to a safe charset). Requests
  without one are un-attributed.
- **Metering** (``TenantAccountant``): a bounded top-K space-saving
  sketch. At most *topk* tenants are tracked exactly; when a new one
  arrives at capacity, the tracked tenant of least weight is folded into
  the ``__other__`` bucket (its series removed, its sums added to
  ``__other__``'s, so every global sum is conserved) and the newcomer
  inherits its weight. ``anonymous`` and ``__other__`` are permanent, so
  the ``tenant`` label has at most topk + 2 values. Every series that
  carries a ``tenant`` label is registered here and written only by the
  accountant.
- **Detection.** A rolling window of cumulative snapshots gives each
  tenant's request share, req/s, tokens, p95 e2e and TTFT/e2e attainment.
  A tenant whose share reaches ``KUBEAI_TENANT_FLOOD_SHARE`` (0.5) with
  at least ``KUBEAI_TENANT_FLOOD_MIN`` (20) window requests publishes a
  ``tenant_flood`` trigger (obs/incidents.py).

Cost proxies: the engine's scheduler calls ``record_cost`` once per
request at slot release with the slot-seconds (wall time the request held
a decode slot) and the KV-page-seconds (slot-seconds x pages reserved).
An engine process has no terminal proxy accounting, so its report holds
cost rows: ``requests.total`` stays 0 there, and the sketch weight counts
the records.

Surface: ``GET /debug/tenants`` and the seven ``kubeai_tenant_*`` series.
Knobs: ``KUBEAI_TENANT_TOPK`` (32), ``KUBEAI_TENANT_WINDOW_SECONDS`` (60),
``KUBEAI_TENANT_FLOOD_SHARE`` (0.5), ``KUBEAI_TENANT_FLOOD_MIN`` (20),
and the thresholds ``KUBEAI_SLO_TTFT_SECONDS`` (2) and
``KUBEAI_SLO_E2E_SECONDS`` (30).

Left out, because the JAX proxy stays the front end: ``RequestMeter``
(the proxy's per-request usage meter), ``extract_tenant`` and
``hash_tenant_key`` (its identity from credentials) and the canary
header.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from bisect import bisect_left
from collections import deque

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.obs.incidents import publish_trigger

log = logging.getLogger("kubeai_tpu_torch.tenants")

# The proxy's hashed tenant id rides this header (it strips client copies).
TENANT_HEADER = "X-KubeAI-Tenant"
ANONYMOUS = "anonymous"
OTHER = "__other__"

# Tenant ids land in metric labels and debug payloads: a safe charset and
# a bounded length (the proxy's hashes are 16 hex characters).
_TENANT_RE = re.compile(r"[^A-Za-z0-9._\-]")


def sanitize_tenant(t: str) -> str:
    return _TENANT_RE.sub("", str(t))[:64]


# ---------------------------------------------------------------------------
# Metrics: every series with a `tenant` label, written only under the
# accountant's lock.

M_T_REQUESTS = default_registry.counter(
    "kubeai_tenant_requests_total",
    "terminal proxied requests by tenant and outcome (ok|error|cancelled); "
    "cardinality bounded by the top-K accountant (evicted tenants fold "
    "into __other__)",
)
M_T_TOKENS = default_registry.counter(
    "kubeai_tenant_tokens_total",
    "prompt/completion tokens consumed per tenant (kind=prompt|completion), "
    "from response usage blocks; sums are conserved across top-K evictions",
)
M_T_SLOT_SECONDS = default_registry.counter(
    "kubeai_tenant_slot_seconds_total",
    "decode-slot occupancy seconds per tenant (engine-side cost proxy: "
    "wall time the tenant's requests held a decode slot)",
)
M_T_PAGE_SECONDS = default_registry.counter(
    "kubeai_tenant_kv_page_seconds_total",
    "KV-page occupancy seconds per tenant (engine-side cost proxy: "
    "slot-seconds x pages reserved for the request)",
)
M_T_SHARE = default_registry.gauge(
    "kubeai_tenant_share",
    "fraction of rolling-window requests attributed to each tenant "
    "(the tenant_flood trigger's input)",
)
M_T_TRACKED = default_registry.gauge(
    "kubeai_tenant_tracked",
    "tenants currently tracked exactly by the top-K accountant "
    "(excludes the __other__ overflow bucket)",
)
M_T_EVICTIONS = default_registry.counter(
    "kubeai_tenant_evictions_total",
    "tenants folded into __other__ by top-K pressure (high rate = long "
    "tail of distinct keys; raise KUBEAI_TENANT_TOPK if rankings matter)",
)

# Bounds of the per-tenant latency buckets (not exported): they hold the
# default TTFT (2 s) and e2e (30 s) objectives exactly.
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0)


class _TenantStats:
    """One tenant's sums since it was tracked. `weight` is the sketch
    count (inherited on eviction), used only to rank evictions."""

    __slots__ = (
        "weight", "requests", "outcomes", "prompt_tokens",
        "completion_tokens", "slot_seconds", "page_seconds",
        "e2e_buckets", "e2e_count", "ttft_buckets", "ttft_count",
        "first_seen", "last_seen", "seq",
    )

    def __init__(self, weight: float = 0.0, now: float = 0.0, seq: int = 0):
        self.seq = seq  # admission order (eviction tie-break)
        self.weight = weight
        self.requests = 0
        self.outcomes: dict[str, int] = {}
        self.prompt_tokens = 0
        self.completion_tokens = 0
        self.slot_seconds = 0.0
        self.page_seconds = 0.0
        self.e2e_buckets = [0] * (len(LATENCY_BUCKETS) + 1)
        self.e2e_count = 0
        self.ttft_buckets = [0] * (len(LATENCY_BUCKETS) + 1)
        self.ttft_count = 0
        self.first_seen = now
        self.last_seen = now

    def fold_from(self, other: "_TenantStats") -> None:
        """Add *other*'s sums to this bucket's (an eviction into
        __other__)."""
        self.requests += other.requests
        for k, v in other.outcomes.items():
            self.outcomes[k] = self.outcomes.get(k, 0) + v
        self.prompt_tokens += other.prompt_tokens
        self.completion_tokens += other.completion_tokens
        self.slot_seconds += other.slot_seconds
        self.page_seconds += other.page_seconds
        for i, v in enumerate(other.e2e_buckets):
            self.e2e_buckets[i] += v
        self.e2e_count += other.e2e_count
        for i, v in enumerate(other.ttft_buckets):
            self.ttft_buckets[i] += v
        self.ttft_count += other.ttft_count

    def window_key(self) -> tuple:
        """The cumulative state the rolling window differences."""
        return (
            self.requests, self.prompt_tokens, self.completion_tokens,
            tuple(self.e2e_buckets), self.e2e_count,
            tuple(self.ttft_buckets), self.ttft_count,
        )


def _key_add(a: tuple, b: tuple) -> tuple:
    """Elementwise sum of two window_key tuples."""
    return (
        a[0] + b[0], a[1] + b[1], a[2] + b[2],
        tuple(x + y for x, y in zip(a[3], b[3])), a[4] + b[4],
        tuple(x + y for x, y in zip(a[5], b[5])), a[6] + b[6],
    )


def _bucket_observe(buckets: list[int], value: float) -> None:
    buckets[bisect_left(LATENCY_BUCKETS, value)] += 1


def _bucket_p95(deltas: list[float], count: float) -> float | None:
    """Upper-bound p95 from non-cumulative bucket deltas (None with no
    samples; the +Inf slot reports the largest finite bound)."""
    if count <= 0:
        return None
    target = 0.95 * count
    cum = 0.0
    for i, c in enumerate(deltas):
        cum += c
        if cum >= target:
            return LATENCY_BUCKETS[min(i, len(LATENCY_BUCKETS) - 1)]
    return LATENCY_BUCKETS[-1]


def _bucket_attainment(deltas: list[float], count: float, threshold_s: float) -> float | None:
    """Fraction of window samples at or under *threshold_s*, taken at the
    smallest bucket bound >= the threshold."""
    if count <= 0:
        return None
    k = min(bisect_left(LATENCY_BUCKETS, threshold_s), len(LATENCY_BUCKETS) - 1)
    return min(sum(deltas[: k + 1]) / count, 1.0)


class TenantAccountant:
    """Top-K space-saving sketch over tenant ids, cumulative sums and
    latency buckets per tracked tenant, a rolling snapshot window for
    shares and attainment, and the ``tenant_flood`` trigger.

    Thread-safe; `clock` is injectable for tests. With *auto_tick* the
    window ticker starts at the first recorded request (the module's
    ``default_accountant`` runs so); a test's accountant with an injected
    clock leaves it off and calls ``tick()`` itself.
    """

    def __init__(
        self,
        topk: int | None = None,
        window_seconds: float | None = None,
        interval_seconds: float | None = None,
        flood_share: float | None = None,
        flood_min: float | None = None,
        clock=time.monotonic,
        auto_tick: bool = False,
    ):
        self.auto_tick = auto_tick
        self.topk = max(int(topk if topk is not None else env_float("KUBEAI_TENANT_TOPK", 32)), 1)
        self.window = (window_seconds if window_seconds is not None
                       else env_float("KUBEAI_TENANT_WINDOW_SECONDS", 60.0))
        self.interval = (interval_seconds if interval_seconds is not None
                         else max(min(self.window / 6.0, 10.0), 1.0))
        self.flood_share = (flood_share if flood_share is not None
                            else env_float("KUBEAI_TENANT_FLOOD_SHARE", 0.5))
        self.flood_min = (flood_min if flood_min is not None
                          else env_float("KUBEAI_TENANT_FLOOD_MIN", 20.0))
        self.ttft_threshold_s = env_float("KUBEAI_SLO_TTFT_SECONDS", 2.0)
        self.e2e_threshold_s = env_float("KUBEAI_SLO_E2E_SECONDS", 30.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._tracked: dict[str, _TenantStats] = {}
        self._other = _TenantStats()
        self._admit_seq = 0
        self._evictions = 0
        self._canary_excluded = 0
        # (t, {tenant: window_key}) cumulative snapshots; entry 0 is the
        # window's baseline. An empty baseline is seeded now, so the first
        # tick reports real deltas.
        self._snaps: deque[tuple[float, dict[str, tuple]]] = deque()
        self._snaps.append((self._clock(), {}))
        self._shares: dict[str, float] = {}
        self._window_state: dict[str, dict] = {}
        self._last_flood: dict | None = None
        self._ticker: threading.Thread | None = None
        self._ticker_lock = threading.Lock()
        self._stop_evt = threading.Event()

    # -- sketch ------------------------------------------------------------

    def _ensure(self, tenant: str) -> tuple[str, _TenantStats]:
        """*tenant*'s stats bucket (the lock held): tracked, newly tracked
        (evicting the tenant of least weight into __other__ at capacity),
        or __other__ itself."""
        tenant = sanitize_tenant(tenant) or ANONYMOUS
        if tenant == OTHER:
            return OTHER, self._other
        st = self._tracked.get(tenant)
        if st is not None:
            return tenant, st
        now = self._clock()
        # anonymous takes no top-K place: it must always be addressable.
        occupied = len(self._tracked) - (1 if ANONYMOUS in self._tracked else 0)
        self._admit_seq += 1
        if tenant == ANONYMOUS or occupied < self.topk:
            st = _TenantStats(now=now, seq=self._admit_seq)
            self._tracked[tenant] = st
            M_T_TRACKED.set(len(self._tracked))
            return tenant, st
        # At capacity: evict the least weight (never anonymous); a tie
        # evicts the newest admission, so an established tenant stays.
        candidates = [t for t in self._tracked if t != ANONYMOUS]
        if not candidates:
            return OTHER, self._other
        victim = min(candidates,
                     key=lambda t: (self._tracked[t].weight, -self._tracked[t].seq))
        vst = self._tracked.pop(victim)
        self._fold_into_other(victim, vst)
        st = _TenantStats(weight=vst.weight, now=now, seq=self._admit_seq)
        self._tracked[tenant] = st
        self._evictions += 1
        M_T_EVICTIONS.inc()
        M_T_TRACKED.set(len(self._tracked))
        return tenant, st

    def _fold_into_other(self, victim: str, vst: _TenantStats) -> None:
        """Move the victim's sums and exported series into __other__."""
        self._other.fold_from(vst)
        # The fold raised __other__'s cumulative state by the victim's
        # lifetime sums: shift every retained snapshot's __other__
        # baseline by as much, so the next tick does not read that
        # lifetime as window traffic; the victim's own entries go, so a
        # later re-admission is measured afresh.
        vkey = vst.window_key()
        zero = _TenantStats().window_key()
        for _, snap in self._snaps:
            snap[OTHER] = _key_add(snap.get(OTHER, zero), vkey)
            snap.pop(victim, None)
        for outcome, n in vst.outcomes.items():
            M_T_REQUESTS.remove({"tenant": victim, "outcome": outcome})
            if n:
                M_T_REQUESTS.inc(n, labels={"tenant": OTHER, "outcome": outcome})
        for kind, n in (("prompt", vst.prompt_tokens), ("completion", vst.completion_tokens)):
            M_T_TOKENS.remove({"tenant": victim, "kind": kind})
            if n:
                M_T_TOKENS.inc(n, labels={"tenant": OTHER, "kind": kind})
        M_T_SLOT_SECONDS.remove({"tenant": victim})
        if vst.slot_seconds:
            M_T_SLOT_SECONDS.inc(vst.slot_seconds, labels={"tenant": OTHER})
        M_T_PAGE_SECONDS.remove({"tenant": victim})
        if vst.page_seconds:
            M_T_PAGE_SECONDS.inc(vst.page_seconds, labels={"tenant": OTHER})
        M_T_SHARE.remove({"tenant": victim})
        self._shares.pop(victim, None)
        self._window_state.pop(victim, None)

    # -- recording ---------------------------------------------------------

    def record_request(self, tenant: str, outcome: str, e2e_s: float,
                       ttft_s: float | None = None, prompt_tokens: int = 0,
                       completion_tokens: int = 0, canary: bool = False) -> None:
        """Terminal accounting of one request (a few dict updates under
        one lock). Canary probes are counted apart and nowhere else."""
        if canary:
            with self._lock:
                self._canary_excluded += 1
            return
        with self._lock:
            name, st = self._ensure(tenant)
            st.weight += 1
            st.requests += 1
            st.outcomes[outcome] = st.outcomes.get(outcome, 0) + 1
            st.prompt_tokens += prompt_tokens
            st.completion_tokens += completion_tokens
            st.last_seen = self._clock()
            _bucket_observe(st.e2e_buckets, e2e_s)
            st.e2e_count += 1
            if ttft_s is not None:
                _bucket_observe(st.ttft_buckets, ttft_s)
                st.ttft_count += 1
            M_T_REQUESTS.inc(labels={"tenant": name, "outcome": outcome})
            if prompt_tokens:
                M_T_TOKENS.inc(prompt_tokens, labels={"tenant": name, "kind": "prompt"})
            if completion_tokens:
                M_T_TOKENS.inc(completion_tokens, labels={"tenant": name, "kind": "completion"})
        self._ensure_ticker()

    def record_cost(self, tenant: str, slot_seconds: float, page_seconds: float) -> None:
        """The scheduler's record at slot release: the wall time the slot
        was held, and that time x the KV pages reserved. One lock and a
        few float adds."""
        if not tenant:
            return  # un-attributed direct submits
        with self._lock:
            name, st = self._ensure(tenant)
            st.weight += 1
            st.slot_seconds += slot_seconds
            st.page_seconds += page_seconds
            st.last_seen = self._clock()
            M_T_SLOT_SECONDS.inc(slot_seconds, labels={"tenant": name})
            M_T_PAGE_SECONDS.inc(page_seconds, labels={"tenant": name})

    # -- rolling window ----------------------------------------------------

    def tick(self) -> None:
        """Push one cumulative snapshot, difference it against the
        window's baseline, refresh the shares and detect floods. The
        trigger publishes outside the lock."""
        now = self._clock()
        floods: list[dict] = []
        with self._lock:
            snap = {t: st.window_key() for t, st in self._tracked.items()}
            snap[OTHER] = self._other.window_key()
            self._snaps.append((now, snap))
            while len(self._snaps) >= 2 and self._snaps[1][0] <= now - self.window:
                self._snaps.popleft()
            base_t, base = self._snaps[0]
            span = max(now - base_t, 1e-9)
            zero = _TenantStats().window_key()
            total_req = 0.0
            deltas: dict[str, dict] = {}
            for t, cur in snap.items():
                b = base.get(t, zero)
                req_d = max(cur[0] - b[0], 0)
                deltas[t] = {
                    "requests": req_d,
                    "prompt_tokens": max(cur[1] - b[1], 0),
                    "completion_tokens": max(cur[2] - b[2], 0),
                    "e2e_deltas": [max(c - x, 0) for c, x in zip(cur[3], b[3])],
                    "e2e_count": max(cur[4] - b[4], 0),
                    "ttft_deltas": [max(c - x, 0) for c, x in zip(cur[5], b[5])],
                    "ttft_count": max(cur[6] - b[6], 0),
                }
                total_req += req_d
            state: dict[str, dict] = {}
            for t, d in deltas.items():
                share = d["requests"] / total_req if total_req > 0 else 0.0
                state[t] = {
                    "window_requests": d["requests"],
                    "requests_per_second": round(d["requests"] / span, 4),
                    "share": round(share, 4),
                    "window_prompt_tokens": d["prompt_tokens"],
                    "window_completion_tokens": d["completion_tokens"],
                    "e2e_p95_s": _bucket_p95(d["e2e_deltas"], d["e2e_count"]),
                    "e2e_attainment": _bucket_attainment(
                        d["e2e_deltas"], d["e2e_count"], self.e2e_threshold_s),
                    "ttft_p95_s": _bucket_p95(d["ttft_deltas"], d["ttft_count"]),
                    "ttft_attainment": _bucket_attainment(
                        d["ttft_deltas"], d["ttft_count"], self.ttft_threshold_s),
                }
            # A departed tenant's share series goes; it must not freeze.
            for t in list(self._shares):
                if t not in state:
                    M_T_SHARE.remove({"tenant": t})
                    del self._shares[t]
            for t, s in state.items():
                M_T_SHARE.set(s["share"], labels={"tenant": t})
                self._shares[t] = s["share"]
            self._window_state = state
            # A flood is one identified tenant: __other__ and anonymous are
            # mixtures of many callers and are never named.
            if total_req >= self.flood_min:
                for t, s in state.items():
                    if t in (OTHER, ANONYMOUS):
                        continue
                    if s["share"] >= self.flood_share:
                        floods.append({
                            "tenant": t,
                            "share": s["share"],
                            "window_requests": s["window_requests"],
                            "window_seconds": round(span, 3),
                            "threshold": self.flood_share,
                        })
            if floods:
                self._last_flood = dict(floods[0], at=time.time())
        for f in floods:
            publish_trigger("tenant_flood", detail=f, key=f["tenant"])

    # -- report ------------------------------------------------------------

    def report(self) -> dict:
        """The /debug/tenants payload: per-tenant window and cumulative
        accounting, ranked by window requests."""
        with self._lock:
            rows = []
            for t, st in list(self._tracked.items()) + [(OTHER, self._other)]:
                if st.requests == 0 and st.slot_seconds == 0.0:
                    continue
                w = self._window_state.get(t, {})
                rows.append({
                    "tenant": t,
                    "requests": {
                        "total": st.requests,
                        "window": w.get("window_requests", 0),
                        "per_second": w.get("requests_per_second", 0.0),
                    },
                    "share": w.get("share", 0.0),
                    "outcomes": dict(st.outcomes),
                    "tokens": {
                        "prompt": st.prompt_tokens,
                        "completion": st.completion_tokens,
                        "window_prompt": w.get("window_prompt_tokens", 0),
                        "window_completion": w.get("window_completion_tokens", 0),
                    },
                    "latency": {
                        "e2e_p95_s": w.get("e2e_p95_s"),
                        "e2e_attainment": w.get("e2e_attainment"),
                        "ttft_p95_s": w.get("ttft_p95_s"),
                        "ttft_attainment": w.get("ttft_attainment"),
                    },
                    "cost": {
                        "slot_seconds": round(st.slot_seconds, 4),
                        "kv_page_seconds": round(st.page_seconds, 4),
                    },
                })
            rows.sort(key=lambda r: (r["requests"]["window"], r["requests"]["total"]),
                      reverse=True)
            for i, r in enumerate(rows):
                r["rank"] = i + 1
            return {
                "window_seconds": self.window,
                "interval_seconds": self.interval,
                "topk": self.topk,
                "tracked": len(self._tracked),
                "evictions": self._evictions,
                "canary_excluded": self._canary_excluded,
                "thresholds": {"ttft_s": self.ttft_threshold_s, "e2e_s": self.e2e_threshold_s},
                "flood": {
                    "share_threshold": self.flood_share,
                    "min_window_requests": self.flood_min,
                    "last": self._last_flood,
                },
                "tenants": rows,
            }

    def totals(self) -> dict:
        """Sums over every tenant (tracked and __other__)."""
        with self._lock:
            allst = list(self._tracked.values()) + [self._other]
            return {
                "requests": sum(s.requests for s in allst),
                "prompt_tokens": sum(s.prompt_tokens for s in allst),
                "completion_tokens": sum(s.completion_tokens for s in allst),
                "slot_seconds": sum(s.slot_seconds for s in allst),
                "kv_page_seconds": sum(s.page_seconds for s in allst),
            }

    # -- lifecycle ---------------------------------------------------------

    def _ensure_ticker(self) -> None:
        if not self.auto_tick:
            return
        if self._ticker is not None and self._ticker.is_alive():
            return
        with self._ticker_lock:
            if self._ticker is not None and self._ticker.is_alive():
                return
            self._stop_evt.clear()
            self._ticker = threading.Thread(target=self._loop, name="tenant-accountant",
                                            daemon=True)
            self._ticker.start()

    def stop(self) -> None:
        self._stop_evt.set()

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval):
            try:
                self.tick()
            except Exception:
                log.exception("tenant accountant tick failed")

    def reset(self) -> None:
        """Drop all state and the exported kubeai_tenant_* series (test
        isolation of the process-global accountant)."""
        with self._lock:
            for t, st in list(self._tracked.items()) + [(OTHER, self._other)]:
                for outcome in st.outcomes:
                    M_T_REQUESTS.remove({"tenant": t, "outcome": outcome})
                for kind in ("prompt", "completion"):
                    M_T_TOKENS.remove({"tenant": t, "kind": kind})
                M_T_SLOT_SECONDS.remove({"tenant": t})
                M_T_PAGE_SECONDS.remove({"tenant": t})
                M_T_SHARE.remove({"tenant": t})
            self._tracked.clear()
            self._other = _TenantStats()
            self._snaps.clear()
            # Seed the empty baseline again, or the first tick after the
            # reset would hide every request before it.
            self._snaps.append((self._clock(), {}))
            self._shares.clear()
            self._window_state.clear()
            self._evictions = 0
            self._canary_excluded = 0
            self._last_flood = None
            M_T_TRACKED.set(0)


default_accountant = TenantAccountant(auto_tick=True)


def handle_tenant_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    """``GET /debug/tenants``: the default accountant's report."""
    if path != "/debug/tenants":
        return None
    return 200, "application/json", json.dumps(default_accountant.report()).encode()
