"""Synthetic canary prober (port of kubeai_tpu/obs/canary.py): a per-model,
low-rate, deterministic probe through the real serving path (proxy ->
balancer -> engine), so "is this model actually serving correct tokens
right now" is answered by measurement instead of inferred from gauge
absence.

Probe discipline:

- **Deterministic** — ``temperature: 0`` with a fixed seed and a tiny
  ``max_tokens``, streamed. The first healthy probe's output fingerprint
  (sha256 of the concatenated token text) becomes the model's baseline;
  any later mismatch is flagged ``corrupt`` — the silent-corruption
  class (wrong weights attached, desynced gang rank, KV aliasing) that
  no error-rate metric can see, because the request *succeeds*.
- **Never wakes a sleeping model** — a model with zero endpoints is
  skipped entirely (scale-from-zero is the model's contract; a canary
  that kept it warm would silently delete the feature).
- **Leader-gated** — one prober per fleet; follower replicas idle with
  ``active: false`` in /debug/canary, exactly like the SLO monitor.
- **Feeds the incident bus** — ``canary_error`` / ``canary_corrupt``
  triggers (obs/incidents.py), so a failing probe doesn't just move a
  counter: an installed recorder captures the cross-layer snapshot.

Metrics: ``kubeai_canary_probes_total{outcome=ok|error|corrupt}``,
``kubeai_canary_ttft_seconds``, ``kubeai_canary_e2e_seconds``. Surface:
``GET /debug/canary``. Knobs: ``KUBEAI_CANARY`` (=0 disables),
``KUBEAI_CANARY_INTERVAL`` (s, default 30), ``KUBEAI_CANARY_MAX_TOKENS``
(default 4), ``KUBEAI_CANARY_TIMEOUT`` (s, default 15).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.obs.incidents import publish_trigger
from kubeai_tpu_torch.proxy.recovery import sse_events

log = logging.getLogger("kubeai_tpu_torch.canary")

M_PROBES = default_registry.counter(
    "kubeai_canary_probes_total",
    "synthetic canary probes by outcome (ok | error | corrupt — corrupt = "
    "deterministic output no longer matches the model's fingerprint baseline)",
)
M_TTFT = default_registry.histogram(
    "kubeai_canary_ttft_seconds",
    "canary probe time to first streamed byte through the full proxy->engine path",
)
M_E2E = default_registry.histogram(
    "kubeai_canary_e2e_seconds",
    "canary probe end-to-end latency (stream exhausted)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30),
)

CANARY_SEED = 20240804


def canary_enabled() -> bool:
    return os.environ.get("KUBEAI_CANARY", "1") not in ("0", "false", "no")


class CanaryProber:
    """*proxy* is a ModelProxy (probes ride the real handle() path:
    routing strategy, breaker feedback, replay, deadline budget — a
    canary that bypassed any of it would prove the wrong pipeline);
    *election* is duck-typed (``is_leader`` Event, None = always
    leader); *clock* is injectable for tests."""

    def __init__(
        self,
        proxy,
        model_client,
        lb,
        interval_seconds: float | None = None,
        max_tokens: int | None = None,
        timeout_seconds: float | None = None,
        prompt: str = "kubeai canary: count 1 2 3",
        election=None,
        clock=time.monotonic,
        wall=time.time,
        enabled: bool | None = None,
    ):
        self.proxy = proxy
        self.model_client = model_client
        self.lb = lb
        self.interval = (
            interval_seconds
            if interval_seconds is not None
            else env_float("KUBEAI_CANARY_INTERVAL", 30.0)
        )
        self.max_tokens = (
            max_tokens
            if max_tokens is not None
            else int(env_float("KUBEAI_CANARY_MAX_TOKENS", 4))
        )
        self.timeout = (
            timeout_seconds
            if timeout_seconds is not None
            else env_float("KUBEAI_CANARY_TIMEOUT", 15.0)
        )
        self.prompt = prompt
        self.enabled = canary_enabled() if enabled is None else enabled
        self._election = election
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        # model -> last probe record; model -> fingerprint baseline;
        # model -> deployment key the baseline was pinned against.
        self._state: dict[str, dict] = {}
        self._fingerprints: dict[str, str] = {}
        self._deploy_keys: dict[str, str] = {}
        self._probes = 0
        self._running = False
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

    # -- probing -----------------------------------------------------------

    def _leading(self) -> bool:
        return self._election is None or self._election.is_leader.is_set()

    @staticmethod
    def _parse_stream(raw: bytes) -> tuple[str, bool]:
        """(concatenated token text, saw [DONE]) from an SSE body.
        Framing delegates to recovery.sse_events — the repo's ONE SSE
        rule (CRLF endings, unterminated-tail discard); only the JSON
        extraction lives here, so an edge-case fix in the replay path
        can never diverge from what the fingerprint is computed over."""
        chunks = iter((raw, b""))
        text = []
        done = False
        for event in sse_events(lambda: next(chunks)):
            if not event.startswith(b"data:"):
                continue
            payload = event[5:].strip()
            if payload == b"[DONE]":
                done = True
                continue
            try:
                choice = json.loads(payload)["choices"][0]
            except (ValueError, KeyError, IndexError, TypeError):
                # TypeError included: a third-party engine's keepalive
                # (`data: null`, `data: "ping"`) parses but isn't a
                # dict — it must be skipped like malformed JSON, not
                # abort the probe with no recorded outcome.
                continue
            text.append(choice.get("text") or "")
            if choice.get("finish_reason"):
                text.append(f"<{choice['finish_reason']}>")
        return "".join(text), done

    def probe_model(self, model_name: str) -> dict:
        """Run ONE deterministic probe against *model_name* and return
        the probe record (also retained for /debug/canary). Zero
        endpoints = skipped: the probe must never be the thing that
        wakes a scaled-to-zero model."""
        with self._lock:
            # Under the lock: tick() fans probes out across the shared
            # scrape pool, and the id must stay unique per probe.
            self._probes += 1
            n = self._probes
        rec: dict = {"model": model_name, "t": self._wall(), "n": n}
        if not self.lb.get_all_addresses(model_name):
            rec.update(outcome="skipped", reason="no endpoints (scaled to zero)")
            with self._lock:
                self._state[model_name] = rec
            return rec
        body = json.dumps(
            {
                "model": model_name,
                "prompt": self.prompt,
                "max_tokens": self.max_tokens,
                "temperature": 0,
                "seed": CANARY_SEED,
                "stream": True,
            }
        ).encode()
        headers = {
            "Content-Type": "application/json",
            "X-Request-ID": f"canary-{model_name}-{n}",
            # Tenant-accounting exclusion marker: synthetic probes must
            # not skew per-tenant shares or trip the flood trigger
            # (obs/tenants.py skips canary-marked requests end to end).
            "X-KubeAI-Canary": "1",
            # One bounded budget across await/connect/stream: a hung
            # engine becomes a probe ERROR, not a hung prober thread.
            "X-Request-Timeout": f"{self.timeout:.3f}",
        }
        t0 = self._clock()
        ttft = None
        chunks: list[bytes] = []
        try:
            result = self.proxy.handle(body, "/openai/v1/completions", headers)
            try:
                if result.status != 200:
                    raise RuntimeError(f"upstream status {result.status}")
                for chunk in result.body_iter:
                    if ttft is None and chunk:
                        ttft = self._clock() - t0
                    chunks.append(chunk)
            finally:
                result.body_iter.close()
        except Exception as e:
            rec.update(outcome="error", error=str(e)[:300])
            M_PROBES.inc(labels={"outcome": "error"})
            publish_trigger(
                "canary_error", model=model_name,
                detail={"error": str(e)[:300], "probe": n},
            )
            with self._lock:
                self._state[model_name] = rec
            return rec
        e2e = self._clock() - t0
        text, saw_done = self._parse_stream(b"".join(chunks))
        fp = hashlib.sha256(text.encode()).hexdigest()[:16]
        rec.update(
            e2e_s=round(e2e, 4),
            ttft_s=round(ttft, 4) if ttft is not None else None,
            text=text[:120],
            fingerprint=fp,
            stream_complete=saw_done,
        )
        if not saw_done:
            # A 200 stream that ended without [DONE] is a truncated
            # probe, not a measurement: it must neither pin nor be
            # judged against the fingerprint baseline — a bad first
            # probe would otherwise poison every later healthy one
            # into a permanent false "corrupt".
            rec["outcome"] = "error"
            rec["error"] = "stream truncated (no [DONE] terminator)"
            M_PROBES.inc(labels={"outcome": "error"})
            publish_trigger(
                "canary_error", model=model_name,
                detail={"error": rec["error"], "probe": n},
            )
            with self._lock:
                self._state[model_name] = rec
            return rec
        with self._lock:
            baseline = self._fingerprints.get(model_name)
            if baseline is None:
                # First healthy probe pins the baseline; tick() drops it
                # when the model's deployment identity changes (rollout,
                # delete+recreate), so its lifetime matches the
                # deployment's, not the operator process's.
                self._fingerprints[model_name] = fp
                baseline = fp
        rec["baseline"] = baseline
        if fp != baseline:
            rec["outcome"] = "corrupt"
            M_PROBES.inc(labels={"outcome": "corrupt"})
            publish_trigger(
                "canary_corrupt", model=model_name,
                detail={
                    "fingerprint": fp, "baseline": baseline,
                    "text": text[:120],
                },
            )
            log.warning(
                "canary CORRUPT for %s: fingerprint %s != baseline %s (%r)",
                model_name, fp, baseline, text[:80],
            )
        else:
            rec["outcome"] = "ok"
            M_PROBES.inc(labels={"outcome": "ok"})
            if ttft is not None:
                M_TTFT.observe(ttft)
            M_E2E.observe(e2e)
        with self._lock:
            self._state[model_name] = rec
        return rec

    @staticmethod
    def _deploy_key(model) -> str:
        """Fingerprint of the OUTPUT-AFFECTING deployment identity: uid
        (delete+recreate under the same name is a new deployment, even
        between two ticks) plus every spec field that changes what the
        deterministic probe can emit — weights url, engine, args, env,
        adapters. Replica/autoscaling churn deliberately excluded: a
        scale event must not drop corruption-detection coverage."""
        s = model.spec
        ident = json.dumps(
            [
                model.meta.uid, s.url, s.engine, list(s.args),
                sorted(s.env.items()),
                sorted((a.name, a.url) for a in s.adapters),
            ],
            separators=(",", ":"),
        )
        return hashlib.sha256(ident.encode()).hexdigest()[:16]

    def tick(self) -> None:
        """Probe every model once (leader-gated by the loop; callable
        directly in tests/the drill). Models that vanished are pruned so
        /debug/canary doesn't accrete ghosts; a model whose deployment
        identity changed (rollout, recreate) gets its fingerprint
        baseline dropped BEFORE the probe — new weights legitimately
        change the deterministic output, and a stale baseline would
        read every later healthy probe as a permanent false 'corrupt'."""
        try:
            models = {
                m.meta.name: self._deploy_key(m)
                for m in self.model_client.list_all_models()
            }
        except Exception:
            return
        for name, dkey in models.items():
            with self._lock:
                if self._deploy_keys.get(name) != dkey:
                    self._fingerprints.pop(name, None)
                    self._deploy_keys[name] = dkey

        def probe_one(name: str) -> None:
            try:
                self.probe_model(name)
            except Exception:
                log.exception("canary probe for %s failed unexpectedly", name)

        # Zero-endpoint models record their skip without any I/O — they
        # must not count toward fan-out width (a 200-model fleet with
        # 190 scaled to zero needs a pool sized for 10 probes, not 200).
        active: list[str] = []
        for name in models:
            if self.lb.get_all_addresses(name):
                active.append(name)
            else:
                probe_one(name)
        if len(active) <= 1:
            for name in active:
                probe_one(name)
        else:
            # Fan out across the shared daemon scrape pool (the fleet
            # collector's / incident capture's pool): one hung model
            # blocking its full X-Request-Timeout budget must not
            # serialize behind it every other model's probe — detection
            # within one probe period is the contract. Grown to active
            # count + the default scrape width so that even a tick whose
            # EVERY probe hangs leaves the original workers free for the
            # 2s fleet scrapes and incident captures sharing the pool —
            # probes must not starve the evidence paths during exactly
            # the wide outage they are detecting.
            from kubeai_tpu_torch.autoscaler.fleet import shared_scrape_executor

            pool = shared_scrape_executor(len(active) + 8)
            list(pool.map(probe_one, active))
        with self._lock:
            for gone in set(self._state) - set(models):
                self._state.pop(gone, None)
                self._fingerprints.pop(gone, None)
                self._deploy_keys.pop(gone, None)

    def reset_fingerprint(self, model_name: str) -> None:
        """Drop the baseline (an intentional model update changes the
        deterministic output; the next healthy probe re-pins)."""
        with self._lock:
            self._fingerprints.pop(model_name, None)

    # -- surface -----------------------------------------------------------

    def report(self) -> dict:
        """The /debug/canary payload."""
        with self._lock:
            state = {m: dict(r) for m, r in self._state.items()}
        return {
            "enabled": self.enabled,
            "active": self._leading(),
            "interval_seconds": self.interval,
            "max_tokens": self.max_tokens,
            "timeout_seconds": self.timeout,
            "probes": self._probes,
            "models": state,
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if not self.enabled:
            return
        self._running = True
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="canary-prober", daemon=True
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
            if not self._leading():
                continue
            try:
                self.tick()
            except Exception:  # pragma: no cover - defensive
                log.exception("canary tick failed")


# ---------------------------------------------------------------------------
# Global install + shared /debug route (mirrors obs/incidents.py).

_prober: CanaryProber | None = None


def install_canary(p: CanaryProber) -> None:
    global _prober
    _prober = p


def uninstall_canary(p: CanaryProber) -> None:
    global _prober
    if _prober is p:
        _prober = None


def handle_canary_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    if path != "/debug/canary":
        return None
    if _prober is None:
        return 404, "application/json", json.dumps(
            {"error": {"message": "no canary prober installed on this process"}}
        ).encode()
    return 200, "application/json", json.dumps(_prober.report()).encode()
