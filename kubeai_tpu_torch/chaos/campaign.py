"""A seeded chaos campaign over the port's live in-process stack (port of
kubeai_tpu/chaos/campaign.py).

One stack: a store, the model reconciler, the load balancer, the OpenAI
proxy and N port ``EngineServer``s over test:tiny engines on *device*
(``cuda`` unless the caller asks for the CPU). Each episode:

1. draws a schedule (``generate_schedule(seed, episode, replicas)``),
2. publishes a ``chaos_episode`` incident trigger,
3. runs greedy streams across QoS classes and tenants, usage accounted,
   while a thread arms and clears the schedule's faults at their times,
4. clears every fault, waits for the engines to drain, and checks:

   stream_shape     every client stream byte-identical to its
                    uncontended reference; no hard errors
   conservation     KV pages, slots, queue, breaker in-flight and
                    non-daemon threads back to zero or the baseline
   tokens           client usage == the tenant accountant's deltas;
                    engines generated >= what clients received
   recovery         every breaker closes again once faults are clear
   incident         the recorder captured the episode's trigger

A violating episode is shrunk (ddmin) to a minimal reproducing schedule
and reported with its replay line. ``python -m kubeai_tpu_torch.chaos``
runs a campaign from the command line.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import threading
import time

from kubeai_tpu_torch import faults
from kubeai_tpu_torch.api import model_types as mt
from kubeai_tpu_torch.api.core_types import KIND_POD
from kubeai_tpu_torch.api.model_types import Model, ModelSpec
from kubeai_tpu_torch.config.system import System
from kubeai_tpu_torch.controller.controller import ModelReconciler
from kubeai_tpu_torch.engine.core import EngineConfig, build_test_engine
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.loadbalancer.balancer import LoadBalancer
from kubeai_tpu_torch.metrics import default_registry
from kubeai_tpu_torch.obs.history import HistoryStore
from kubeai_tpu_torch.obs.incidents import (
    IncidentRecorder,
    install_recorder,
    publish_trigger,
    uninstall_recorder,
)
from kubeai_tpu_torch.obs.tenants import default_accountant
from kubeai_tpu_torch.proxy.handler import ModelProxy
from kubeai_tpu_torch.proxy.modelclient import ModelClient
from kubeai_tpu_torch.proxy.server import OpenAIServer
from kubeai_tpu_torch.runtime.store import ObjectMeta, Store

from .invariants import (
    await_drain,
    breaker_leaks,
    engine_leaks,
    nondaemon_threads,
    thread_leaks,
)
from .schedule import FaultEvent, Schedule, generate_schedule, subsystem_of
from .shrink import ddmin

log = logging.getLogger("kubeai_tpu_torch.chaos")

MODEL = "chaos-model"

CLOSED = "closed"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class _AlwaysLeader:
    """Leader election stub: the recorder checks election.is_leader as
    an Event (same shape the drills use)."""

    def __init__(self):
        self.is_leader = threading.Event()
        self.is_leader.set()


def _await(cond, timeout: float = 30.0, msg: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise TimeoutError(f"timed out awaiting {msg}")


def _counter_sum(name: str) -> float:
    metric = default_registry.get(name)
    return float(sum(metric.snapshot().values())) if metric is not None else 0.0


def stream_request(port: int, body: dict, headers: dict, timeout: float = 60.0) -> dict:
    """One streaming completion through the OpenAI surface. Returns
    {"shape": [(text, finish_reason), ...], "usage": (prompt, completion)
    or None, "error": str or None} — the client-visible truth the
    stream_shape and token invariants compare."""
    out: dict = {"shape": [], "usage": None, "error": None}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(
            "POST", "/openai/v1/completions", body=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **headers},
        )
        resp = conn.getresponse()
        if resp.status != 200:
            resp.read()
            out["error"] = f"http {resp.status}"
            return out
        done = False
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            payload = line[5:].strip()
            if payload == b"[DONE]":
                done = True
                break
            ev = json.loads(payload)
            if "error" in ev:
                msg = str(ev["error"].get("message", ""))[:160]
                out["error"] = f"stream error event: {msg}"
                return out
            choices = ev.get("choices") or []
            if not choices:
                u = ev.get("usage")
                if u:
                    out["usage"] = (
                        int(u["prompt_tokens"]), int(u["completion_tokens"])
                    )
                continue
            ch = choices[0]
            out["shape"].append((ch.get("text", ""), ch.get("finish_reason")))
        if not done:
            out["error"] = "truncated stream (no [DONE])"
        return out
    except Exception as e:  # noqa: BLE001 — the error IS the observation
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    finally:
        conn.close()


class _ScheduleRunner(threading.Thread):
    """Arms/disarms a schedule's events at their offsets against the
    live registry, recording per-site fired counts for the coverage
    matrix (a duration-cleared fault vanishes from the registry, so
    its count must be captured at disarm time)."""

    def __init__(self, schedule: Schedule, ports: list[int]):
        super().__init__(name="chaos-schedule", daemon=True)
        self.fired: dict[str, int] = {}
        self._halt = threading.Event()
        actions: list[tuple[float, str, str | None]] = []
        for ev in schedule.events:
            site = ev.resolve_site(ports)
            actions.append((ev.at, site, ev.spec))
            if ev.duration is not None:
                actions.append((ev.at + ev.duration, site, None))
        self._actions = sorted(actions, key=lambda a: a[0])

    def _capture(self, site: str) -> None:
        for f in faults.list_faults():
            if f["name"] == site:
                self.fired[site] = self.fired.get(site, 0) + int(f["fired"])

    def run(self) -> None:
        t0 = time.monotonic()
        for at, site, spec in self._actions:
            delay = t0 + at - time.monotonic()
            if delay > 0 and self._halt.wait(delay):
                break
            if spec is None:
                self._capture(site)
                faults.clear_fault(site)
            else:
                faults.arm_spec(site, spec)

    def finish(self) -> None:
        """Join, capture whatever is still armed, then clear it."""
        self._halt.set()
        self.join(timeout=5.0)
        for f in faults.list_faults():
            self.fired[f["name"]] = self.fired.get(f["name"], 0) + int(f["fired"])
        faults.clear_all()


class ChaosCampaign:
    """Owns the stack and the episode loop. Build once, run many
    episodes, tear down in close() (also on context exit)."""

    def __init__(
        self,
        episodes: int | None = None,
        seed: int | None = None,
        replicas: int | None = None,
        requests_per_episode: int | None = None,
        shrink_runs: int | None = None,
        verbose: bool = True,
        out_dir: str = os.path.join("build", "chaos"),
        device: str | None = None,
    ):
        self.episodes = episodes if episodes is not None else _env_int("KUBEAI_CHAOS_EPISODES", 200)
        self.seed = seed if seed is not None else _env_int("KUBEAI_CHAOS_SEED", 1)
        self.replicas = replicas if replicas is not None else _env_int("KUBEAI_CHAOS_REPLICAS", 3)
        self.requests = requests_per_episode if requests_per_episode is not None else _env_int("KUBEAI_CHAOS_REQUESTS", 8)
        self.shrink_runs = shrink_runs if shrink_runs is not None else _env_int("KUBEAI_CHAOS_SHRINK_RUNS", 30)
        self.verbose = verbose
        self.out_dir = out_dir
        self.device = device
        self._built = False
        self._workload = self._build_workload()
        self._references: dict[str, dict] = {}

    # -- stack ------------------------------------------------------------

    def build(self) -> None:
        faults.clear_all()
        self._saved_env = {
            k: os.environ.get(k)
            for k in ("KUBEAI_DEBUG_FAULTS", "KUBEAI_BREAKER_COOLDOWN_MAX")
        }
        os.environ["KUBEAI_DEBUG_FAULTS"] = "1"
        # Escalation cap for flapping replicas (docs/robustness.md): the
        # endpoint group reads this knob lazily at creation, so it must
        # be pinned before the first reconcile. Kept near the base
        # cooldown so the recovery invariant converges inside the
        # post-episode window even after a flap ran the ladder up.
        os.environ["KUBEAI_BREAKER_COOLDOWN_MAX"] = "2.0"
        self.store = Store()
        system = System().default_and_validate()
        system.allow_pod_address_override = True
        self.rec = ModelReconciler(self.store, system)
        self.rec.start()
        self.lb = LoadBalancer(
            self.store,
            allow_pod_address_override=True,
            # Short cooldowns so the recovery invariant converges inside
            # an episode even after flap escalation (the cap bounds the
            # escalated probe interval the campaign must wait out).
            breaker_cooldown=0.5,
            health_kwargs={
                # Latency scoring OFF: the gray ladder has its own drill;
                # chaos latency noise soft-ejecting replicas mid-episode
                # would make the recovery invariant nondeterministic.
                "outlier_k": 0.0,
                "slow_start_window": 0.0,
            },
        )
        self.lb.start()
        mc = ModelClient(self.store)
        self.proxy = ModelProxy(mc, self.lb, max_retries=2, await_timeout=30)
        self.proxy.hedge_enabled = False  # hedges blur fault attribution
        self.api = OpenAIServer(self.proxy, mc, host="127.0.0.1", port=0)
        self.api.start()
        self.history = HistoryStore(
            history_dir=os.path.join(self.out_dir, "history"),
            flush_seconds=0.0,
        )
        self.recorder = IncidentRecorder(
            # Cheap sources: one capture per episode must not dominate
            # episode wall-clock the way standard_sources' full debug
            # sweep would.
            sources={"faults": lambda: {"active": faults.list_faults()}},
            incident_dir=os.path.join(self.out_dir, "incidents"),
            # Headroom over the episode count: shrink re-runs publish
            # their own tagged triggers, and the capture invariant only
            # ever looks back one episode, so eviction of old episodes
            # is harmless but eviction of the CURRENT one is not.
            capacity=max(64, self.episodes + 64),
            debounce_seconds=0.0,
            election=_AlwaysLeader(),
        )
        install_recorder(self.recorder)

        self.engines = []
        self.servers = []
        for _ in range(self.replicas):
            eng = build_test_engine(
                engine_config=EngineConfig(
                    max_slots=2, max_seq_len=512,
                    prefill_buckets=(32, 64, 128), max_queue=64,
                    decode_chunk=2,
                ),
                device=self.device,
            )
            eng.warmup()
            srv = EngineServer(eng, MODEL, host="127.0.0.1", port=0)
            srv.start()
            self.engines.append(eng)
            self.servers.append(srv)
        self.ports = [srv.port for srv in self.servers]

        self.engines[0].generate(
            self.engines[0].tokenizer.encode("warm"),
            SamplingParams(temperature=0.0, max_tokens=4),
            timeout=180,
        )
        self.store.create(
            mt.KIND_MODEL,
            Model(
                meta=ObjectMeta(name=MODEL),
                spec=ModelSpec(
                    url="hf://chaos/model", resource_profile="cpu:1",
                    replicas=self.replicas, min_replicas=self.replicas,
                ),
            ),
        )
        _await(
            lambda: len(self.store.list(KIND_POD, selector={mt.LABEL_MODEL: MODEL})) == self.replicas,
            msg="model pods",
        )
        pods = sorted(
            self.store.list(KIND_POD, selector={mt.LABEL_MODEL: MODEL}),
            key=lambda p: p.meta.name,
        )
        for pod, srv in zip(pods, self.servers):
            def forge(p, port=srv.port):
                p.status.ready = True
                p.status.pod_ip = "127.0.0.1"
                p.meta.annotations[mt.ANNOTATION_MODEL_POD_IP] = "127.0.0.1"
                p.meta.annotations[mt.ANNOTATION_MODEL_POD_PORT] = str(port)
            self.store.mutate(KIND_POD, pod.meta.name, forge)
        _await(
            lambda: len(self.lb.get_all_addresses(MODEL)) == self.replicas,
            msg="all endpoints",
        )
        # history.disk needs save() traffic to fire: a small ticker
        # forcing the (throttle-free) disk ring write during episodes.
        self._hist_stop = threading.Event()

        def hist_tick():
            while not self._hist_stop.wait(0.1):
                try:
                    self.history.save(force=True)
                except Exception:
                    pass  # containment under test; never kill the ticker

        self._hist_thread = threading.Thread(
            target=hist_tick, name="chaos-history", daemon=True
        )
        self._hist_thread.start()
        self._built = True
        self._settle_and_reference()
        self.baseline_threads = nondaemon_threads()

    def close(self) -> None:
        if not self._built:
            return
        self._built = False
        self._hist_stop.set()
        uninstall_recorder(self.recorder)
        self.recorder.stop()
        faults.clear_all()
        for srv in self.servers:
            srv.stop()
        self.api.stop()
        self.lb.stop()
        self.rec.stop()
        for k, v in self._saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __enter__(self) -> "ChaosCampaign":
        self.build()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- workload ---------------------------------------------------------

    def _build_workload(self) -> list[tuple[dict, dict]]:
        """The per-episode request mix: deterministic streams across
        prompts/lengths (different prefill buckets), QoS classes, and
        tenants — every one usage-accounted and replay-eligible."""
        prompts = [
            "chaos drill alpha",
            "chaos drill beta gamma delta epsilon",
            "chaos drill zeta eta theta iota kappa lambda mu nu xi",
        ]
        work: list[tuple[dict, dict]] = []
        for i in range(self.requests):
            prompt = prompts[i % len(prompts)]
            batch = i % 3 == 2
            body = {
                "model": MODEL, "prompt": prompt, "stream": True,
                "temperature": 0, "max_tokens": 14 if batch else 8,
                "stream_options": {"include_usage": True},
            }
            headers = {
                "X-Priority": "batch" if batch else "interactive",
                "Authorization": f"Bearer chaos-tenant-{i % 2}",
            }
            work.append((body, headers))
        return work

    @staticmethod
    def _ref_key(body: dict) -> str:
        return f"{body['prompt']}|{body['max_tokens']}"

    def _settle_and_reference(self) -> None:
        """Compile every workload shape outside any episode, then
        capture the uncontended reference stream per distinct body —
        the ground truth the stream_shape invariant compares against."""
        for _ in range(2):
            for body, _hdrs in self._workload:
                r = stream_request(self.api.port, body, {})
                if r["error"]:
                    raise RuntimeError(f"reference warmup failed: {r['error']}")
        for body, _hdrs in self._workload:
            key = self._ref_key(body)
            if key in self._references:
                continue
            r = stream_request(self.api.port, body, {})
            if r["error"]:
                raise RuntimeError(f"reference capture failed: {r['error']}")
            self._references[key] = r

    # -- episode ----------------------------------------------------------

    @staticmethod
    def _settled_totals() -> dict:
        """Accountant totals once they stop moving: the previous
        episode's last probe meter can land a beat after its
        stream_request returned (the handler thread is still
        unwinding), and a moving before-snapshot would break the next
        episode's exact conservation check."""
        prev = default_accountant.totals()
        for _ in range(40):
            time.sleep(0.05)
            cur = default_accountant.totals()
            if cur == prev:
                return cur
            prev = cur
        return prev

    def run_episode(self, schedule: Schedule, tag: str = "") -> dict:
        """One chaos episode against the shared stack. Returns
        {"violations": [...], "fired": {site: n}, "degradation": {...}}."""
        acct_before = self._settled_totals()
        retries_before = _counter_sum("kubeai_proxy_retries_total")
        gen_before = _counter_sum("kubeai_engine_generated_tokens_total")
        episode_key = f"chaos-ep-{schedule.episode}{tag}"
        publish_trigger(
            "chaos_episode", model=MODEL,
            detail={"episode": schedule.episode, "seed": schedule.seed,
                    "events": len(schedule.events), "tag": tag},
            key=episode_key,
        )

        runner = _ScheduleRunner(schedule, self.ports)
        results: list[dict | None] = [None] * len(self._workload)

        def drive(i: int, body: dict, headers: dict) -> None:
            time.sleep(0.05 * i)  # stagger so faults overlap live streams
            results[i] = stream_request(self.api.port, body, headers)

        threads = [
            threading.Thread(target=drive, args=(i, body, headers), daemon=True)
            for i, (body, headers) in enumerate(self._workload)
        ]
        runner.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90.0)
        runner.finish()  # captures fired counts, clears all faults

        violations: list[str] = []

        # (a) stream shape: byte-identical to the uncontended reference.
        hard_errors = 0
        for i, r in enumerate(results):
            if r is None:
                violations.append(f"request[{i}] never completed (its client thread wedged)")
                hard_errors += 1
                continue
            if r["error"]:
                violations.append(f"request[{i}] hard error: {r['error']}")
                hard_errors += 1
                continue
            ref = self._references[self._ref_key(self._workload[i][0])]
            if r["shape"] != ref["shape"]:
                violations.append(
                    f"request[{i}] stream shape diverged from reference "
                    f"({len(r['shape'])} events vs {len(ref['shape'])})"
                )
            elif r["usage"] != ref["usage"]:
                violations.append(
                    f"request[{i}] usage diverged: {r['usage']} vs {ref['usage']}"
                )

        # (d) no stuck in-flight + (b) conservation after drain.
        violations += await_drain(self.engines, timeout=20.0)
        violations += engine_leaks(self.engines)
        violations += breaker_leaks(self.lb, model=MODEL)
        violations += thread_leaks(self.baseline_threads)

        # (c) token conservation: client == accountant; engine >= client.
        if hard_errors == 0:
            usages = [r["usage"] for r in results if r and r["usage"]]
            client_prompt = sum(u[0] for u in usages)
            client_completion = sum(u[1] for u in usages)
            expect_requests = acct_before["requests"] + len(self._workload)
            try:
                _await(
                    lambda: default_accountant.totals()["requests"] >= expect_requests,
                    timeout=10.0, msg="accountant settle",
                )
            except TimeoutError:
                pass
            acct = default_accountant.totals()
            d_req = acct["requests"] - acct_before["requests"]
            d_prompt = acct["prompt_tokens"] - acct_before["prompt_tokens"]
            d_completion = acct["completion_tokens"] - acct_before["completion_tokens"]
            if d_req != len(self._workload):
                violations.append(
                    f"accountant counted {d_req} requests, expected {len(self._workload)}"
                )
            if d_prompt != client_prompt or d_completion != client_completion:
                violations.append(
                    "token conservation broke: client saw "
                    f"({client_prompt}p, {client_completion}c), accountant "
                    f"recorded ({d_prompt}p, {d_completion}c)"
                )
            gen_delta = _counter_sum("kubeai_engine_generated_tokens_total") - gen_before
            if gen_delta and gen_delta < client_completion:
                violations.append(
                    f"engines generated {gen_delta:g} tokens but clients "
                    f"received {client_completion} (under-delivery)"
                )

        # (e) breaker/ladder recovery once faults are clear.
        def _states():
            return [
                ep["state"]
                for ep in self.lb.breaker_snapshot().get(MODEL, [])
            ]

        opens = sum(1 for s in _states() if s != CLOSED)
        probe_body = {
            "model": MODEL, "prompt": "chaos probe", "stream": True,
            "temperature": 0, "max_tokens": 1,
        }
        deadline = time.monotonic() + 15.0
        while any(s != CLOSED for s in _states()):
            if time.monotonic() >= deadline:
                violations.append(
                    f"breakers failed to recover after faults cleared: {_states()}"
                )
                break
            stream_request(self.api.port, probe_body, {}, timeout=10.0)
            time.sleep(0.05)

        # (f) the episode's incident trigger was captured.
        def _captured():
            return any(
                d["trigger"] == "chaos_episode"
                and (d.get("detail") or {}).get("episode") == schedule.episode
                and (d.get("detail") or {}).get("tag", "") == tag
                for d in self.recorder.snapshot()
            )

        try:
            _await(_captured, timeout=10.0, msg="incident capture")
        except TimeoutError:
            violations.append(
                f"incident recorder never captured episode {schedule.episode}"
            )

        return {
            "violations": violations,
            "fired": runner.fired,
            "degradation": {
                "breaker_opens": opens,
                "retries": _counter_sum("kubeai_proxy_retries_total") - retries_before,
            },
        }

    # -- campaign ---------------------------------------------------------

    def shrink(self, schedule: Schedule) -> tuple[list[FaultEvent], int]:
        """ddmin the violating schedule: a candidate subset reproduces
        when re-running it (same stack, same workload) still violates."""

        def test(events: list[FaultEvent]) -> bool:
            sub = Schedule(seed=schedule.seed, episode=schedule.episode, events=events)
            res = self.run_episode(sub, tag=f"-shrink{test.calls}")
            test.calls += 1
            return bool(res["violations"])

        test.calls = 0
        return ddmin(schedule.events, test, max_runs=self.shrink_runs)

    def run(self, induce: Schedule | None = None) -> dict:
        """The full campaign. *induce* appends one extra episode with a
        deliberately unsurvivable schedule (--induce / tests) to prove
        the violation -> seed replay -> shrink pipeline end to end."""
        t0 = time.monotonic()
        site_cov: dict[str, dict] = {}
        invariant_stats = {
            "stream_shape": 0, "conservation": 0, "tokens": 0,
            "recovery": 0, "incident": 0,
        }
        degradation = {"breaker_opens": 0, "retries": 0.0, "episodes_with_faults_fired": 0}
        violations_report: list[dict] = []
        episodes_run = 0

        plans: list[Schedule] = [
            generate_schedule(self.seed, i, self.replicas)
            for i in range(self.episodes)
        ]
        if induce is not None:
            plans.append(induce)

        for sched in plans:
            episodes_run += 1
            res = self.run_episode(sched)
            for site, fired in res["fired"].items():
                base = site.split("@", 1)[0]
                ent = site_cov.setdefault(
                    base, {"subsystem": subsystem_of(base), "episodes_armed": 0, "fired": 0}
                )
                ent["episodes_armed"] += 1
                ent["fired"] += fired
            if any(f > 0 for f in res["fired"].values()):
                degradation["episodes_with_faults_fired"] += 1
            degradation["breaker_opens"] += res["degradation"]["breaker_opens"]
            degradation["retries"] += res["degradation"]["retries"]
            if res["violations"]:
                reduced, runs = self.shrink(sched)
                red_sched = Schedule(seed=sched.seed, episode=sched.episode, events=reduced)
                violations_report.append({
                    "episode": sched.episode,
                    "seed": sched.seed,
                    "violations": res["violations"],
                    "schedule": sched.to_dict(),
                    "reduced_schedule": red_sched.to_dict(),
                    "shrink_runs": runs,
                    "replay": (
                        f"python -m kubeai_tpu_torch.chaos --seed {sched.seed} "
                        f"--replicas {self.replicas} --replay-episode {sched.episode}"
                    ),
                })
                if self.verbose:
                    print(f"\nINVARIANT VIOLATION in episode {sched.episode} "
                          f"(seed {sched.seed}):")
                    for v in res["violations"]:
                        print(f"  - {v}")
                    print(f"  schedule: {sched.describe()}")
                    print(f"  shrunk to {len(reduced)} event(s) in {runs} runs: "
                          f"{red_sched.describe()}")
                    print(f"  replay: {violations_report[-1]['replay']}")
            elif self.verbose and sched.episode % 20 == 0:
                print(f"  episode {sched.episode}: "
                      f"{len(sched.events)} faults, clean "
                      f"({time.monotonic() - t0:.0f}s elapsed)")

        doc = {
            "bench": "chaos",
            "schema_version": 1,
            "seed": self.seed,
            "episodes": episodes_run,
            "replicas": self.replicas,
            "requests_per_episode": self.requests,
            "site_coverage": dict(sorted(site_cov.items())),
            "subsystems_covered": sorted({
                e["subsystem"] for e in site_cov.values() if e["fired"] > 0
            }),
            "sites_fired": sorted(
                s for s, e in site_cov.items() if e["fired"] > 0
            ),
            "invariants": {
                k: {"violations": sum(
                    1 for v in violations_report
                    for s in v["violations"]
                    if _classify(s) == k
                )}
                for k in invariant_stats
            },
            "violations": violations_report,
            "degradation": degradation,
            "duration_s": round(time.monotonic() - t0, 2),
        }
        return doc


def _classify(violation: str) -> str:
    """Map a violation string to its invariant bucket (CHAOS.json)."""
    if "stream" in violation or "hard error" in violation or "usage diverged" in violation:
        return "stream_shape"
    if "token conservation" in violation or "accountant" in violation or "under-delivery" in violation:
        return "tokens"
    if "breakers failed to recover" in violation:
        return "recovery"
    if "incident recorder" in violation:
        return "incident"
    return "conservation"


def induced_schedule(seed: int = 0) -> Schedule:
    """A schedule no stack survives (every connect fails, far past the
    retry budget) with benign chaff: ``--induce`` and the tests prove
    detection and shrinking with it. ddmin should strip the chaff and
    keep the connect kill alone."""
    return Schedule(seed=seed, episode=-1, events=[
        FaultEvent("balancer.reconcile", "error:2", at=0.0),
        FaultEvent("history.disk", "error:2", at=0.0),
        FaultEvent("proxy.connect", "error:999", at=0.0),
        FaultEvent("incidents.disk", "flap:0.2", at=0.0, duration=0.5),
    ])
