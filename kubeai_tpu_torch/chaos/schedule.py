"""Seeded chaos schedules (port of kubeai_tpu/chaos/schedule.py): fault
plans drawn from the failpoint catalog, the same JSON as the JAX
generator's for the same ``(seed, episode, n_replicas)``.

A schedule is an ordered list of ``FaultEvent`` (site, spec, arm time,
optional duration) drawn from one seeded ``random.Random``, so a
violating episode is reproduced from two integers, and a shrunk one from
its JSON. Events come from the survivable catalog: faults the stack
promises to absorb without a client seeing them (proxy retries before
headers, a replica's mid-stream death behind the proxy's replay, a
reconcile or disk failure, a scheduler hiccup). ``@r<i>`` sites name the
i-th replica and resolve to its ``@<port>`` twin when armed.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass

# Failpoint site -> subsystem, for the coverage matrix CHAOS.json
# reports. Keys are base sites (no @scope); subsystem_of() strips the
# scope before the lookup.
SUBSYSTEM_OF = {
    "proxy.connect": "proxy",
    "balancer.reconcile": "balancer",
    "engine.submit": "engine",
    "engine.step": "engine",
    "engine.stream": "engine",
    "engine.kv_export": "kv",
    "engine.kv_import": "kv",
    "gang.publish": "engine",
    "gang.follower": "engine",
    "weights.load": "engine",
    "history.disk": "obs",
    "incidents.disk": "obs",
}


def base_site(site: str) -> str:
    """Strip an ``@scope`` suffix (``@r0`` placeholder or ``@<port>``)."""
    return site.split("@", 1)[0]


def subsystem_of(site: str) -> str:
    return SUBSYSTEM_OF.get(base_site(site), "unknown")


@dataclass(frozen=True)
class FaultEvent:
    """One arm/disarm action in a chaos schedule.

    ``site`` may carry an ``@r<i>`` placeholder (i-th replica of the
    campaign fleet, by stable sort order) that :meth:`resolve_site`
    rewrites to the replica's real ``@<port>`` scoped twin.
    ``duration`` is seconds until the event is disarmed; None leaves it
    armed until the episode's quiesce clears all faults.
    """

    site: str
    spec: str
    at: float
    duration: float | None = None

    def resolve_site(self, ports: list[int]) -> str:
        base, _, scope = self.site.partition("@")
        if scope.startswith("r"):
            idx = int(scope[1:])
            return f"{base}@{ports[idx % len(ports)]}"
        return self.site

    def to_dict(self) -> dict:
        d = {"site": self.site, "spec": self.spec, "at": round(self.at, 3)}
        if self.duration is not None:
            d["duration"] = round(self.duration, 3)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(
            site=d["site"], spec=d["spec"], at=float(d["at"]),
            duration=float(d["duration"]) if d.get("duration") is not None else None,
        )

    def __str__(self) -> str:
        tail = f" for {self.duration:g}s" if self.duration is not None else ""
        return f"[t+{self.at:.2f}s] {self.site}={self.spec}{tail}"


@dataclass
class Schedule:
    """An episode's fault plan: seeded provenance + the event list."""

    seed: int
    episode: int
    events: list[FaultEvent]

    def describe(self) -> str:
        if not self.events:
            return "(no faults)"
        return "; ".join(str(e) for e in self.events)

    def sites(self) -> set[str]:
        return {base_site(e.site) for e in self.events}

    def subsystems(self) -> set[str]:
        return {subsystem_of(e.site) for e in self.events}

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "episode": self.episode,
            "events": [e.to_dict() for e in self.events],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(
            seed=int(d["seed"]), episode=int(d["episode"]),
            events=[FaultEvent.from_dict(e) for e in d["events"]],
        )

    @classmethod
    def from_json(cls, s: str) -> "Schedule":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Survivable catalog.
#
# Each template is drawn with the episode's PRNG so arm times, budgets
# and replica targets vary, but every draw stays inside the stack's
# documented containment envelope:
#
#   proxy.connect error      <= 2 failures; proxy retries (max_retries=2)
#                            fire BEFORE response headers, so the client
#                            stream is untouched.
#   proxy.connect delay      pure added latency on the connect path.
#   balancer.reconcile       wrapped in catch-all containment; endpoints
#                            are static mid-episode so skipped reconciles
#                            are invisible.
#   engine.submit error      upstream 500 before any SSE event; the
#                            proxy fails over to another replica.
#   engine.step delay (@r)   scheduler hiccup on ONE replica: latency
#                            only. (step *error* is deliberately absent:
#                            it fails in-flight work with an error
#                            terminal the client sees.)
#   engine.stream slow (@r)  one gray straggler; shape-preserving.
#   engine.stream error/flap (@r)
#                            mid-stream replica death: the socket is
#                            severed, the proxy replays on another
#                            replica with an event cursor — LETHAL
#                            class, at most one per episode and always
#                            replica-scoped so a healthy replay target
#                            exists.
#   history.disk / incidents.disk
#                            on-disk ring persistence failures; both
#                            stores must keep serving from memory.
# ---------------------------------------------------------------------------


def _target(rng: random.Random, n_replicas: int) -> str:
    return f"@r{rng.randrange(n_replicas)}"


def _benign_proxy_error(rng, n):
    return FaultEvent("proxy.connect", f"error:{rng.randint(1, 2)}",
                      at=rng.uniform(0.0, 0.4))


def _benign_proxy_delay(rng, n):
    return FaultEvent("proxy.connect",
                      f"delay:{rng.choice((0.02, 0.04)):g}:times={rng.randint(1, 3)}",
                      at=rng.uniform(0.0, 0.4))


def _benign_reconcile_error(rng, n):
    return FaultEvent("balancer.reconcile", f"error:{rng.randint(1, 3)}",
                      at=rng.uniform(0.0, 0.5))


def _benign_reconcile_flap(rng, n):
    return FaultEvent("balancer.reconcile",
                      f"flap:{rng.choice((0.1, 0.2)):g}",
                      at=rng.uniform(0.0, 0.3),
                      duration=rng.uniform(0.3, 0.8))


def _benign_submit_error(rng, n):
    return FaultEvent("engine.submit", f"error:{rng.randint(1, 2)}",
                      at=rng.uniform(0.0, 0.4))


def _benign_step_delay(rng, n):
    return FaultEvent(f"engine.step{_target(rng, n)}",
                      f"delay:{rng.choice((0.02, 0.05)):g}:times={rng.randint(2, 6)}",
                      at=rng.uniform(0.0, 0.4))


def _benign_stream_slow(rng, n):
    return FaultEvent(f"engine.stream{_target(rng, n)}",
                      f"slow:{rng.choice((5, 15)):g}:times={rng.randint(3, 10)}",
                      at=rng.uniform(0.0, 0.3))


def _benign_history_disk(rng, n):
    return FaultEvent("history.disk", f"error:{rng.randint(1, 4)}",
                      at=rng.uniform(0.0, 0.5))


def _benign_incidents_disk(rng, n):
    return FaultEvent("incidents.disk",
                      f"flap:{rng.choice((0.1, 0.15)):g}",
                      at=rng.uniform(0.0, 0.3),
                      duration=rng.uniform(0.3, 0.8))


def _lethal_stream_kill(rng, n):
    return FaultEvent(f"engine.stream{_target(rng, n)}",
                      f"error:1:skip={rng.randint(1, 5)}",
                      at=rng.uniform(0.0, 0.2))


def _lethal_stream_flap(rng, n):
    return FaultEvent(f"engine.stream{_target(rng, n)}",
                      f"flap:{rng.choice((0.2, 0.3)):g}:0.4",
                      at=rng.uniform(0.0, 0.2),
                      duration=rng.uniform(0.3, 0.6))


BENIGN_TEMPLATES = [
    _benign_proxy_error,
    _benign_proxy_delay,
    _benign_reconcile_error,
    _benign_reconcile_flap,
    _benign_submit_error,
    _benign_step_delay,
    _benign_stream_slow,
    _benign_history_disk,
    _benign_incidents_disk,
]

# Stream-killing faults: survivable ONLY via mid-stream replay, which
# needs a healthy replica to land on — so at most one per episode and
# always replica-scoped.
LETHAL_TEMPLATES = [
    _lethal_stream_kill,
    _lethal_stream_flap,
]


# Sites whose *error* arms each consume one proxy retry attempt before
# any response byte (connect failure / upstream 500). Individually each
# benign draw stays under the allowance, but two sites COMPOSE: with
# max_retries=2 the proxy makes 3 attempts per request, so injected
# pre-stream errors summing to >= 3 can exhaust every attempt of one
# unlucky request and surface an unearned 502 (seed 1 episode 29 found
# exactly this). The generator therefore budgets the episode-wide sum —
# and a lethal mid-stream sever spends attempts from the SAME pool (the
# replay retarget is one more connect per sever, seed 1 episode 98), so
# lethal episodes get no benign error budget at all.
ATTEMPT_CONSUMING_SITES = ("proxy.connect", "engine.submit")
ATTEMPT_ERROR_BUDGET = 2  # < the campaign proxy's 3 attempts/request


def _attempts_consumed(ev: FaultEvent) -> int:
    if base_site(ev.site) not in ATTEMPT_CONSUMING_SITES:
        return 0
    mode, _, rest = ev.spec.partition(":")
    if mode != "error":
        return 0
    count = rest.split(":", 1)[0]
    return int(count) if count.isdigit() else ATTEMPT_ERROR_BUDGET + 1


def generate_schedule(seed: int, episode: int, n_replicas: int,
                      min_events: int = 2, max_events: int = 4) -> Schedule:
    """Draw episode *episode* of campaign *seed*: 2-4 events (one
    optionally lethal), deterministic in (seed, episode, n_replicas)."""
    rng = random.Random((seed << 20) ^ episode)
    n_events = rng.randint(min_events, max_events)
    events: list[FaultEvent] = []
    if rng.random() < 0.45:
        events.append(LETHAL_TEMPLATES[rng.randrange(len(LETHAL_TEMPLATES))](rng, n_replicas))
    # Benign events draw WITHOUT site collisions: two specs on the same
    # site would overwrite each other in the registry (last arm wins),
    # making the schedule's description lie about what actually ran.
    used_sites = {e.site for e in events}
    error_budget = 0 if events else ATTEMPT_ERROR_BUDGET
    attempts = 0
    while len(events) < n_events and attempts < 32:
        attempts += 1
        ev = BENIGN_TEMPLATES[rng.randrange(len(BENIGN_TEMPLATES))](rng, n_replicas)
        if ev.site in used_sites:
            continue
        consumed = _attempts_consumed(ev)
        if consumed > error_budget:
            continue
        error_budget -= consumed
        used_sites.add(ev.site)
        events.append(ev)
    events.sort(key=lambda e: e.at)
    return Schedule(seed=seed, episode=episode, events=events)
