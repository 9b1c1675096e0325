"""Fault-injection failpoints (port of kubeai_tpu/faults.py).

A failpoint is a named site in serving code, ``fault("engine.step")``,
that is a no-op until a fault is armed on it. Faults are armed by name:

- programmatically: ``set_fault("engine.step", "error", times=2)``
- by environment:   ``KUBEAI_FAILPOINTS="engine.submit=error:2;engine.step=delay:0.05"``
- over HTTP:        ``GET /debug/faults?set=engine.step=delay:0.05`` on the
  engine server (``?clear=NAME`` / ``?clear=all`` disarm; a bare GET lists
  armed faults and hit counts; arming needs ``KUBEAI_DEBUG_FAULTS=1``).

Modes (``spec`` grammar: ``mode[:arg][:key=val...]``), as in the JAX
package: ``error[:N]`` (``skip=K`` passes the first K triggers), ``delay:S``,
``slow:MS[:JITTER_MS]``, ``hang`` (until cleared, or ``max=S``),
``corrupt`` (bitwise-inverts a bytes payload) and ``flap:PERIOD[:DUTY]``.

Scoped twins: a thread with a fault scope (``set_thread_scope``; the
engine server's handler threads and the engine's scheduler thread use
the server's port) also fires ``name@SCOPE``, so one replica of several
in one process can be faulted alone.

This registry is the port's own: in a process that imports both
packages, arming ``kubeai_tpu.faults`` does not reach a port engine
(``/debug/faults`` on its server does).

The port's sites, under the JAX package's names:

    engine.submit        request admission into the engine queue
    engine.step          top of each scheduler-loop iteration
    engine.stream        before each SSE event the engine server writes
                         (error:1:skip=N severs the stream after N events)
    engine.kv_export     KV park serialization (payload: the blob)
    engine.kv_import     KV restore: on the serving thread with the
                         fetched blob as payload, and on the scheduler
                         thread before the device import
    weights.load         checkpoint loading
    gang.publish         before each gang dispatch broadcast (rank 0)
    gang.follower        each follower recv (a follower-drop: the
                         reconnect-with-backoff and re-form path)
    history.disk         each metrics-history snapshot write (an error
                         keeps the history in memory only)
"""

from __future__ import annotations

import logging
import os
import threading
import time

log = logging.getLogger("kubeai_tpu_torch.faults")

_lock = threading.Lock()
_active: dict[str, "_Fault"] = {}

# Per-thread fault scope. A thread owned by one replica of an
# in-process fleet (an engine server's handler thread, the engine's
# scheduler thread) sets its scope to that replica's port; fault(name)
# then also fires the "name@scope" twin, so ANY site can be armed
# against a single replica without the call sites knowing about scoping.
_tls = threading.local()


def set_thread_scope(scope: str | None) -> None:
    """Set (or clear, with None/"") the calling thread's fault scope.
    While set, every ``fault(name)`` on this thread also fires the
    ``name@scope`` twin — the generalization of the old hand-rolled
    ``engine.stream@PORT`` site to every registered failpoint."""
    _tls.scope = str(scope) if scope else None


class FaultError(ConnectionError, RuntimeError):
    """Raised by an armed ``error`` failpoint. Subclasses ConnectionError
    so network-shaped sites (proxy.connect, gang.publish) fail exactly
    like a dead peer — the containment paths under test are the REAL
    ones, not fault-special-cased branches."""

    def __init__(self, name: str, message: str = ""):
        super().__init__(message or f"injected fault at {name!r}")
        self.name = name


class _Fault:
    __slots__ = ("name", "mode", "arg", "arg2", "times", "skip", "max_s", "hits", "fired", "release", "armed_at")

    def __init__(self, name: str, mode: str, arg: float | None, times: int | None, skip: int, max_s: float | None, arg2: float | None = None):
        self.name = name
        self.mode = mode
        self.arg = arg
        self.arg2 = arg2  # second positional (slow: jitter ms; flap: duty)
        self.times = times  # None = unlimited
        self.skip = skip
        self.max_s = max_s
        self.hits = 0  # triggers observed (incl. skipped)
        self.fired = 0  # triggers that actually acted
        self.release = threading.Event()  # set on clear: unhangs waiters
        self.armed_at = time.monotonic()  # flap phase anchor

    def describe(self) -> dict:
        return {
            "name": self.name,
            "mode": self.mode,
            "arg": self.arg,
            "arg2": self.arg2,
            "times": self.times,
            "skip": self.skip,
            "hits": self.hits,
            "fired": self.fired,
        }


def parse_spec(name: str, spec: str) -> _Fault:
    """``mode[:arg][:key=val...]`` -> _Fault. Raises ValueError on junk
    (armers should fail loudly — a typo'd chaos schedule that silently
    injects nothing proves the wrong thing)."""
    parts = [p.strip() for p in spec.split(":") if p.strip()]
    if not parts:
        raise ValueError(f"empty fault spec for {name!r}")
    mode, rest = parts[0], parts[1:]
    arg: float | None = None
    arg2: float | None = None
    times: int | None = None
    skip = 0
    max_s: float | None = None
    for p in rest:
        if "=" in p:
            k, _, v = p.partition("=")
            if k == "skip":
                skip = int(v)
            elif k == "max":
                max_s = float(v)
            elif k == "times":
                times = int(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {spec!r}")
        elif arg is None:
            arg = float(p)
        else:
            arg2 = float(p)
    if mode == "error":
        if arg is not None:
            times = int(arg)
    elif mode == "delay":
        if arg is None:
            raise ValueError(f"delay fault needs seconds: {spec!r}")
    elif mode == "slow":
        if arg is None:
            raise ValueError(f"slow fault needs per-trigger milliseconds: {spec!r}")
    elif mode == "hang":
        pass
    elif mode == "corrupt":
        if arg is not None:
            times = int(arg)
    elif mode == "flap":
        if arg is None or arg <= 0:
            raise ValueError(f"flap fault needs a positive period in seconds: {spec!r}")
        if arg2 is not None and not (0.0 < arg2 < 1.0):
            raise ValueError(f"flap duty must be in (0, 1): {spec!r}")
    else:
        raise ValueError(f"unknown fault mode {mode!r} (error|delay|slow|hang|corrupt|flap)")
    return _Fault(name, mode, arg, times, skip, max_s, arg2=arg2)


def set_fault(name: str, mode: str, *, times: int | None = None, skip: int = 0,
              delay: float | None = None, max_s: float | None = None) -> None:
    """Arm *mode* on failpoint *name* (replacing any armed fault there)."""
    f = _Fault(name, mode, delay, times, skip, max_s)
    if mode in ("delay", "slow", "flap") and delay is None:
        raise ValueError(f"{mode} fault needs delay= (seconds for delay/flap, ms for slow)")
    if mode not in ("error", "delay", "slow", "hang", "corrupt", "flap"):
        raise ValueError(f"unknown fault mode {mode!r}")
    if mode == "flap":
        f.arg = delay
    if mode in ("delay", "slow"):
        f.arg = delay
    with _lock:
        old = _active.get(name)
        if old is not None:
            old.release.set()
        _active[name] = f
    log.info("fault armed: %s=%s times=%s skip=%s", name, mode, times, skip)


def arm_spec(name: str, spec: str) -> None:
    f = parse_spec(name, spec)
    with _lock:
        old = _active.get(name)
        if old is not None:
            old.release.set()
        _active[name] = f
    log.info("fault armed: %s=%s", name, spec)


def clear_fault(name: str) -> bool:
    """Disarm *name*; releases any thread hung on it. Returns whether a
    fault was armed."""
    with _lock:
        f = _active.pop(name, None)
    if f is not None:
        f.release.set()
        log.info("fault cleared: %s", name)
    return f is not None


def clear_all() -> int:
    with _lock:
        faults = list(_active.values())
        _active.clear()
    for f in faults:
        f.release.set()
    if faults:
        log.info("all faults cleared (%d)", len(faults))
    return len(faults)


def list_faults() -> list[dict]:
    with _lock:
        return [f.describe() for f in _active.values()]


def load_env(env: str | None = None) -> int:
    """Arm faults from ``KUBEAI_FAILPOINTS`` ("name=spec;name=spec").
    Called once at import; callable again after mutating the env (tests).
    Returns the number armed."""
    raw = env if env is not None else os.environ.get("KUBEAI_FAILPOINTS", "")
    n = 0
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, spec = entry.partition("=")
        if not sep:
            log.warning("ignoring malformed KUBEAI_FAILPOINTS entry %r", entry)
            continue
        try:
            arm_spec(name.strip(), spec.strip())
            n += 1
        except ValueError as e:
            log.warning("ignoring bad failpoint %r: %s", entry, e)
    return n


def fault(name: str, payload=None):
    """The failpoint. Returns *payload* (possibly corrupted); raises
    FaultError / sleeps / hangs per the armed fault. No-op (one dict
    lookup) when nothing is armed on *name*. Also fires the
    ``name@scope`` twin when the calling thread has a fault scope set
    (see ``set_thread_scope``) — bare-name arms hit every replica,
    scoped arms hit one."""
    if not _active:  # fast path: nothing armed anywhere
        return payload
    payload = _fire(name, payload)
    scope = getattr(_tls, "scope", None)
    if scope and "@" not in name:
        payload = _fire(f"{name}@{scope}", payload)
    return payload


def _fire(name: str, payload):
    with _lock:
        f = _active.get(name)
        if f is None:
            return payload
        f.hits += 1
        if f.hits <= f.skip:
            return payload
        if f.times is not None and f.fired >= f.times:
            return payload
        if f.mode == "flap":
            # On-phase = the first DUTY fraction of each PERIOD-second
            # cycle, anchored at arm time. Off-phase passes through
            # WITHOUT consuming the times budget — the budget counts
            # injected failures, not wall-clock polls.
            period = float(f.arg or 1.0)
            duty = float(f.arg2) if f.arg2 is not None else 0.5
            phase = ((time.monotonic() - f.armed_at) / period) % 1.0
            if phase >= duty:
                return payload
        f.fired += 1
        mode, arg, arg2, max_s, release = f.mode, f.arg, f.arg2, f.max_s, f.release
        fired = f.fired
    # Act OUTSIDE the lock: a hang/delay must not block other failpoints.
    if mode in ("error", "flap"):
        raise FaultError(name)
    if mode == "delay":
        time.sleep(float(arg or 0.0))
        return payload
    if mode == "slow":
        # Per-trigger drag in MILLISECONDS (a per-token straggler, not a
        # one-shot stall). The optional jitter is deterministic — the
        # golden-ratio sequence over the fired count — so a chaos run
        # replays identically while still spreading inter-token gaps.
        j = float(arg2 or 0.0) * ((fired * 0.6180339887) % 1.0)
        time.sleep((float(arg or 0.0) + j) / 1000.0)
        return payload
    if mode == "hang":
        release.wait(timeout=max_s)
        return payload
    if mode == "corrupt":
        if isinstance(payload, (bytes, bytearray)):
            return bytes(b ^ 0xFF for b in payload)
        return payload
    return payload


def http_arming_enabled() -> bool:
    """Whether /debug/faults may MUTATE fault state over HTTP. Off by
    default — unlike the read-only debug surfaces, arming a fault is a
    remote kill switch (hang the scheduler, corrupt bodies), so it
    requires the explicit ``KUBEAI_DEBUG_FAULTS=1`` opt-in chaos
    environments set. Re-read per request so tests can toggle it."""
    return os.environ.get("KUBEAI_DEBUG_FAULTS", "") in ("1", "true", "yes")


def handle_faults_request(path: str, query: str = "") -> tuple[int, str, bytes] | None:
    """``/debug/faults`` route shared by the proxy and engine HTTP
    servers. GET-only by design (the debug surface is GET-routed);
    arming via query params keeps it curl-able:

        GET /debug/faults                      list armed faults
        GET /debug/faults?set=NAME=SPEC        arm (SPEC grammar above)
        GET /debug/faults?clear=NAME|all       disarm

    Listing is always available (read-only, like /debug/requests);
    set/clear require KUBEAI_DEBUG_FAULTS=1 (403 otherwise).

    Returns (status, content-type, body) or None for non-fault paths."""
    import json
    from urllib.parse import parse_qs, unquote

    if path != "/debug/faults":
        return None
    q = parse_qs(query or "")
    if (q.get("set") or q.get("clear")) and not http_arming_enabled():
        return 403, "application/json", json.dumps({
            "error": {
                "message": "fault arming over HTTP is disabled; set "
                           "KUBEAI_DEBUG_FAULTS=1 on this process to enable",
                "type": "invalid_request_error",
            }
        }).encode()
    errors: list[str] = []
    for raw in q.get("set", []):
        name, sep, spec = unquote(raw).partition("=")
        if not sep:
            errors.append(f"malformed set={raw!r} (want name=spec)")
            continue
        try:
            arm_spec(name.strip(), spec.strip())
        except ValueError as e:
            errors.append(str(e))
    for name in q.get("clear", []):
        if name == "all":
            clear_all()
        else:
            clear_fault(name)
    body = {"faults": list_faults()}
    if errors:
        body["errors"] = errors
    return (400 if errors else 200), "application/json", json.dumps(body).encode()


# Arm anything the environment asks for at import time: engine pods and
# the operator both import this module via their failpoint call sites.
load_env()
