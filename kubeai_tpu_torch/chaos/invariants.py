"""The invariants a quiesced serving stack must hold after any survivable
fault (port of kubeai_tpu/chaos/invariants.py):

    drain          every engine reaches requests_in_system == 0
    slots/pages    no engine keeps an active slot or a KV pool page
    queue          no engine keeps queued work
    breaker        no endpoint keeps in-flight accounting
    threads        no non-daemon thread outlives the work it served

Each helper returns violation strings (empty: clean) rather than raising,
so the campaign collects them across invariants.
"""

from __future__ import annotations

import threading
import time


def nondaemon_threads() -> set[str]:
    """Names of live non-daemon threads — capture as the baseline
    AFTER the stack under test is built and settled (so the stack's own
    long-lived servers are part of it, and only per-request work shows
    up as a leak)."""
    return {t.name for t in threading.enumerate() if not t.daemon and t.is_alive()}


def await_drain(engines, timeout: float = 15.0) -> list[str]:
    """Wait for every engine to drain; violations name the stuck
    replicas with their live counts (the no-stuck-in-flight invariant)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(e.requests_in_system() == 0 for e in engines):
            return []
        time.sleep(0.02)
    return [
        f"engine[{i}] stuck after {timeout:g}s: "
        f"in_system={e.requests_in_system()} active={e.active_slots()} "
        f"queued={e.queue_depth()}"
        for i, e in enumerate(engines)
        if e.requests_in_system() != 0
    ]


def engine_leaks(engines) -> list[str]:
    """Slot / queue / KV-page conservation after drain."""
    out: list[str] = []
    for i, eng in enumerate(engines):
        if eng.active_slots() != 0:
            out.append(f"engine[{i}] leaked {eng.active_slots()} active slot(s)")
        if eng.queue_depth() != 0:
            out.append(f"engine[{i}] retained {eng.queue_depth()} queued request(s)")
        pool = getattr(eng, "_pool", None)
        if pool is not None and pool.used() != 0:
            out.append(f"engine[{i}] leaked {pool.used()} KV page(s)")
    return out


def breaker_leaks(lb, model: str | None = None,
                  timeout: float = 5.0) -> list[str]:
    """Endpoint in-flight conservation. The proxy's done() callbacks
    run on streaming-handler threads that may still be unwinding when
    the engines report drained, so this check polls briefly before
    declaring a leak."""
    deadline = time.monotonic() + timeout
    while True:
        snap = lb.breaker_snapshot()
        stuck = [
            (name, ep)
            for name, eps in snap.items()
            if model is None or name == model
            for ep in eps
            if ep.get("in_flight", 0) != 0
        ]
        if not stuck or time.monotonic() >= deadline:
            break
        time.sleep(0.02)
    return [
        f"endpoint {ep['address']} ({name}) retains in_flight={ep['in_flight']}"
        for name, ep in stuck
    ]


def thread_leaks(baseline: set[str], timeout: float = 5.0,
                 allow: tuple[str, ...] = ()) -> list[str]:
    """Non-daemon threads alive beyond *baseline* (names), after a
    short grace for handler threads still unwinding. *allow* lists
    name prefixes that are expected to persist (the stack's own
    long-lived servers, when checked before teardown)."""
    deadline = time.monotonic() + timeout
    while True:
        extra = sorted(
            t for t in nondaemon_threads() - baseline
            if not any(t.startswith(p) for p in allow)
        )
        if not extra or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    return [f"leaked non-daemon thread: {t}" for t in extra]


def quiesce_violations(engines, lb=None, model: str | None = None,
                       baseline_threads: set[str] | None = None,
                       drain_timeout: float = 15.0,
                       allow_threads: tuple[str, ...] = ()) -> list[str]:
    """The full post-episode / post-drill leak suite: drain, then
    slot/page/queue, breaker in-flight, and thread conservation."""
    out = await_drain(engines, timeout=drain_timeout)
    out += engine_leaks(engines)
    if lb is not None:
        out += breaker_leaks(lb, model=model)
    if baseline_threads is not None:
        out += thread_leaks(baseline_threads, allow=allow_threads)
    return out
