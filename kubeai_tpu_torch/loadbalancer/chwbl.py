"""Consistent Hashing with Bounded Loads (CHWBL) ring.

Port of kubeai_tpu/loadbalancer/chwbl.py: the JAX package's code,
its imports in this package.

Behavioral parity with the reference's prefix-hash strategy
(ref: internal/loadbalancer/balance_chwbl.go): each endpoint is placed on
a 64-bit xxhash ring `replication` times; a request key hashes to a ring
position and we walk clockwise until we find an endpoint whose in-flight
load is within `load_factor` of the (simulated, +1) mean load. Endpoints
that can't serve the request's adapter are skipped; the first
adapter-capable endpoint seen is the fallback if none meets the load bound.
"""

from __future__ import annotations

import bisect
from typing import Callable, Iterator

from kubeai_tpu_torch.utils.xxh import xxh64


def load_ok(load: int, total_load: int, n_endpoints: int, load_factor: float) -> bool:
    """Bounded-load check; the +1 simulates the incoming request's load
    (ref: balance_chwbl.go:152-162)."""
    if total_load == 0:
        return True
    avg = (total_load + 1) / n_endpoints
    return load <= avg * load_factor


class HashRing:
    """Sorted xxhash64 ring with virtual-node replication."""

    def __init__(self, replication: int = 256):
        self.replication = replication
        self._hash_to_name: dict[int, str] = {}
        self._sorted: list[int] = []

    def __len__(self) -> int:
        return len(self._sorted)

    def _replica_hashes(self, name: str) -> Iterator[int]:
        # "/" separator keeps the input unambiguous: f"{name}{i}" would make
        # "pod-1"+"23" collide with "pod-12"+"3" and corrupt the ring on
        # remove (pod names can't contain "/").
        for i in range(self.replication):
            yield xxh64(f"{name}/{i}")

    def add(self, name: str) -> None:
        for h in self._replica_hashes(name):
            if h not in self._hash_to_name:
                bisect.insort(self._sorted, h)
            self._hash_to_name[h] = name

    def remove(self, name: str) -> None:
        for h in self._replica_hashes(name):
            if self._hash_to_name.get(h) == name:
                del self._hash_to_name[h]
                i = bisect.bisect_left(self._sorted, h)
                if i < len(self._sorted) and self._sorted[i] == h:
                    self._sorted.pop(i)

    def vnode_counts(self) -> dict[str, int]:
        """Live virtual nodes per endpoint — normally ``replication``
        each, fewer only when two endpoints' replica hashes collided
        (last add wins a contested slot). The /debug/routing surface
        exposes this so ring skew is observable instead of assumed."""
        out: dict[str, int] = {}
        for name in self._hash_to_name.values():
            out[name] = out.get(name, 0) + 1
        return out

    def walk(self, key: str) -> Iterator[str]:
        """Yield endpoint names in clockwise ring order starting at the
        position of ``xxh64(key)``; one yield per ring slot (an endpoint
        appears once per virtual node, matching the reference's walk)."""
        n = len(self._sorted)
        if n == 0:
            return
        start = bisect.bisect_left(self._sorted, xxh64(key))
        if start >= n:
            start = 0
        for off in range(n):
            yield self._hash_to_name[self._sorted[(start + off) % n]]


def chwbl_choose(
    ring: HashRing,
    key: str,
    load_factor: float,
    adapter: str,
    has_adapter: Callable[[str, str], bool],
    endpoint_load: Callable[[str], int],
    total_load: int,
    n_endpoints: int,
    allowed: Callable[[str], bool] | None = None,
    stats: dict | None = None,
) -> str | None:
    """Pick an endpoint name for *key*, honoring adapter capability and the
    bounded-load condition; falls back to the first servable endpoint
    (ref: balance_chwbl.go:14-84). *allowed* additionally filters endpoints
    (retry exclusion); callers fall back to allowed=None when it empties
    the candidate set. *stats*, when given, receives the lookup telemetry
    the reference exports (initial target, iterations, fallback use;
    ref: internal/metrics/metrics.go CHWBL instruments)."""
    fallback: str | None = None
    seen: set[str] = set()
    slots_walked = 0
    for name in ring.walk(key):
        slots_walked += 1
        if stats is not None and not seen:
            stats["initial"] = name
        # The walk yields one name per ring slot; loads can't change while
        # the group lock is held, so each distinct endpoint needs checking
        # only once (first occurrence preserves ring order).
        if name in seen:
            continue
        seen.add(name)
        servable = (allowed is None or allowed(name)) and (
            not adapter or has_adapter(name, adapter)
        )
        if servable:
            if fallback is None:
                fallback = name
            if load_ok(endpoint_load(name), total_load, n_endpoints, load_factor):
                if stats is not None:
                    # Reference semantics: ring slots walked on success
                    # (balance_chwbl.go:58 records n+1).
                    stats.update(final=name, iterations=slots_walked, default=False)
                return name
        if len(seen) == n_endpoints:
            break
    if stats is not None:
        # Reference semantics: the fallback path records the full ring size
        # (balance_chwbl.go:74).
        stats.update(final=fallback, iterations=len(ring), default=True)
    return fallback
