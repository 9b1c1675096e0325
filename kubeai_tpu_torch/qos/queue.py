"""QoSQueue: the class-aware admission queue behind the engine (port of
kubeai_tpu/qos/queue.py).

The surface of ``queue.Queue`` that the scheduler uses (put_nowait,
get_nowait, qsize, with ``queue.Full`` and ``queue.Empty``), with:

- strict class priority across lanes: interactive, then standard, then
  batch;
- deficit round-robin over per-tenant lanes within a class, charged in
  prompt tokens; lanes are bounded (KUBEAI_QOS_TENANT_LANES) and overflow
  tenants fold into ``__other__``;
- class-aware shedding: batch is refused once the queue passes
  KUBEAI_QOS_SHED_BATCH of maxsize (default 50%), standard at
  KUBEAI_QOS_SHED_STANDARD (85%), interactive only at the hard cap;
- per-class queue-wait budgets (KUBEAI_QOS_BUDGET_*), swept by the
  scheduler.

HTTP threads put, the scheduler thread gets; one lock guards the lanes.
"""

from __future__ import annotations

import math
import queue as stdqueue
import threading
import time
from collections import deque

from kubeai_tpu_torch import env_float
from kubeai_tpu_torch.qos.classes import ANONYMOUS, CLASSES, DEFAULT_CLASS, OTHER, rank
from kubeai_tpu_torch.qos.stats import M_BUDGET_DROPS, M_DEFICIT, M_DEPTH, M_REQS, M_SHED

_SHED_DEFAULTS = {"interactive": 1.0, "standard": 0.85, "batch": 0.5}


def _shed_fraction(cls: str) -> float:
    frac = env_float("KUBEAI_QOS_SHED_" + cls.upper(), _SHED_DEFAULTS[cls])
    return min(max(frac, 0.0), 1.0)


def _class_budget(cls: str) -> float:
    """Seconds a request of this class may wait in the queue; 0 = no
    budget."""
    return max(env_float("KUBEAI_QOS_BUDGET_" + cls.upper(), 0.0), 0.0)


class QoSQueue:
    def __init__(self, maxsize: int = 0, *, quantum: float | None = None,
                 topk: int | None = None):
        self.maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._quantum = (float(quantum) if quantum is not None
                         else max(env_float("KUBEAI_QOS_QUANTUM_TOKENS", 2048.0), 1.0))
        self._topk = int(topk if topk is not None else env_float("KUBEAI_QOS_TENANT_LANES", 32.0))
        # Per class: tenant lane -> FIFO of requests, the round-robin order
        # of lanes, and each lane's deficit (prompt tokens).
        self._lanes: dict[str, dict[str, deque]] = {c: {} for c in CLASSES}
        self._rr: dict[str, deque] = {c: deque() for c in CLASSES}
        self._deficit: dict[str, dict[str, float]] = {c: {} for c in CLASSES}
        self._size = 0
        self._class_size = {c: 0 for c in CLASSES}
        self._sheds = {c: 0 for c in CLASSES}
        self._budget_drops = {c: 0 for c in CLASSES}
        self._last_budget_sweep = 0.0

    # -- queue.Queue surface -------------------------------------------

    def put_nowait(self, req) -> None:
        cls = getattr(req, "priority", "") or DEFAULT_CLASS
        if cls not in self._lanes:
            cls = DEFAULT_CLASS
        with self._lock:
            if self.maxsize > 0:
                frac = _shed_fraction(cls)
                # Rounded up: shedding starts once the queue passes the
                # fraction.
                cap = (self.maxsize if frac >= 1.0
                       else min(max(math.ceil(self.maxsize * frac), 1), self.maxsize))
                if self._size >= cap:
                    self._sheds[cls] += 1
                    M_SHED.inc(labels={"class": cls})
                    raise stdqueue.Full
            lane = self._lane_key(cls, getattr(req, "tenant", ""))
            lanes = self._lanes[cls]
            if lane not in lanes:
                lanes[lane] = deque()
                self._rr[cls].append(lane)
                self._deficit[cls][lane] = 0.0
            lanes[lane].append(req)
            self._size += 1
            self._class_size[cls] += 1
            depth = self._class_size[cls]
        M_REQS.inc(labels={"class": cls})
        M_DEPTH.set(depth, labels={"class": cls})

    def get_nowait(self):
        with self._lock:
            for cls in CLASSES:
                if self._class_size[cls] <= 0:
                    continue
                req = self._pop_drr(cls)
                if req is None:
                    continue
                self._size -= 1
                self._class_size[cls] -= 1
                M_DEPTH.set(self._class_size[cls], labels={"class": cls})
                return req
        raise stdqueue.Empty

    def qsize(self) -> int:
        with self._lock:
            return self._size

    # -- class-aware extras --------------------------------------------

    def peek_priority(self) -> str | None:
        """Class of the request get_nowait would serve next, or None."""
        with self._lock:
            for cls in CLASSES:
                if self._class_size[cls] > 0:
                    return cls
        return None

    def outranks(self, priority: str) -> bool:
        """True when a queued request's class strictly outranks
        *priority*."""
        with self._lock:
            for cls in CLASSES:
                if rank(cls) >= rank(priority):
                    return False
                if self._class_size[cls] > 0:
                    return True
        return False

    def backlog_at_or_above(self, priority: str) -> int:
        """Queued requests served at or before *priority*: the backlog a
        shed client of that class waits behind."""
        with self._lock:
            return sum(n for cls, n in self._class_size.items() if rank(cls) <= rank(priority))

    def sweep_budgets(self, now: float | None = None) -> list:
        """Drop and return the queued requests whose class budget expired
        (rate-limited to one scan per 0.25 s)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._last_budget_sweep < 0.25:
                return []
            self._last_budget_sweep = now
            dropped = []
            for cls in CLASSES:
                budget = _class_budget(cls)
                if budget <= 0 or self._class_size[cls] <= 0:
                    continue
                lanes = self._lanes[cls]
                for lane in list(lanes):
                    dq = lanes[lane]
                    keep = deque()
                    for req in dq:
                        if now - getattr(req, "arrival", now) > budget:
                            dropped.append((cls, req))
                        else:
                            keep.append(req)
                    if len(keep) != len(dq):
                        lanes[lane] = keep
                        if not keep:
                            self._retire_lane(cls, lane)
                n = sum(1 for c, _ in dropped if c == cls)
                if n:
                    self._size -= n
                    self._class_size[cls] -= n
                    self._budget_drops[cls] += n
                    M_BUDGET_DROPS.inc(n, labels={"class": cls})
                    M_DEPTH.set(self._class_size[cls], labels={"class": cls})
        return [req for _, req in dropped]

    def snapshot(self) -> dict:
        with self._lock:
            per_class = {
                cls: {
                    "depth": self._class_size[cls],
                    "shed": self._sheds[cls],
                    "budget_drops": self._budget_drops[cls],
                    "budget_seconds": _class_budget(cls),
                    "lanes": {lane: {"depth": len(dq),
                                     "deficit_tokens": round(self._deficit[cls].get(lane, 0.0), 1)}
                              for lane, dq in self._lanes[cls].items() if dq},
                }
                for cls in CLASSES
            }
            return {"depth": self._size, "maxsize": self.maxsize,
                    "quantum_tokens": self._quantum, "tenant_lanes_max": self._topk,
                    "per_class": per_class}

    # -- internals (lock held) -----------------------------------------

    def _lane_key(self, cls: str, tenant: str) -> str:
        t = tenant or ANONYMOUS
        lanes = self._lanes[cls]
        if t in lanes or len(lanes) < self._topk:
            return t
        return OTHER

    @staticmethod
    def _cost(req) -> float:
        try:
            return float(max(len(req.prompt_ids), 1))
        except (AttributeError, TypeError):
            return 1.0

    def _retire_lane(self, cls: str, lane: str) -> None:
        self._lanes[cls].pop(lane, None)
        self._deficit[cls].pop(lane, None)
        try:
            self._rr[cls].remove(lane)
        except ValueError:
            pass
        M_DEFICIT.remove(labels={"class": cls, "tenant": lane})

    def _pop_drr(self, cls: str):
        """One request of this class by deficit round-robin: a lane's turn
        lasts while its deficit covers the head request's prompt tokens;
        otherwise it earns a quantum and goes to the back."""
        rr = self._rr[cls]
        lanes = self._lanes[cls]
        deficit = self._deficit[cls]
        spins = 0
        while rr:
            lane = rr[0]
            dq = lanes.get(lane)
            if not dq:
                self._retire_lane(cls, lane)
                continue
            cost = self._cost(dq[0])
            force = spins > 64 * max(len(rr), 1)
            if deficit.get(lane, 0.0) < cost and not force:
                deficit[lane] = deficit.get(lane, 0.0) + self._quantum
                rr.rotate(-1)
                spins += 1
                continue
            req = dq.popleft()
            deficit[lane] = max(deficit.get(lane, 0.0) - cost, 0.0)
            if not dq:
                self._retire_lane(cls, lane)
            else:
                M_DEFICIT.set(deficit[lane], labels={"class": cls, "tenant": lane})
            return req
        return None
