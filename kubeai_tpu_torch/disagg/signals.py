"""Per-pool autoscaling signals of a disaggregated Model (port of
kubeai_tpu/disagg/signals.py).

Prefill and decode saturate differently, so each pool's moving average
gets its own signal from the fleet collector's per-role aggregate:

- **prefill**: queue-wait pressure, requests queued in the prefill
  engines plus the slots prefilling, scaled as
  ``ceil(avg / prefillTargetQueue)``;
- **decode**: occupancy, the larger of slot and KV-page occupancy in
  percent, scaled proportionally as
  ``ceil(current * avg_pct / decodeTargetOccupancyPct)``.

Both are pure functions of one pool aggregate, so the decision record
holds exactly the numbers the decision used.
"""

from __future__ import annotations

import math

from kubeai_tpu_torch.api.model_types import Disaggregation


def prefill_signal(agg: dict) -> dict:
    """Queue-wait pressure breakdown for a prefill pool aggregate (the
    fleet collector's per-role sum). ``combined`` is the value the
    moving average ingests."""
    queue = float(agg.get("queue_depth", 0.0))
    active = float(agg.get("active_slots", 0.0))
    return {
        "queue_wait": round(queue, 3),
        "active": round(active, 3),
        "combined": round(queue + active, 3),
    }


def decode_signal(agg: dict) -> dict:
    """Occupancy-percentage breakdown for a decode pool aggregate.
    ``combined`` = max(slot%, kv%) — whichever resource binds first is
    the one that must buy headroom. Unknown capacities read 0 (an
    unreachable pool is handled by the caller, not guessed at here)."""
    slots_total = float(agg.get("slots_total", 0.0))
    pages_total = float(agg.get("pages_total", 0.0))
    slot_pct = (
        100.0 * float(agg.get("active_slots", 0.0)) / slots_total
        if slots_total > 0
        else 0.0
    )
    kv_pct = (
        100.0 * float(agg.get("pages_used", 0.0)) / pages_total
        if pages_total > 0
        else 0.0
    )
    return {
        "slot_occupancy_pct": round(slot_pct, 3),
        "kv_occupancy_pct": round(kv_pct, 3),
        "combined": round(max(slot_pct, kv_pct), 3),
    }


def desired_prefill(window_avg: float, dz: Disaggregation) -> int:
    """Replicas to spread the averaged queue-wait load at the configured
    per-replica target. Floor 1: pools never scale to zero (v1)."""
    target = max(dz.prefill_target_queue, 1)
    return max(math.ceil(window_avg / target), 1)


def desired_decode(window_avg_pct: float, current: int, dz: Disaggregation) -> int:
    """Proportional occupancy control: size the pool so the averaged
    occupancy lands at the target. ``current`` is the pool size the
    observed occupancy was measured AT — occupancy is per-capacity, so
    desired scales the current size, unlike the prefill work-count
    rule."""
    target = max(min(dz.decode_target_occupancy_pct, 100), 1)
    current = max(current, 1)
    return max(math.ceil(current * window_avg_pct / target), 1)
