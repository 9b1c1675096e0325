"""Schedule shrinking (port of kubeai_tpu/chaos/shrink.py): ddmin (Zeller)
over a violating schedule's events. *test* re-runs a candidate on the
live stack; runs are not perfectly deterministic (thread interleaving),
so the result is a minimal schedule that reproduced at least once, within
*max_runs* runs.
"""

from __future__ import annotations

from typing import Callable, Sequence

from .schedule import FaultEvent


def ddmin(events: Sequence[FaultEvent],
          test: Callable[[list[FaultEvent]], bool],
          max_runs: int = 40) -> tuple[list[FaultEvent], int]:
    """Minimize *events* while ``test(subset)`` stays True (violation
    reproduces). Returns (minimal_events, runs_used). ``test`` is never
    called on the full input (the caller already observed it failing)
    or on the empty list."""
    current = list(events)
    runs = 0
    n = 2
    while len(current) >= 2 and runs < max_runs:
        chunk = max(1, len(current) // n)
        subsets = [current[i:i + chunk] for i in range(0, len(current), chunk)]
        reduced = False
        # Try each chunk alone (smallest candidates first)...
        for sub in subsets:
            if len(sub) == len(current):
                continue
            runs += 1
            if test(list(sub)):
                current = list(sub)
                n = 2
                reduced = True
                break
            if runs >= max_runs:
                break
        if reduced or runs >= max_runs:
            continue
        # ...then each complement.
        if n < len(current):
            for i in range(len(subsets)):
                comp = [e for j, s in enumerate(subsets) if j != i for e in s]
                if not comp or len(comp) == len(current):
                    continue
                runs += 1
                if test(comp):
                    current = comp
                    n = max(2, n - 1)
                    reduced = True
                    break
                if runs >= max_runs:
                    break
        if not reduced:
            if n >= len(current):
                break
            n = min(len(current), n * 2)
    return current, runs
