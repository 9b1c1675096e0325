"""Fixed-window moving average of the autoscaler (port of
kubeai_tpu/autoscaler/movingaverage.py).

A fixed-size history that the caller seeds, overwritten round-robin,
whose average can decay to exactly zero: the property that lets a Model
scale to zero.
"""

from __future__ import annotations

import threading
from typing import Sequence


class SimpleMovingAverage:
    """Thread-safe fixed-window moving average over a seeded ring buffer."""

    def __init__(self, seed: Sequence[float]):
        if not seed:
            raise ValueError("seed must be non-empty")
        self._lock = threading.Lock()
        self._history = list(seed)
        self._index = 0

    def next(self, value: float) -> None:
        with self._lock:
            self._history[self._index] = value
            self._index = (self._index + 1) % len(self._history)

    def history(self) -> list[float]:
        with self._lock:
            return list(self._history)

    def calculate(self) -> float:
        with self._lock:
            return sum(self._history) / len(self._history)
