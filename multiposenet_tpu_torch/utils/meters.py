"""Streaming scalar meters (reference lib/utils/meter.py:16-43) — the port's
copy of multiposenet_tpu/utils/meters.py."""

from __future__ import annotations

import math


class AverageValueMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.var = 0.0

    def add(self, value: float, n: int = 1):
        self.sum += value * n
        self.var += value * value * n
        self.n += n

    def value(self):
        """(mean, standard deviation) of the values added so far."""
        if self.n == 0:
            return float("nan"), float("nan")
        mean = self.sum / self.n
        if self.n == 1:
            return mean, float("inf")
        var = (self.var - self.n * mean * mean) / (self.n - 1.0)
        return mean, math.sqrt(max(var, 0.0))
