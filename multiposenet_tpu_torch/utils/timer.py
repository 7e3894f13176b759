"""tic/toc timer with a running average (reference lib/utils/timer.py:11-44)
— the port's copy of multiposenet_tpu/utils/timer.py."""

import time


class Timer:
    def __init__(self):
        self.clear()

    def clear(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.duration = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.duration = time.perf_counter() - self.start_time
        self.total_time += self.duration
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.duration
