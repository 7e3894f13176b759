"""Structured metrics log and a profiler window — the port's copy of
multiposenet_tpu/utils/metrics.py.

``MetricsWriter`` writes every scalar the train and val steps emit as one
JSON object per line of ``metrics.jsonl`` (grep-able, survives a crash) and,
when ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package), mirrors them to TensorBoard event files under ``tb/``; without it
there is no mirror, as the JAX package has none without TensorFlow.
``StepProfiler`` traces the steps ``[start, start + count)`` with
``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                       buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, global_step=int(step))
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepProfiler:
    """A ``torch.profiler`` window over the steps ``[start_step, start_step +
    num_steps)``: call ``step(i)`` before each step i.  At the window's end
    the trace is written to ``log_dir/trace_steps_{start}_{stop}.json``
    (Chrome trace format: Perfetto or chrome://tracing), with the CUDA
    activity when a GPU is present."""

    def __init__(self, log_dir: str, start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None
        self.trace_path = None

    def step(self, step: int):
        import torch

        if step == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= self.stop and self._prof is not None:
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self.log_dir, f"trace_steps_{self.start}_{self.stop}.json")
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
