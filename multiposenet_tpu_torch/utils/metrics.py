"""Structured metrics log — the port's copy of
multiposenet_tpu/utils/metrics.py.

``MetricsWriter`` writes every scalar the train and val steps emit as one
JSON object per line of ``metrics.jsonl`` (grep-able, survives a crash) and,
when ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package), mirrors them to TensorBoard event files under ``tb/``; without it
there is no mirror, as the JAX package has none without TensorFlow.
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

