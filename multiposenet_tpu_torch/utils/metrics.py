"""Structured metrics log: every scalar the train and val steps emit, one
JSON object per line in ``metrics.jsonl`` (grep-able, survives a crash).
The JAX package's writer also mirrors them to TensorBoard through
TensorFlow; the port has no such mirror."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                       buffering=1)

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
