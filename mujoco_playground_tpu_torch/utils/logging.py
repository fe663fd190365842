"""Structured metrics logging (JSONL): the port of the JAX package's
``utils/logging.py``, with the same record format."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    """Append-only JSONL metrics log, one record per call."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "wall_time": time.time() - self._t0}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
