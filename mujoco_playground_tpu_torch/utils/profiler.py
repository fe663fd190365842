"""Profiling hooks: a ``torch.profiler`` trace of a block and a rolling
env-steps/s counter (the port of the JAX package's ``utils/profiler.py``)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: str):
    """Profile a block with ``torch.profiler`` (the host, and the CUDA
    device where one exists) and write a Chrome trace, ``trace.json``, into
    ``log_dir`` (open it in Perfetto or chrome://tracing).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling env-steps/s counter."""

    def __init__(self, steps_per_iter: int, ema: float = 0.9):
        self.steps_per_iter = steps_per_iter
        self.ema = ema
        self._rate: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.time()
        if self._last is not None:
            inst = self.steps_per_iter / (now - self._last)
            self._rate = (inst if self._rate is None
                          else self.ema * self._rate + (1 - self.ema) * inst)
        self._last = now
        return self._rate or 0.0
