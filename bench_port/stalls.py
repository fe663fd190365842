"""Where a window's long steps come from, for the run's ``info``: the
longest completion gaps, the longest host enqueues and waits, the
collector's passes and the CPU time the process got.  Diagnostics only:
no metric reads them."""
from __future__ import annotations

import gc
import time

TOP = 3


def _top(values):
    """The ``TOP`` largest values, each (ms, index)."""
    return sorted(((round(v, 3), i) for i, v in enumerate(values)),
                  reverse=True)[:TOP]


class Watch:
    """Reads the process around a window."""

    def __enter__(self):
        self.gc_s, self.gc_passes, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._on_gc)
        self.cpu0 = time.process_time()
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_passes[info["generation"]] += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        self.cpu_s = time.process_time() - self.cpu0

    def report(self, gaps, stamps) -> dict:
        enqueue = [(b - a) * 1e3 for a, b in stamps]
        wait = [(stamps[k + 1][0] - stamps[k][1]) * 1e3
                for k in range(len(stamps) - 1)]
        return dict(longest_gaps_ms=_top(gaps),
                    longest_enqueues_ms=_top(enqueue),
                    longest_waits_ms=_top(wait), cpu_s=self.cpu_s,
                    gc_s=self.gc_s, gc_passes=self.gc_passes)
