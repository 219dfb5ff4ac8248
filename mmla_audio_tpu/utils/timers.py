"""Profiling: stage timers, RTF counters, jax.profiler integration.

The reference's tracing is ad-hoc ``time.time()`` prints
(`overlap_detector_run.py:21-72`, `record_on_pi.py:63-69`).  Here: a
``StageTimer`` accumulating per-stage wall clock + an ``RtfMeter`` computing
the BASELINE metrics (real-time factor, p50 window-to-decision), and a
context manager around ``jax.profiler.trace`` for device traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import numpy as np

__all__ = ["StageTimer", "RtfMeter", "device_trace"]


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1000.0 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


class RtfMeter:
    """Track decisions: audio seconds processed vs wall clock."""

    def __init__(self, window_seconds: float):
        self.window_seconds = window_seconds
        self.latencies: list[float] = []   # wall seconds per step
        self.windows: list[int] = []       # windows decided per step

    @contextlib.contextmanager
    def window(self, batch: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0, batch)

    def record(self, seconds: float, batch: int = 1):
        self.latencies.append(seconds)
        self.windows.append(batch)

    @property
    def rtf(self) -> float:
        if not self.latencies:
            return 0.0
        audio = self.window_seconds * sum(self.windows)
        return audio / sum(self.latencies)

    @property
    def p50_ms(self) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies) * 1000.0, 50))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
