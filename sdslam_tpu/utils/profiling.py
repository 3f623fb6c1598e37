"""Tracing / profiling / structured metrics.

The reference's only instrumentation is a gettimeofday stopwatch printed via
LOGD (extra/timer.h, System.cc:125-130). Here: the same lightweight stage
timer, plus a per-frame structured metrics recorder and a jax.profiler
context for xprof-compatible device traces (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

log = logging.getLogger("sdslam_tpu")


class Timer:
    """extra/timer.h equivalent: start/stop stopwatch in milliseconds."""

    def __init__(self, start: bool = False):
        self._t0 = time.perf_counter() if start else None
        self.elapsed_ms = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is not None:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
            self._t0 = None
        return self.elapsed_ms


class StageTimes:
    """Accumulates per-stage wall times across frames."""

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

    def summary(self) -> Dict[str, float]:
        return {
            k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.1f}ms" for k, v in self.summary().items())


class FrameMetrics:
    """Structured per-frame metrics (inliers, timings, map size) with JSONL
    export — this build's replacement for LOGD state lines."""

    def __init__(self):
        self.rows: List[dict] = []

    def record(self, **kv):
        self.rows.append(kv)

    def save_jsonl(self, path: str):
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")

    def column(self, key):
        return [r.get(key) for r in self.rows]


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """jax.profiler trace (view with xprof/tensorboard). No-op if logdir is
    None."""
    if logdir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
