"""Latency accounting (counterpart of ``can_tpu/utils/profiling.py:112``,
``StepTimer`` only, as far as serving uses it)."""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np


class StepTimer:
    """Bounded reservoir of the most recent ``reservoir`` samples with
    p50/p95/max (for telemetry the RECENT distribution is the one that
    predicts the next hour)."""

    def __init__(self, reservoir: int = 4096):
        self._samples = collections.deque(maxlen=max(int(reservoir), 1))

    def record(self, dt: float) -> float:
        """Record an externally measured sample (e.g. a request latency
        measured across threads)."""
        self._samples.append(dt)
        return dt

    def percentiles(self) -> dict:
        """``{n, p50_s, p95_s, max_s}`` over the reservoir; Nones when
        nothing has been recorded yet."""
        if not self._samples:
            return {"n": 0, "p50_s": None, "p95_s": None, "max_s": None}
        arr = np.asarray(self._samples, np.float64)
        return {"n": int(arr.size),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "max_s": float(arr.max())}

    def percentile(self, q: float) -> Optional[float]:
        """One percentile over the reservoir (None when empty) — the
        autoscaler reads p99 here."""
        if not self._samples:
            return None
        return float(np.percentile(np.asarray(self._samples, np.float64), q))
