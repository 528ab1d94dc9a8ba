"""Profiling hooks: ``torch.profiler`` traces, step timing and the CUDA
start-up watchdog (counterpart of ``can_tpu/utils/profiling.py``).

* ``profile_trace(dir)`` records the whole run under ``torch.profiler``
  (CPU and, once CUDA is up, CUDA activities) and writes one Chrome
  trace into ``dir`` (``chrome://tracing`` / Perfetto);
* ``StepTimer`` measures step times: rolling mean, a bounded reservoir
  (p50/p95/max), per-shape totals (the cost ledger's feed) and the
  per-window drain of the ``step_window`` events.  ``stop(result)``
  fences on the device: a device-to-host fetch of ``result``;
* ``device_watchdog`` / ``await_devices`` fail fast when CUDA's start-up
  hangs (a wedged driver blocks ``torch.cuda.init()`` forever, the way a
  dead accelerator link blocks the JAX package's ``jax.devices()``);
  ``emit_null_result`` leaves a machine-readable null result behind.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Optional

import numpy as np


def device_watchdog(seconds: float = 300.0, on_timeout=None):
    """Fail FAST if CUDA start-up hangs.

    Arm this BEFORE the first CUDA call and ``.set()`` the returned event
    once the devices answered; if it isn't set within ``seconds`` the
    process prints one clear stderr line and exits 3.  ``on_timeout``:
    optional callback run before the exit (a benchmark's null result);
    exceptions in it are swallowed — the exit must happen regardless."""
    armed = threading.Event()

    def boom():
        if not armed.wait(seconds):
            # re-check after the wait: the devices may have answered just
            # before the deadline with armed.set() not yet executed — one
            # grace second closes that race; a hung start-up cannot set it
            if armed.wait(1.0):
                return
            import sys

            if on_timeout is not None:
                try:
                    on_timeout()
                # can-tpu-lint: disable=SWALLOW(process is about to _exit(3); the fatal print below is the record)
                except Exception:
                    pass
            print(f"[watchdog] FATAL: no CUDA device within {seconds:.0f}s "
                  f"— accelerator backend unreachable", file=sys.stderr,
                  flush=True)
            os._exit(3)

    threading.Thread(target=boom, daemon=True).start()
    return armed


def emit_null_result(metric: str, **extra):
    """on_timeout callback factory for benchmark entry points: print one
    machine-readable null-result line before the watchdog exit, so the
    artifact says WHY there is no number.  Usage:
    ``await_devices(on_timeout=emit_null_result(...))``."""

    def emit():
        import json

        print(json.dumps(dict(
            {"metric": metric, "value": None,
             "error": "accelerator backend unreachable (watchdog timeout)"},
            **extra)), flush=True)

    return emit


def await_devices(seconds: float = 300.0, on_timeout=None) -> list:
    """Arm the watchdog, start CUDA (``torch.cuda.init()`` and the device
    count), disarm; returns the devices (``[cpu]`` where no CUDA device
    is visible).  Disarms in ``finally``: a start-up that RAISES must not
    leave the timer to kill the caller's fallback path later."""
    import torch

    armed = device_watchdog(seconds, on_timeout=on_timeout)
    try:
        if not torch.cuda.is_available():
            return [torch.device("cpu")]
        torch.cuda.init()
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    finally:
        armed.set()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace (CPU and, where a card is
    initialised, CUDA activities) into ``log_dir`` as one Chrome trace
    file (no-op if None or empty): the session of the step trace window
    (``obs.trace.TorchProfiler``), open for the whole block."""
    if not log_dir:
        yield
        return
    from can_tpu_torch.obs.trace import TorchProfiler

    prof = TorchProfiler()
    prof.start_trace(log_dir)
    try:
        yield
    finally:
        prof.stop_trace()


def _fence(result) -> None:
    """Wait for the device work behind ``result``: one device-to-host
    fetch of its first tensor (the fetch waits for every kernel queued
    before it on that stream)."""
    import torch

    leaves = result.values() if isinstance(result, dict) else (
        result if isinstance(result, (list, tuple)) else (result,))
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf.reshape(-1)[:1].cpu()
            return


class StepTimer:
    """Step wall-time accounting: rolling mean, bounded sample reservoir
    (p50/p95/max), and optional per-shape-bucket breakdown.

    The first ``skip_first`` samples are excluded from every statistic
    (they carry first-call set-up; ``mean`` is NaN until a post-skip
    sample lands).  The reservoir keeps the most recent ``reservoir``
    samples (for telemetry the RECENT distribution is the one that
    predicts the next hour).  ``stop(shape=...)`` tags the sample with
    its batch bucket so a bimodal p95 can be attributed to the bucket
    causing it."""

    def __init__(self, skip_first: int = 2, reservoir: int = 4096):
        self.skip_first = skip_first
        self._count = 0
        self._total = 0.0
        self._last: Optional[float] = None
        self._samples = collections.deque(maxlen=max(int(reservoir), 1))
        self._window: list = []  # samples since the last drain_window()
        self._shapes: dict = {}  # shape -> [count, total_s]

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, result=None, *, shape=None, record: bool = True) -> float:
        """Fence on ``result`` (if given) and record the elapsed time.

        In an asynchronous loop, call WITHOUT ``result``: the sample is
        then the host-side step interval (the window's metric fetch
        absorbs the device sync), whose sum over a window is honest wall
        time.  ``record=False`` measures but records nothing — for a
        first call, accounted by its own ``compile`` event."""
        if self._last is None:
            raise RuntimeError("StepTimer.stop() before start()")
        if result is not None:
            _fence(result)
        dt = time.perf_counter() - self._last
        self._last = None
        if not record:
            return dt
        return self.record(dt, shape=shape)

    def record(self, dt: float, *, shape=None) -> float:
        """Record an externally measured sample (e.g. a request latency
        measured across threads).  Same reservoir, window, skip_first and
        per-shape accounting as ``stop``."""
        self._count += 1
        if self._count > self.skip_first:
            self._total += dt
            self._samples.append(dt)
            self._window.append(dt)
            if shape is not None:
                rec = self._shapes.setdefault(shape, [0, 0.0])
                rec[0] += 1
                rec[1] += dt
        return dt

    @property
    def mean(self) -> float:
        n = self._count - self.skip_first
        return self._total / n if n > 0 else float("nan")

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

    def shape_totals(self) -> dict:
        """Raw per-shape accounting, ``{shape: (n, total_s)}`` — the
        lossless feed of the cost ledger (``shape_summary`` rounds)."""
        return {shape: (n, total) for shape, (n, total)
                in self._shapes.items()}

    def shape_summary(self) -> dict:
        """Per-bucket breakdown: ``{shape_str: {n, total_s, mean_s}}``."""
        return {str(shape): {"n": n, "total_s": round(total, 4),
                             "mean_s": round(total / n, 6)}
                for shape, (n, total) in sorted(self._shapes.items(),
                                                key=lambda kv: str(kv[0]))}

    def drain_window(self) -> list:
        """Return (and reset) the samples recorded since the last drain —
        the per-window payload of ``step_window`` events."""
        window, self._window = self._window, []
        return window
