"""Step-range profiler trigger: trace a WINDOW instead of the whole run
(counterpart of ``can_tpu/obs/trace.py``).

``profile_trace`` (utils/profiling.py) wraps the entire run — fine for a
smoke run, useless for "steady-state steps 10..12 of a 10-hour job" where
a whole-run trace is gigabytes of mostly-identical timelines.  Here a
``torch.profiler`` session (CPU and CUDA activities) is armed by the
run-local step counter: the CLIs' ``--trace-steps A:B`` (python slice
semantics: first traced step A, first untraced step B) starts the
profiler when step A begins and stops it when step B begins, so the one
Chrome trace it writes into ``--profile-dir`` holds exactly ``B - A``
steps.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple


def parse_trace_steps(spec: str) -> Optional[Tuple[int, int]]:
    """``"10:13"`` -> ``(10, 13)``; empty/None -> None.  Slice semantics:
    steps ``[10, 13)`` are traced.  Raises ValueError on malformed specs
    (argparse ``type=`` surfaces it as a usage error before any work)."""
    if not spec:
        return None
    try:
        lo_s, hi_s = spec.split(":")
        lo, hi = int(lo_s), int(hi_s)
    except ValueError:
        raise ValueError(
            f"--trace-steps wants START:STOP (e.g. 10:13), got {spec!r}")
    if lo < 0 or hi <= lo:
        raise ValueError(
            f"--trace-steps window must satisfy 0 <= START < STOP, "
            f"got {spec!r}")
    return lo, hi


# A session's first kernels may leave no record: on the H100 those of its
# first 0-68 ms (none in a fresh process, 18-68 ms some minutes into one;
# PERF.md §6, PR 12).  The session warms up on tiny kernels, one every
# WARMUP_PERIOD_S for WARMUP_S, before the first traced step launches
WARMUP_S = 0.5
WARMUP_PERIOD_S = 0.005


class TorchProfiler:
    """``start_trace(log_dir)`` / ``stop_trace()`` over ``torch.profiler``
    (the interface of ``jax.profiler`` the window drives): one profiling
    session, written as one Chrome trace into ``log_dir`` when it stops.
    Where CUDA is initialised the device's activity is recorded too, and
    both edges wait for the device: the window opens on an idle card (no
    kernel of an earlier step straddles its start), warms up (WARMUP_S)
    so the first traced step's kernels are all recorded, and the last
    traced step's kernels land before it closes."""

    def __init__(self):
        self._prof = None
        self._log_dir = None
        self.path: Optional[str] = None

    def start_trace(self, log_dir: str) -> None:
        import torch

        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        os.makedirs(log_dir, exist_ok=True)
        self._log_dir = log_dir
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        if cuda:
            tick = torch.zeros(1, device="cuda")
            end = time.perf_counter() + WARMUP_S
            while time.perf_counter() < end:
                tick.add_(1)
                torch.cuda.synchronize()
                time.sleep(WARMUP_PERIOD_S)

    def stop_trace(self) -> None:
        import torch

        prof, self._prof = self._prof, None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        self.path = os.path.join(
            self._log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(self.path)


class StepTraceWindow:
    """Start/stop a ``torch.profiler`` trace on run-local step boundaries.

    ``on_step(step)`` is called once per step (step counts from 1, see
    ``Telemetry.step_tick``; the window is interpreted on the 0-based step
    ORDINAL, so ``--trace-steps 0:2`` traces the first two steps).  Safe to
    call after the window has passed — both branches are a pair of integer
    compares.  ``close()`` stops a still-open trace (a window extending
    past the last step must still flush its file).  ``profiler``: the
    test seam, an object with ``start_trace(log_dir)`` / ``stop_trace()``
    (default ``TorchProfiler()``)."""

    def __init__(self, log_dir: str, start: int, stop: int,
                 *, profiler=None):
        if not log_dir:
            raise ValueError("StepTraceWindow needs a log_dir "
                             "(pass --profile-dir with --trace-steps)")
        self.log_dir = log_dir
        self.start = int(start)
        self.stop = int(stop)
        self._active = False
        self._done = False
        self._profiler = profiler

    def _torch_profiler(self):
        if self._profiler is None:
            self._profiler = TorchProfiler()
        return self._profiler

    def on_step(self, step: int) -> None:
        ordinal = step - 1  # step_tick counts from 1
        if (not self._active and not self._done
                and self.start <= ordinal < self.stop):
            self._torch_profiler().start_trace(self.log_dir)
            self._active = True
        elif self._active and ordinal >= self.stop:
            self._stop_trace()

    def _stop_trace(self) -> None:
        try:
            self._torch_profiler().stop_trace()
        finally:
            self._active = False
            self._done = True  # one window per run: never re-arm

    def close(self) -> None:
        if self._active:
            self._stop_trace()
