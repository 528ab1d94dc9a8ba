"""The port's profiling hooks (``can_tpu_torch/utils/profiling.py``) and
step trace window (``can_tpu_torch/obs/trace.py``) against the JAX
package's on the CPU.

* ``parse_trace_steps`` accepts and refuses the same specs with the same
  messages; ``StepTraceWindow`` driven by a fake profiler starts and stops
  on the same step ordinals as JAX's; one real ``torch.profiler`` window
  (and ``profile_trace``'s whole-run trace) writes a Chrome trace file;
  ``validate_trace_args`` refuses what JAX's refuses.
* ``StepTimer`` fed the same samples gives JAX's mean, percentiles,
  per-shape totals and windows; ``stop(result)`` fences on a tensor.
* The start-up watchdog (the oracle is tests/test_cli.py's
  TestDeviceWatchdog): a hang exits 3 with the on_timeout line first, a
  broken callback does not mask the exit, and ``await_devices`` disarms
  both when the devices answer and when start-up raises.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from can_tpu import obs as jobs
from can_tpu.cli.train import validate_trace_args as jvalidate
from can_tpu.utils.profiling import StepTimer as JaxStepTimer
from can_tpu_torch import obs as tobs
from can_tpu_torch.cli.train import validate_trace_args as tvalidate
from can_tpu_torch.utils import StepTimer, await_devices, profile_trace

ROOT = Path(__file__).resolve().parents[1]
SPECS = ("", "10:13", "0:1", "10", "a:b", "5:5", "-1:3", "7:2", "1:2:3", " 2:4")


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except (ValueError, SystemExit) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_trace_steps_equals_the_references(spec):
    got = _outcome(tobs.parse_trace_steps, spec)
    assert got == _outcome(jobs.parse_trace_steps, spec)


@pytest.mark.parametrize("spec,profile_dir", [
    ("", ""), ("2:4", "/tmp/p"), ("2:4", ""), ("nope", "/tmp/p"), ("4:2", "")])
def test_validate_trace_args_equals_the_references(spec, profile_dir):
    args = argparse.Namespace(trace_steps=spec, profile_dir=profile_dir)
    assert _outcome(tvalidate, args) == _outcome(jvalidate, args)


class FakeProfiler:
    def __init__(self):
        self.calls = []

    def start_trace(self, d):
        self.calls.append(("start", d))

    def stop_trace(self):
        self.calls.append(("stop",))


@pytest.mark.parametrize("window,steps", [
    ((2, 4), 8), ((0, 2), 3), ((0, 100), 1), ((3, 4), 3), ((5, 9), 9)])
def test_window_starts_and_stops_where_the_references_does(tmp_path, window, steps):
    """Both windows driven through a bus's step_tick, the step at which
    each call lands recorded; close() flushes a window still open."""
    got = {}
    for name, pkg in (("jax", jobs), ("port", tobs)):
        prof = FakeProfiler()
        w = pkg.StepTraceWindow(str(tmp_path), *window, profiler=prof)
        tel = pkg.Telemetry([], trace=w)
        seen = []
        for _ in range(steps):
            n = len(prof.calls)
            tel.step_tick()
            seen += [(tel.step, c[0]) for c in prof.calls[n:]]
        tel.close()
        got[name] = (seen, prof.calls)
    assert got["port"] == got["jax"]
    calls = got["port"][1]
    assert calls == ([] if steps <= window[0]
                     else [("start", str(tmp_path)), ("stop",)])


def test_window_needs_a_log_dir():
    with pytest.raises(ValueError, match="profile-dir"):
        tobs.StepTraceWindow("", 0, 2)


def _kernel_names(path):
    doc = json.loads(Path(path).read_text())
    return [e.get("name", "") for e in doc["traceEvents"]]


def test_real_torch_profiler_window_writes_one_trace(tmp_path):
    """Ordinals 1 and 2 of four steps traced: the trace holds their two
    step markers and not the others'."""
    w = tobs.StepTraceWindow(str(tmp_path), 1, 3)
    tel = tobs.Telemetry([], trace=w)
    for k in range(4):
        tel.step_tick()
        with torch.profiler.record_function(f"step_marker_{k}"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    tel.close()
    (trace,) = tmp_path.iterdir()
    names = _kernel_names(trace)
    marks = sorted(n for n in names if n.startswith("step_marker_"))
    assert marks == ["step_marker_1", "step_marker_2"]
    assert any(n == "aten::mm" for n in names)


def test_profile_trace_writes_the_whole_run(tmp_path):
    with profile_trace(str(tmp_path / "p")):
        torch.ones(3) + 1
    with profile_trace(""):  # off: nothing written
        torch.ones(3) + 1
    (trace,) = (tmp_path / "p").iterdir()
    assert "aten::add" in _kernel_names(trace)


# -- StepTimer --------------------------------------------------------------
@pytest.mark.parametrize("skip_first", [0, 2])
def test_step_timer_equals_the_references(skip_first):
    rng = np.random.default_rng(skip_first)
    timers = (StepTimer(skip_first=skip_first, reservoir=16),
              JaxStepTimer(skip_first=skip_first, reservoir=16))
    shapes = [(2, 64, 64, 3), (2, 64, 96, 3), None]
    windows = ([], [])
    for i in range(40):
        dt = float(rng.uniform(1e-3, 5e-2))
        shape = shapes[int(rng.integers(3))]
        for t in timers:
            t.record(dt, shape=shape)
        if i % 7 == 6:
            for t, win in zip(timers, windows):
                win.append(t.drain_window())
    port, ref = timers
    assert port.mean == ref.mean
    assert port.percentiles() == ref.percentiles()
    assert port.percentile(99) == ref.percentile(99)
    assert port.shape_totals() == ref.shape_totals()
    assert port.shape_summary() == ref.shape_summary()
    assert windows[0] == windows[1]
    empty = StepTimer()
    assert np.isnan(empty.mean) and empty.percentile(50) is None
    assert empty.percentiles() == JaxStepTimer().percentiles()


def test_step_timer_stop_fences_and_refuses_before_start():
    t = StepTimer(skip_first=0)
    with pytest.raises(RuntimeError, match="before start"):
        t.stop()
    t.start()
    dt = t.stop({"loss": torch.ones(3).sum()}, shape=(1, 8, 8, 3))
    assert dt >= 0 and t.shape_totals()[(1, 8, 8, 3)][0] == 1
    t.start()
    t.stop(torch.zeros(2), record=False)  # measured, not recorded
    assert t.percentiles()["n"] == 1


# -- the watchdog ------------------------------------------------------------
def _child(code: str):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=ROOT)


def test_await_devices_disarms():
    devices = await_devices(30)
    assert devices and all(isinstance(d, torch.device) for d in devices)


def test_watchdog_fires_and_exits_3():
    proc = _child("import time\n"
                  "from can_tpu_torch.utils import device_watchdog\n"
                  "device_watchdog(1.0)\n"
                  "time.sleep(30)\n"
                  "print('should never get here')\n")
    assert proc.returncode == 3, (proc.returncode, proc.stderr)
    assert "watchdog" in proc.stderr and "CUDA" in proc.stderr
    assert "should never" not in proc.stdout


def test_watchdog_on_timeout_emits_before_exit():
    code = ("import time\n"
            "from can_tpu_torch.utils import device_watchdog, emit_null_result\n"
            "device_watchdog(1.0, on_timeout=emit_null_result('m', card='x'))\n"
            "time.sleep(30)\n")
    proc = _child(code)
    assert proc.returncode == 3, (proc.returncode, proc.stderr)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "m" and line["value"] is None and line["card"] == "x"
    bad = code.replace("emit_null_result('m', card='x')", "lambda: 1 / 0")
    proc = _child(bad)
    assert proc.returncode == 3, (proc.returncode, proc.stderr)


def test_await_devices_disarms_on_exception():
    proc = _child("import time, torch\n"
                  "import can_tpu_torch.utils.profiling as prof\n"
                  "torch.cuda.is_available = lambda: (_ for _ in ()).throw("
                  "RuntimeError('refused'))\n"
                  "try:\n"
                  "    prof.await_devices(1.0)\n"
                  "except RuntimeError as e:\n"
                  "    assert 'refused' in str(e)\n"
                  "time.sleep(1.5)\n"
                  "print('survived')\n")
    assert proc.returncode == 0, (proc.returncode, proc.stderr)
    assert "survived" in proc.stdout
