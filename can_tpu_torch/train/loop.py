"""Host-side epoch loops (counterpart of ``can_tpu/train/loop.py:44-476``;
the elastic hook, ROADMAP Queue 1 item 6, comes with a later slice).

* Batches are loaded and put on the device ``prefetch`` batches ahead in
  a background thread (``data/prefetch.py``; 0 = synchronous).
* Metrics stay on the device and are fetched once per window of
  ``check_every`` steps — one host sync per window, never one per step.
* Under several processes each window's per-step (loss, images) rows are
  summed across processes (one host all-reduce per window) before
  anything reads them: every rank sees the global values.
* The non-finite check runs at that flush, on the global values, and
  raises ``NonFiniteLossError`` on every rank together (one rank raising
  alone would leave the others waiting in their next collective).
* Eval MAE/MSE divide by the true dataset size, not the padded schedule;
  the eval step's sums are global already
  (``parallel.data_parallel.make_dp_eval_step``).
* Each epoch's wall time and images/s are returned in ``EpochStats``.

With ``telemetry`` (an ``obs.Telemetry``) the loops emit the reference's
events: ``compile`` per new batch signature (``obs.RecompileTracker``:
its first call is timed, and with a cost ledger on the bus counted),
``step_window`` per metric flush (host-side step intervals, the window's
mean loss / grad_norm / update_norm), and at the epoch's end ``stall``,
a closing ``step_window`` with the percentiles and per-shape totals,
``memory`` and — with a ledger — ``perf.summary``.  Each step ticks the
bus (``Telemetry.step_tick``), which drives the step trace window.  With
a span tracer each train epoch is one trace: ``train_epoch`` with
``steps`` / ``metric_flush`` children per window and a synthesized
``fetch_stall``.  ``health`` (an ``obs.HealthMonitor``) reads the
fetched scalars, the windows' samples and the stall fraction.  With
``telemetry=None`` the loops run without any of it: no new sync, no new
launch.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Iterable, List, NamedTuple

import numpy as np
import torch

from can_tpu_torch.data.prefetch import prefetch_to_device
from can_tpu_torch.parallel.runtime import process_count, reduce_value
from can_tpu_torch.train.steps import NonFiniteLossError

HEALTH_KEYS = ("grad_norm", "update_norm")


class EpochStats(NamedTuple):
    """One epoch: mean per-image ``loss`` plus throughput.  ``images``
    counts valid samples (fill slots excluded); ``distinct_shapes`` counts
    the distinct batch shapes the step saw."""

    loss: float
    seconds: float = 0.0
    images: float = 0.0
    steps: int = 0
    distinct_shapes: int = 0

    @property
    def img_per_s(self) -> float:
        return self.images / self.seconds if self.seconds > 0 else 0.0

    @property
    def programs(self) -> int:
        """Realized program count: a bucket shape launched at several
        batch sizes is one program per size, so the (B, H, W) count is
        that number — checked against the planner's predicted
        ``program_count`` per epoch (``data.planner`` telemetry)."""
        return self.distinct_shapes


def _arm_telemetry(telemetry, step_fn, *, name: str):
    """Shared train/eval instrumentation setup.  Returns
    ``(wrapped_step_fn, timer, stall_clock)`` — the step as it is and
    Nones when telemetry is off."""
    if telemetry is None:
        return step_fn, None, None
    from can_tpu_torch.obs import RecompileTracker, StallClock
    from can_tpu_torch.utils.profiling import StepTimer

    # signatures live on the telemetry object, so re-wrapping every epoch
    # re-attributes nothing
    return (RecompileTracker(step_fn, telemetry, name=name),
            StepTimer(skip_first=0), StallClock())


def _emit_epoch_telemetry(telemetry, timer, stall, *, phase: str,
                          epoch: int, seconds: float,
                          health=None) -> None:
    """Epoch-boundary events: stall accounting, the step-time reservoir
    summary (per-shape breakdown included), a memory snapshot, and with a
    cost ledger on the bus the epoch's per-shape totals folded in and one
    ``perf.summary``.  ``health`` escalates over-budget starvation into a
    ``health.alert``."""
    from can_tpu_torch.obs import emit_memory

    stall_frac = (round(stall.seconds / seconds, 4) if seconds > 0 else 0.0)
    telemetry.emit("stall", phase=phase, epoch=epoch,
                   seconds=round(stall.seconds, 4), count=stall.count,
                   frac_of_epoch=stall_frac)
    if health is not None:
        health.on_stall(seconds=stall.seconds, frac=stall_frac,
                        epoch=epoch, phase=phase)
    telemetry.emit("step_window", phase=phase, epoch=epoch, steps=0,
                   samples_s=[], closes_epoch=True,
                   **timer.percentiles(), shapes=timer.shape_summary())
    emit_memory(telemetry, where=f"{phase}_epoch_{epoch}_end")
    ledger = getattr(telemetry, "ledger", None)
    if ledger is not None:
        # the timer is per epoch, so these totals are this epoch's; the
        # ledger accumulates run-wide (train, eval and serve share it)
        ledger.observe_timer(f"{phase}_step", timer)
        ledger.emit_summary(telemetry, step=epoch, phase=phase)


def _notify_incident(telemetry, exc, *, phase: str, epoch: int,
                     step: int) -> None:
    """An exception is about to unwind through the loop: the armed
    IncidentManager (``Telemetry.incidents``) snapshots the run's context
    first.  ``NonFiniteLossError`` is not routed here: the ``health.alert``
    nan trigger inside ``_flush`` already dumped its bundle.  (The JAX
    loop also passes its elastic shrink over, ROADMAP Queue 1 item 6;
    the port has no elastic training yet.)"""
    inc = (getattr(telemetry, "incidents", None)
           if telemetry is not None else None)
    if inc is not None and not isinstance(exc, NonFiniteLossError):
        inc.on_exception(exc, phase=phase, epoch=epoch, step=step)


def _emit_step_window(telemetry, samples, *, steps: int, phase: str,
                      epoch: int, t_window: float, images: float,
                      **scalars) -> float:
    """One ``step_window`` event per metric-flush window: host-side step
    intervals (first calls excluded, so ``len(samples_s)`` can be below
    ``steps``) and the window's fetched means.  Returns the new window
    start."""
    now = time.perf_counter()
    telemetry.emit("step_window", phase=phase, epoch=epoch, steps=steps,
                   seconds=round(now - t_window, 4), images=images,
                   samples_s=[round(s, 6) for s in samples], **scalars)
    return now


def _fetch(pending: List[dict], keys) -> List[List[float]]:
    """One device->host copy for a window of metric dicts: rows of floats
    in ``keys`` order."""
    if not pending:
        return []
    stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                           for m in pending])
    return stacked.cpu().tolist()


def _flush(pending, loss_sum, img_sum, check_finite, epoch, step_count,
           health=None, collect=False):
    """Fetch a window of step metrics in one copy; returns ``(loss_sum,
    img_sum, window_scalars)``.  ``window_scalars`` (telemetry on:
    ``collect``) holds the window's mean loss per image and, where the
    step computes them, grad/update norms; ``health`` gets every step's
    scalars and, on the abort path, the non-finite loss before
    ``NonFiniteLossError`` propagates."""
    window = len(pending)
    collect = collect or health is not None
    extra = ([k for k in HEALTH_KEYS if k in pending[0]]
             if collect and pending else [])
    rows = _fetch(pending, ("loss", "num_valid", *extra))
    if rows and process_count() > 1:
        # one reduce per window, before the check: every rank raises
        # together (the norms are global already)
        arr = np.asarray(rows, np.float64)
        arr[:, :2] = reduce_value(np.ascontiguousarray(arr[:, :2]),
                                  average=False)
        rows = arr.tolist()
    win: dict = {}
    for i, (loss, n, *norms) in enumerate(rows):
        step_no = step_count - window + i + 1
        if check_finite and not math.isfinite(loss):
            if health is not None:
                health.on_nonfinite(loss, epoch=epoch, step=step_no)
            raise NonFiniteLossError(
                f"non-finite loss {loss} in epoch {epoch}, step "
                f"{step_no} (metric checks are windowed: "
                f"detected at the flush after step {step_count}; pass "
                f"check_every=1 to train_one_epoch to stop at the step)")
        loss_sum += loss
        img_sum += n
        if collect:
            per_img = loss / max(n, 1.0)
            got = dict(zip(extra, norms))
            for key, v in (("loss", per_img), ("grad_norm", got.get("grad_norm")),
                           ("update_norm", got.get("update_norm"))):
                if v is not None:
                    acc = win.setdefault(key, [0, 0.0])
                    acc[0] += 1
                    acc[1] += v
            if health is not None:
                health.on_step_metrics(loss_per_img=per_img,
                                       grad_norm=got.get("grad_norm"),
                                       update_norm=got.get("update_norm"),
                                       epoch=epoch, step=step_no)
    return loss_sum, img_sum, {k: round(total / cnt, 8)
                               for k, (cnt, total) in win.items()}


def train_one_epoch(train_step: Callable, state, batches: Iterable, *,
                    put_fn: Callable, epoch: int = 0,
                    check_finite: bool = True, check_every: int = 8,
                    prefetch: int = 2, telemetry=None, health=None):
    """Run one epoch; returns ``(state, EpochStats)``.

    train_step: ``(state, device_batch) -> (state, metrics)``.
    batches: iterable of ``data.Batch``; put_fn: Batch -> device batch dict
    (``data.prefetch.DevicePut``).
    check_every: steps per metric flush (one host sync per window).
    prefetch: batches loaded and put ahead in a background thread.
    telemetry / health: the module docstring's events and detectors
    (``health`` is ignored without ``telemetry``).
    """
    if telemetry is None:
        health = None
    train_step, timer, stall = _arm_telemetry(telemetry, train_step,
                                              name="train_step")
    spans = (getattr(telemetry, "spans", None)
             if telemetry is not None else None)
    trace_id = root_id = None
    if spans is not None:
        trace_id = spans.new_trace_id(f"train.e{epoch}")
        root_id = spans.new_span_id()  # root emitted at epoch end
    loss_sum = img_sum = 0.0
    flushed_img = 0.0  # img_sum at the last window flush
    flushed_steps = 0  # steps at the last window flush
    steps = 0
    shapes = set()
    pending = []
    win: dict = {}
    t0 = time.perf_counter()
    t_window = t0
    try:
        for dev in prefetch_to_device(batches, put_fn, depth=prefetch,
                                      stall=stall):
            shape = tuple(dev["image"].shape)
            shapes.add(shape)
            if telemetry is not None:
                telemetry.step_tick()
                timer.start()
            state, metrics = train_step(state, dev)
            if telemetry is not None:
                # a first call is billed by its own compile event
                timer.stop(shape=shape, record=not train_step.last_first_call)
            pending.append(metrics)
            steps += 1
            if len(pending) >= max(check_every, 1):
                t_flush = time.perf_counter() if telemetry is not None else 0.0
                loss_sum, img_sum, win = _flush(
                    pending, loss_sum, img_sum, check_finite, epoch, steps,
                    health=health, collect=telemetry is not None)
                pending = []
                if telemetry is not None:
                    win_samples = timer.drain_window()
                    if health is not None:
                        health.on_window(win_samples, epoch=epoch,
                                         phase="train")
                    w0 = t_window
                    t_window = _emit_step_window(
                        telemetry, win_samples, steps=steps - flushed_steps,
                        phase="train", epoch=epoch, t_window=t_window,
                        images=img_sum - flushed_img, **win)
                    if spans is not None:
                        spans.emit(trace_id=trace_id, name="steps",
                                   start=w0, end=t_flush, parent_id=root_id,
                                   step=steps, steps=steps - flushed_steps)
                        spans.emit(trace_id=trace_id, name="metric_flush",
                                   start=t_flush, end=t_window,
                                   parent_id=root_id, step=steps)
                    flushed_img = img_sum
                    flushed_steps = steps
        t_flush = time.perf_counter() if telemetry is not None else 0.0
        loss_sum, img_sum, win = _flush(pending, loss_sum, img_sum,
                                        check_finite, epoch, steps,
                                        health=health,
                                        collect=telemetry is not None)
    except Exception as e:
        # a crashed loader, a poisoned batch, a device error: the bundle
        # first, then unwind (the NaN abort is excluded inside)
        _notify_incident(telemetry, e, phase="train", epoch=epoch,
                         step=steps)
        raise
    seconds = time.perf_counter() - t0
    if telemetry is not None:
        tail = timer.drain_window()
        if tail or steps > flushed_steps:  # partial trailing window
            if health is not None:
                health.on_window(tail, epoch=epoch, phase="train")
            w0 = t_window
            t_end = _emit_step_window(
                telemetry, tail, steps=steps - flushed_steps, phase="train",
                epoch=epoch, t_window=t_window,
                images=img_sum - flushed_img, **win)
            if spans is not None:
                spans.emit(trace_id=trace_id, name="steps", start=w0,
                           end=t_flush, parent_id=root_id, step=steps,
                           steps=steps - flushed_steps)
                spans.emit(trace_id=trace_id, name="metric_flush",
                           start=t_flush, end=t_end, parent_id=root_id,
                           step=steps)
        _emit_epoch_telemetry(telemetry, timer, stall, phase="train",
                              epoch=epoch, seconds=seconds, health=health)
        if health is not None:
            health.epoch_summary(epoch)
        if spans is not None:
            # fetch_stall is SYNTHESIZED: anchored at the epoch's start,
            # as long as the StallClock's accumulated input starvation
            spans.emit(trace_id=trace_id, name="fetch_stall", start=t0,
                       end=t0 + stall.seconds, parent_id=root_id,
                       synthesized=True, count=stall.count)
            spans.emit(trace_id=trace_id, name="train_epoch", start=t0,
                       end=time.perf_counter(), span_id=root_id,
                       epoch=epoch, steps=steps, images=img_sum)
    return state, EpochStats(loss_sum / max(img_sum, 1.0), seconds=seconds,
                             images=img_sum, steps=steps,
                             distinct_shapes=len(shapes))


def evaluate(eval_step: Callable, model, batches: Iterable, *,
             put_fn: Callable, dataset_size: int,
             check_every: int = 4, prefetch: int = 2,
             telemetry=None) -> dict:
    """Dataset MAE and (paper-style) RMSE: ``mae = sum|et - gt| / N`` over
    the true dataset size N; returns ``{"mae", "mse", "num_images",
    "batches"}``.  ``prefetch``: batches put ahead, as in
    ``train_one_epoch``; ``telemetry``: its events, phase "eval"."""
    eval_step, timer, stall = _arm_telemetry(telemetry, eval_step,
                                             name="eval_step")
    abs_sum = sq_sum = n_seen = 0.0
    n_batches = 0
    pending = []
    keys = ("abs_err_sum", "sq_err_sum", "num_valid")
    t0 = time.perf_counter()
    t_window = t0

    def flush():
        nonlocal abs_sum, sq_sum, n_seen, t_window
        n_before = n_seen
        window = len(pending)
        for a, s, n in _fetch(pending, keys):
            abs_sum += a
            sq_sum += s
            n_seen += n
        pending.clear()
        if telemetry is not None and window:
            t_window = _emit_step_window(telemetry, timer.drain_window(),
                                         steps=window, phase="eval",
                                         epoch=0, t_window=t_window,
                                         images=n_seen - n_before)

    try:
        for dev in prefetch_to_device(batches, put_fn, depth=prefetch,
                                      stall=stall):
            if telemetry is not None:
                telemetry.step_tick()
                timer.start()
            pending.append(eval_step(model, dev))
            if telemetry is not None:
                timer.stop(shape=tuple(dev["image"].shape),
                           record=not eval_step.last_first_call)
            n_batches += 1
            if len(pending) >= max(check_every, 1):
                flush()
        flush()
    except Exception as e:
        _notify_incident(telemetry, e, phase="eval", epoch=0,
                         step=len(pending))
        raise
    if telemetry is not None:
        _emit_epoch_telemetry(telemetry, timer, stall, phase="eval",
                              epoch=0, seconds=time.perf_counter() - t0)
    if int(n_seen) != dataset_size:
        raise RuntimeError(
            f"eval saw {int(n_seen)} valid samples, expected {dataset_size}")
    return {"mae": abs_sum / dataset_size,
            "mse": math.sqrt(sq_sum / dataset_size),
            "num_images": dataset_size, "batches": n_batches}
