"""Host-side epoch loops (counterpart of ``can_tpu/train/loop.py:44-476``;
the telemetry, health and elastic hooks come with later slices).

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


def _fetch(pending: List[dict], keys) -> List[List[float]]:
    """One device->host copy for a window of metric dicts: rows of floats
    in ``keys`` order."""
    if not pending:
        return []
    stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                           for m in pending])
    return stacked.cpu().tolist()


def _flush(pending, loss_sum, img_sum, check_finite, epoch, step_count):
    window = len(pending)
    rows = _fetch(pending, ("loss", "num_valid"))
    if rows and process_count() > 1:
        # one reduce per window, before the check: every rank raises together
        rows = reduce_value(np.asarray(rows, np.float64), average=False).tolist()
    for i, (loss, n) in enumerate(rows):
        if check_finite and not math.isfinite(loss):
            raise NonFiniteLossError(
                f"non-finite loss {loss} in epoch {epoch}, step "
                f"{step_count - window + i + 1} (metric checks are windowed: "
                f"detected at the flush after step {step_count}; pass "
                f"check_every=1 to train_one_epoch to stop at the step)")
        loss_sum += loss
        img_sum += n
    return loss_sum, img_sum


def train_one_epoch(train_step: Callable, state, batches: Iterable, *,
                    put_fn: Callable, epoch: int = 0,
                    check_finite: bool = True, check_every: int = 8,
                    prefetch: int = 2):
    """Run one epoch; returns ``(state, EpochStats)``.

    train_step: ``(state, device_batch) -> (state, metrics)``.
    batches: iterable of ``data.Batch``; put_fn: Batch -> device batch dict
    (``data.prefetch.DevicePut``).
    check_every: steps per metric flush (one host sync per window).
    prefetch: batches loaded and put ahead in a background thread.
    """
    loss_sum = img_sum = 0.0
    steps = 0
    shapes = set()
    pending = []
    t0 = time.perf_counter()
    for dev in prefetch_to_device(batches, put_fn, depth=prefetch):
        shapes.add(tuple(dev["image"].shape))
        state, metrics = train_step(state, dev)
        pending.append(metrics)
        steps += 1
        if len(pending) >= max(check_every, 1):
            loss_sum, img_sum = _flush(pending, loss_sum, img_sum,
                                       check_finite, epoch, steps)
            pending = []
    loss_sum, img_sum = _flush(pending, loss_sum, img_sum, check_finite,
                               epoch, steps)
    seconds = time.perf_counter() - t0
    return state, EpochStats(loss_sum / max(img_sum, 1.0), seconds=seconds,
                             images=img_sum, steps=steps,
                             distinct_shapes=len(shapes))


def evaluate(eval_step: Callable, model, batches: Iterable, *,
             put_fn: Callable, dataset_size: int,
             check_every: int = 4, prefetch: int = 2) -> dict:
    """Dataset MAE and (paper-style) RMSE: ``mae = sum|et - gt| / N`` over
    the true dataset size N; returns ``{"mae", "mse", "num_images",
    "batches"}``.  ``prefetch``: batches put ahead, as in
    ``train_one_epoch``."""
    abs_sum = sq_sum = n_seen = 0.0
    n_batches = 0
    pending = []
    keys = ("abs_err_sum", "sq_err_sum", "num_valid")

    def flush():
        nonlocal abs_sum, sq_sum, n_seen
        for a, s, n in _fetch(pending, keys):
            abs_sum += a
            sq_sum += s
            n_seen += n
        pending.clear()

    for dev in prefetch_to_device(batches, put_fn, depth=prefetch):
        pending.append(eval_step(model, dev))
        n_batches += 1
        if len(pending) >= max(check_every, 1):
            flush()
    flush()
    if int(n_seen) != dataset_size:
        raise RuntimeError(
            f"eval saw {int(n_seen)} valid samples, expected {dataset_size}")
    return {"mae": abs_sum / dataset_size,
            "mse": math.sqrt(sq_sum / dataset_size),
            "num_images": dataset_size, "batches": n_batches}
