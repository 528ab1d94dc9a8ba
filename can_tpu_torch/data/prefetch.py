"""Batches put on the device ahead of the step that needs them
(counterpart of ``can_tpu/data/prefetch.py:24-101``, the ``stall=``
clock of the loops' telemetry included).

``prefetch_to_device`` runs the batch loading and the host-to-device put
``depth`` batches ahead in one background thread, while the device runs
the current step.  ``DevicePut`` is the put: on a CUDA device it copies
each array into pinned host memory and issues a ``non_blocking`` copy on
a side stream, then records an event there.  The consumer's stream waits
on that event when the batch is handed over (``InFlight.landed``, in the
consumer's thread), and every tensor is ``record_stream``'d on the
consumer's stream, so the caching allocator does not hand its memory out
again while the step still reads it.  On the CPU the put is a plain
conversion, and the CLIs take the synchronous path there (depth 0): a
loader thread would only compete with the CPU's own compute threads.
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, NamedTuple

import numpy as np
import torch

BATCH_FIELDS = ("image", "dmap", "pixel_mask", "sample_mask")
DEPTH = 2  # batches put ahead on the card (the JAX package's default)


class PrefetchPutError(RuntimeError):
    """``put_fn`` failed in the prefetch thread.  The failure surfaces
    only when its batch is due, up to ``depth`` batches later, so this
    names the failing batch; the original exception is the cause."""

    def __init__(self, batch_index: int):
        super().__init__(f"put_fn failed on batch {batch_index} "
                         f"(prefetched in a worker thread; see the chained "
                         f"cause for the original traceback)")
        self.batch_index = batch_index


def batch_tensors(batch) -> Dict[str, torch.Tensor]:
    """A host ``data.Batch`` -> its arrays as host tensors (no copy where
    the array is contiguous)."""
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(batch, k)))
            for k in BATCH_FIELDS}


class InFlight(NamedTuple):
    """Device tensors whose copy was issued on a side stream, and the
    event recorded after it."""

    tensors: Dict[str, torch.Tensor]
    event: "torch.cuda.Event"

    def landed(self) -> Dict[str, torch.Tensor]:
        """Hand the tensors to the calling thread's current stream: it
        waits for the copy, and the allocator keeps each tensor's memory
        until that stream's work on it is done."""
        device = next(iter(self.tensors.values())).device
        stream = torch.cuda.current_stream(device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


class DevicePut:
    """``put_fn`` for ``prefetch_to_device``: host ``Batch`` -> the step's
    dict of tensors on ``device`` (an ``InFlight`` on a CUDA device).
    ``depth``: how far ahead to put on this device (``DEPTH`` on the card,
    0 on the CPU); the CLIs price it per batcher with ``depth_for``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.depth = DEPTH if self.stream is not None else 0

    def depth_for(self, batcher) -> int:
        """The priced depth for ``batcher``'s schedule on the card
        (``sched.prefetch_depth_for``, as the JAX CLIs price it); 0 on
        the CPU."""
        if self.stream is None:
            return 0
        from can_tpu_torch.sched import prefetch_depth_for

        return prefetch_depth_for(batcher)

    def __call__(self, batch):
        host = batch_tensors(batch)
        if self.stream is None:
            return {k: t.to(self.device) for k, t in host.items()}
        with torch.cuda.stream(self.stream):
            tensors = {k: t.pin_memory().to(self.device, non_blocking=True)
                       for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return InFlight(tensors, event)


def _landed(out):
    return out.landed() if isinstance(out, InFlight) else out


def prefetch_to_device(batches: Iterable, put_fn: Callable, *,
                       depth: int = 2, stall=None) -> Iterator:
    """Yield ``put_fn(batch)`` for each batch, computed ``depth`` ahead in
    a background thread.  ``depth <= 0`` is the synchronous path (each
    batch loaded and put when it is due; exceptions propagate as they
    are).  ``stall``: an ``obs.StallClock`` that accumulates the time the
    consumer was BLOCKED — on the synchronous path every put (nothing
    overlaps it), else only a wait for a batch whose load had not
    finished."""
    if depth <= 0:
        for b in batches:
            if stall is not None:
                t0 = time.perf_counter()
                out = put_fn(b)
                stall.add(time.perf_counter() - t0)
            else:
                out = put_fn(b)
            yield _landed(out)
        return

    it = iter(batches)
    done = object()
    n_submitted = 0

    def load_next(index: int):
        try:
            batch = next(it)
        except StopIteration:
            return done
        try:
            return put_fn(batch)
        except Exception as e:
            raise PrefetchPutError(index) from e

    def submit():
        nonlocal n_submitted
        fut = ex.submit(load_next, n_submitted)
        n_submitted += 1
        return fut

    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="can_tpu_torch_prefetch")
    try:
        queue = collections.deque(submit() for _ in range(depth))
        while queue:
            fut = queue.popleft()
            if stall is not None and not fut.done():
                t0 = time.perf_counter()
                result = fut.result()
                stall.add(time.perf_counter() - t0)
            else:
                result = fut.result()
            if result is done:
                break
            queue.append(submit())
            yield _landed(result)
    finally:
        # an abandoned consumer (an exception, an early break) cancels the
        # queued loads instead of waiting for them; the one running ends
        ex.shutdown(wait=False, cancel_futures=True)
