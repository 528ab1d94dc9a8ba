"""Micro-batcher: group queued requests by bucket shape, flush each group
as one static-shape batch (counterpart of ``can_tpu/serve/batcher.py``
on its ``sched=None`` path: one ``max_batch`` launch size, timer flush).

* a group flushes the moment it holds ``max_batch`` requests;
* otherwise it flushes ``max_wait_ms`` after its oldest request arrived;
* every flush pads to exactly ``max_batch`` slots (fill slots carry
  ``sample_mask=0``), so each (bucket, dtype) is one warmed launch shape;
* requests whose deadline expires before dispatch are rejected, never
  launched.

The bucket mapping is ``data.batching.snap_to_bucket`` and assembly is
``data.batching.pad_batch``.  One consumer thread; dispatch runs on it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from can_tpu_torch.data.batching import pad_batch, snap_to_bucket
from can_tpu_torch.serve.queue import (
    REJECT_DEADLINE,
    REJECT_ERROR,
    BoundedRequestQueue,
    ServeRequest,
)

# (bucket H, bucket W, image dtype): u8 and f32 requests never share a batch
GroupKey = Tuple[int, int, str]
IDLE_WAIT_S = 0.05  # pump wake-up bound with nothing pending (stop latency)


class _Group:
    __slots__ = ("requests", "t0")

    def __init__(self, t0: float):
        self.requests: List[ServeRequest] = []
        self.t0 = t0  # oldest request's submit (the flush timer's anchor)


class MicroBatcher:
    """Pulls from a ``BoundedRequestQueue``, emits padded ``Batch``es.

    dispatch: ``fn(bucket_hw, batch, requests)`` — executes the batch and
    resolves each request.  A dispatch that raises rejects its requests
    with ``error`` and the batcher keeps running.
    on_reject: ``fn(reason, count)`` for batcher-side rejections.
    """

    def __init__(self, queue: BoundedRequestQueue, dispatch: Callable,
                 *, max_batch: int = 8, max_wait_ms: float = 5.0,
                 bucket_ladder=None, ds: int = 8, clock=time.monotonic,
                 on_reject: Optional[Callable] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.queue = queue
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.bucket_ladder = bucket_ladder
        self.ds = int(ds)
        self.on_reject = on_reject
        self._clock = clock
        self._pending: Dict[GroupKey, _Group] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bucket_of(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        return snap_to_bucket(hw, ladder=self.bucket_ladder)

    def next_wake_s(self, now: Optional[float] = None) -> float:
        """Seconds until the earliest pending flush deadline, or
        ``IDLE_WAIT_S`` with nothing pending.  >= 0."""
        now = self._clock() if now is None else now
        if not self._pending:
            return IDLE_WAIT_S
        due = min(g.t0 + self.max_wait_s for g in self._pending.values())
        return max(0.0, min(IDLE_WAIT_S, due - now))

    def run_once(self, wait_s: Optional[float] = None) -> int:
        """One pump iteration: wait for arrivals (bounded by the earliest
        flush deadline), intake, flush what is due.  Returns batches
        dispatched."""
        wait = self.next_wake_s() if wait_s is None else wait_s
        self.queue.wait_nonempty(wait)
        n = self.intake()
        return n + self.poll(self._clock())

    def intake(self) -> int:
        """Drain the queue into per-bucket groups, reject expired
        requests, flush any group that reaches ``max_batch``."""
        live, expired = self.queue.drain()
        for r in expired:
            self._reject_expired(r)
        flushed = 0
        for r in live:
            bh, bw = self.bucket_of(r.shape)
            key = (bh, bw, str(r.image.dtype))
            group = self._pending.get(key)
            if group is None:
                group = self._pending[key] = _Group(r.t_submit)
            group.requests.append(r)
            if len(group.requests) >= self.max_batch:
                del self._pending[key]
                flushed += self._flush(key, group.requests)
        return flushed

    def poll(self, now: float) -> int:
        """Reject expired pending requests; flush groups whose timer has
        run out.  Returns batches dispatched."""
        flushed = 0
        for key in sorted(self._pending):
            group = self._pending[key]
            kept = []
            for r in group.requests:
                if r.expired(now):
                    self._reject_expired(r)
                else:
                    kept.append(r)
            if not kept:
                del self._pending[key]
                continue
            group.requests = kept
            if now >= group.t0 + self.max_wait_s:
                del self._pending[key]
                flushed += self._flush(key, kept)
        return flushed

    def flush_all(self) -> int:
        """Dispatch every pending group (shutdown path)."""
        n = 0
        for key in sorted(self._pending):
            n += self._flush(key, self._pending.pop(key).requests)
        return n

    def pending_count(self) -> int:
        return sum(len(g.requests) for g in self._pending.values())

    def _flush(self, key: GroupKey, group: List[ServeRequest]) -> int:
        """One launch padded to ``max_batch`` per ``max_batch`` requests."""
        n = 0
        for pos in range(0, len(group), self.max_batch):
            self._flush_part(key, group[pos:pos + self.max_batch])
            n += 1
        return n

    def _flush_part(self, key: GroupKey, group: List[ServeRequest]) -> None:
        bh, bw = key[0], key[1]
        try:
            t_asm = self._clock()
            # zero density targets: serve batches reuse the offline Batch
            # layout so the engine runs the eval-step math; dmap is unused
            items = [(r.image,
                      np.zeros((r.shape[0] // self.ds,
                                r.shape[1] // self.ds, 1), np.float32))
                     for r in group]
            batch = pad_batch(items, (bh, bw), self.max_batch,
                              [True] * len(group), self.ds)
            for r in group:
                r.t_assembly = t_asm
            self.dispatch((bh, bw), batch, group)
        except Exception as e:  # noqa: BLE001 — poison batch, keep serving
            n = 0
            for r in group:
                if not r.done:
                    r.reject(REJECT_ERROR, f"{type(e).__name__}: {e}")
                    n += 1
            if self.on_reject is not None and n:
                self.on_reject(REJECT_ERROR, n)

    def _reject_expired(self, r: ServeRequest) -> None:
        r.reject(REJECT_DEADLINE, "deadline expired before dispatch")
        if self.on_reject is not None:
            self.on_reject(REJECT_DEADLINE, 1)

    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="can-tpu-torch-serve-batcher")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.run_once()
        # drain-on-stop: admitted requests still resolve
        self.intake()
        self.flush_all()

    def close(self) -> None:
        """Stop the pump thread and flush everything pending (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        else:
            self.intake()
            self.flush_all()
