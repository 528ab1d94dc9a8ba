"""Micro-batcher: group queued requests by bucket shape, flush each group
as static-shape batches (counterpart of ``can_tpu/serve/batcher.py``).

With a ``ServeSched`` (``can_tpu_torch/sched``, the service's default):

* a bucket's group flushes the moment it holds the top menu size;
* otherwise it flushes at the core's priced deadline
  (``ServeSched.flush_at``): at once when one more request cannot beat
  launch-cost amortisation or the bucket's arrival rate says none is
  expected inside the window; at the latency cap (``max_wait_ms``) or
  the group's deadline slack otherwise — with no rate estimate yet that
  is the old timer;
* a flush is covered by the core's menu parts (the planner's exact
  ``decompose`` DP): a 2-request flush launches a 2-slot batch, and
  every launched size is a menu size, all warmed up front.

Without a ``sched`` the older behaviour holds exactly: every flush pads
to ``max_batch`` slots and flushes ``max_wait_ms`` after its oldest
request.  Either way fill slots carry ``sample_mask=0``, and requests
whose deadline expires before dispatch are rejected, never launched.

The pump wakes at the earliest pending flush deadline (or on arrival),
never on a fixed poll grain.  The bucket mapping is
``data.batching.snap_to_bucket`` and assembly is ``data.batching.pad_batch``.
One consumer thread; dispatch runs on it.
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


class _Group:
    """One pending per-key group: requests and the arrival times the
    priced flush deadline needs."""

    __slots__ = ("requests", "t0", "t_last")

    def __init__(self, t0: float):
        self.requests: List[ServeRequest] = []
        self.t0 = t0      # oldest request's submit (latency cap anchor)
        self.t_last = t0  # newest arrival (the wait-for-next anchor)


class MicroBatcher:
    """Pulls from a ``BoundedRequestQueue``, emits padded ``Batch``es.

    dispatch: ``fn(bucket_hw, batch, requests)`` — executes the batch and
    resolves each request.  A dispatch that raises rejects its requests
    with ``error`` and the batcher keeps running.
    on_reject: ``fn(reason, count)`` for batcher-side rejections.
    sched: optional ``sched.ServeSched`` (priced menu and flush); None
    keeps the pad-to-``max_batch`` / fixed-timer behaviour exactly.
    bucket_ladder / pad_multiple / min_bucket_h: ``snap_to_bucket``'s.
    telemetry: an object with ``emit(kind, **payload)`` or None.
    """

    def __init__(self, queue: BoundedRequestQueue, dispatch: Callable,
                 *, max_batch: int = 8, max_wait_ms: float = 5.0,
                 bucket_ladder=None, pad_multiple=None,
                 min_bucket_h: Optional[int] = None, ds: int = 8,
                 telemetry=None, clock=time.monotonic,
                 idle_wait_s: float = 0.05,
                 on_reject: Optional[Callable] = None,
                 sched=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if sched is not None and sched.max_batch != int(max_batch):
            raise ValueError(
                f"sched menu tops out at {sched.max_batch}, batcher "
                f"max_batch is {max_batch} — one core, one top size")
        self.queue = queue
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.sched = sched
        if isinstance(pad_multiple, int):
            pad_multiple = (pad_multiple, pad_multiple)
        self.bucket_ladder = bucket_ladder
        self.pad_multiple = pad_multiple
        self.min_bucket_h = min_bucket_h
        self.ds = int(ds)
        self.telemetry = telemetry
        self.on_reject = on_reject
        self._clock = clock
        self._idle_wait_s = float(idle_wait_s)
        self._pending: Dict[GroupKey, _Group] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bucket_of(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        return snap_to_bucket(hw, ladder=self.bucket_ladder,
                              pad_multiple=self.pad_multiple,
                              min_bucket_h=self.min_bucket_h)

    # -- flush pricing ---------------------------------------------------
    def _flush_at(self, key: GroupKey, group: _Group, now: float) -> float:
        """Absolute flush deadline of one group: the core's priced
        deadline, or the ``t0 + max_wait`` timer without a core."""
        if self.sched is None:
            return group.t0 + self.max_wait_s
        deadlines = [r.deadline_ts for r in group.requests
                     if r.deadline_ts is not None]
        return self.sched.flush_at(key, len(group.requests), group.t0,
                                   group.t_last, now,
                                   min(deadlines) if deadlines else None)

    def next_wake_s(self, now: Optional[float] = None) -> float:
        """Seconds until the earliest pending flush deadline, or
        ``idle_wait_s`` with nothing pending.  >= 0."""
        now = self._clock() if now is None else now
        if not self._pending:
            return self._idle_wait_s
        due = min(self._flush_at(k, g, now)
                  for k, g in self._pending.items())
        return max(0.0, min(self._idle_wait_s, due - now))

    # -- the pump (thread-free, testable with a fake clock) --------------
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
        requests, flush any group that reaches the top launch size."""
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
            group.t_last = r.t_submit
            if self.sched is not None:
                self.sched.observe_arrival(key, r.t_submit)
            if len(group.requests) >= self.max_batch:
                del self._pending[key]
                flushed += self._flush(key, group.requests)
        return flushed

    def poll(self, now: float) -> int:
        """Reject expired pending requests; flush groups whose priced
        deadline (or timer) has come.  Returns batches dispatched."""
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
            if now >= self._flush_at(key, group, now):
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

    # -- assembly + dispatch ---------------------------------------------
    def _flush(self, key: GroupKey, group: List[ServeRequest]) -> int:
        """Cover the group with menu-size launches (one launch padded to
        ``max_batch`` per ``max_batch`` requests without a core) and
        dispatch each.  Returns batches dispatched."""
        if self.sched is None:
            parts: Tuple[int, ...] = (self.max_batch,) * max(
                1, -(-len(group) // self.max_batch))
        else:
            parts = self.sched.parts_for(len(group))
        n = 0
        pos = 0
        for size in parts:
            take = group[pos:pos + size]
            pos += size
            if not take:
                break
            self._flush_part(key, take, size)
            n += 1
        return n

    def _flush_part(self, key: GroupKey, group: List[ServeRequest],
                    size: int) -> None:
        bh, bw = key[0], key[1]
        try:
            t_asm = self._clock()
            # zero density targets: serve batches reuse the offline Batch
            # layout so the engine runs the eval-step math; dmap is unused
            items = [(r.image,
                      np.zeros((r.shape[0] // self.ds,
                                r.shape[1] // self.ds, 1), np.float32))
                     for r in group]
            batch = pad_batch(items, (bh, bw), size,
                              [True] * len(group), self.ds)
            t_ready = self._clock()
            for r in group:
                r.t_assembly = t_asm
                r.t_ready = t_ready
            self.dispatch((bh, bw), batch, group)
        except Exception as e:  # noqa: BLE001 — poison batch, keep serving
            n = 0
            for r in group:
                if not r.done:
                    r.reject(REJECT_ERROR, f"{type(e).__name__}: {e}")
                    n += 1
            if self.on_reject is not None and n:
                self.on_reject(REJECT_ERROR, n)
            if self.telemetry is not None:
                self.telemetry.emit("serve.reject", reason=REJECT_ERROR,
                                    count=n,
                                    detail=f"{type(e).__name__}: {e}")

    def _reject_expired(self, r: ServeRequest) -> None:
        r.reject(REJECT_DEADLINE, "deadline expired before dispatch")
        if self.on_reject is not None:
            self.on_reject(REJECT_DEADLINE, 1)
        if self.telemetry is not None:
            self.telemetry.emit("serve.reject", reason=REJECT_DEADLINE,
                                count=1, request_id=r.id)

    # -- thread lifecycle ------------------------------------------------
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
