"""Bounded request queue: deadlines, typed rejection, load shedding
(counterpart of ``can_tpu/serve/queue.py``).

Every admitted request RESOLVES — with a result or a typed rejection —
never hangs: waiters block on a per-request event with a timeout, the
batcher rejects expired requests instead of dispatching them, and
``close()`` hands back everything still queued for rejection.

Backpressure is load shedding with hysteresis over the OUTSTANDING count
(admitted, not yet resolved — waiting, pending in the batcher or
executing): when it reaches ``high_water`` new arrivals are rejected
(``backpressure``) until it falls to ``low_water``.  ``capacity`` is the
hard bound on the waiting queue itself (``queue_full``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

REJECT_QUEUE_FULL = "queue_full"      # hard capacity bound hit
REJECT_BACKPRESSURE = "backpressure"  # load shedding above high_water
REJECT_DEADLINE = "deadline"          # deadline expired before dispatch
REJECT_SHUTDOWN = "shutdown"          # service closed with the request queued
REJECT_ERROR = "error"                # dispatch raised; message in detail
# stream sessions (serve/streams.py): a duplicate/out-of-order frame of a
# stream's monotonic sequence, and the degradation ladder's last rung
REJECT_STALE_FRAME = "stale_frame"
REJECT_STREAM_OVERLOAD = "stream_overload"


class RejectedError(RuntimeError):
    """Raised by ``ServeRequest.wait()`` when the request was rejected."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"request rejected: {reason}"
                         + (f" ({detail})" if detail else ""))
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass
class ServeResult:
    """One completed prediction."""

    count: float                          # predicted head count
    density: Optional[np.ndarray]         # (h, w, 1) masked density, if asked
    bucket_hw: Tuple[int, int]            # static shape the batch ran at
    batch_fill: float                     # valid / total slots of its batch
    latency_s: float                      # submit -> resolve wall time
    queue_wait_s: Optional[float] = None  # submit -> batch assembly start
    device_s: Optional[float] = None      # engine execute wall time
    trace_id: Optional[str] = None        # the request's id in responses
    # stream sessions (serve/streams.py): a degraded answer was served
    # from the stream's EWMA (no launch ran) and is ``staleness_s``
    # seconds older than a fresh inference would be
    degraded: bool = False
    staleness_s: Optional[float] = None
    stream_id: Optional[str] = None


class ServeRequest:
    """A queued request plus its resolution rendezvous.

    ``image``: HWC numpy, float32 (host-normalised) or uint8 (normalised
    on the device); H, W already snapped to the density grid (see
    ``service.prepare_image``).
    """

    _ids = itertools.count()

    def __init__(self, image: np.ndarray, *, deadline_s: Optional[float],
                 want_density: bool = False, clock=time.monotonic,
                 stream_id: Optional[str] = None,
                 frame_seq: Optional[int] = None):
        self.id = next(self._ids)
        self.image = image
        self.shape = tuple(image.shape[:2])
        self.want_density = bool(want_density)
        # stream sessions: the camera this frame belongs to and its
        # monotonic sequence number; None keeps the stateless path
        self.stream_id = stream_id
        self.frame_seq = None if frame_seq is None else int(frame_seq)
        self.t_submit = clock()
        self.deadline_ts = (None if deadline_s is None
                            else self.t_submit + float(deadline_s))
        self._done = threading.Event()
        self._result: Optional[ServeResult] = None
        self._reject: Optional[RejectedError] = None
        self._done_hooks: List = []
        self.trace_id: Optional[str] = None
        self.t_assembly: Optional[float] = None  # batch assembly began
        self.t_ready: Optional[float] = None     # padded batch handed off

    def expired(self, now: float) -> bool:
        return self.deadline_ts is not None and now >= self.deadline_ts

    def add_done_hook(self, hook) -> None:
        """Register ``hook(request)`` to fire exactly once at
        resolution/rejection (immediately if already done)."""
        if self._done.is_set():
            hook(self)
            return
        self._done_hooks.append(hook)

    def _fire_done(self) -> None:
        hooks, self._done_hooks = self._done_hooks, []
        for hook in hooks:
            hook(self)

    def resolve(self, result: ServeResult) -> None:
        self._result = result
        self._done.set()
        self._fire_done()

    def reject(self, reason: str, detail: str = "") -> None:
        self._reject = RejectedError(reason, detail)
        self._done.set()
        self._fire_done()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> ServeResult:
        """Block for the outcome; raises ``RejectedError`` on rejection or
        on wait timeout (a typed answer, never a hang)."""
        if not self._done.wait(timeout):
            raise RejectedError(REJECT_DEADLINE,
                                f"no result within {timeout}s wait")
        if self._reject is not None:
            raise self._reject
        return self._result


class BoundedRequestQueue:
    """Thread-safe FIFO with capacity, deadline hygiene, and shedding.

    Producers call ``offer`` (admits or instantly rejects — never blocks);
    the single batcher thread calls ``drain``/``wait_nonempty``.
    """

    def __init__(self, capacity: int = 64, *,
                 high_water: Optional[int] = None,
                 low_water: Optional[int] = None,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.high_water = None if high_water is None else int(high_water)
        if self.high_water is not None and self.high_water < 1:
            raise ValueError(f"high_water ({high_water}) must be >= 1")
        if low_water is None:
            low_water = (self.high_water // 2 if self.high_water is not None
                         else None)
        self.low_water = low_water
        if (self.high_water is not None
                and not 0 <= self.low_water < self.high_water):
            raise ValueError(f"low_water ({low_water}) must be in "
                             f"[0, high_water={high_water})")
        self._clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._items: List[ServeRequest] = []
        self._outstanding = 0  # admitted, not yet resolved/rejected
        self._shedding = False
        self._closed = False

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def outstanding(self) -> int:
        """Admitted requests not yet resolved — the shedding signal."""
        with self._lock:
            return self._outstanding

    @property
    def shedding(self) -> bool:
        return self._shedding

    def _request_done(self, _request) -> None:
        with self._lock:
            self._outstanding -= 1
            if (self._shedding and self.low_water is not None
                    and self._outstanding <= self.low_water):
                self._shedding = False

    def offer(self, request: ServeRequest, *,
              reject: bool = True) -> Optional[str]:
        """Admit ``request`` or reject it; returns the reject reason (also
        recorded on the request) or None when admitted.

        ``reject=False`` returns the reason WITHOUT rejecting the request:
        the stream path answers a refused frame from its session EWMA (the
        caller resolves or rejects it, exactly once either way)."""
        with self._lock:
            if self._closed:
                reason = REJECT_SHUTDOWN
            elif len(self._items) >= self.capacity:
                reason = REJECT_QUEUE_FULL
            else:
                if (self.high_water is not None and not self._shedding
                        and self._outstanding >= self.high_water):
                    self._shedding = True
                reason = REJECT_BACKPRESSURE if self._shedding else None
            if reason is None:
                request.add_done_hook(self._request_done)
                self._outstanding += 1
                self._items.append(request)
                self._nonempty.notify()
                return None
        if reject:
            request.reject(reason, f"outstanding {self.outstanding()}")
        return reason

    def wait_nonempty(self, timeout: Optional[float]) -> bool:
        """Block until an item is queued, the queue closes, or ``timeout``
        elapses; True when items are available."""
        with self._lock:
            if not self._items and not self._closed:
                self._nonempty.wait(timeout)
            return bool(self._items)

    def drain(self) -> Tuple[List[ServeRequest], List[ServeRequest]]:
        """Take every queued request, split into (live, expired).  Expired
        requests are NOT rejected here (the caller owns the rejection).
        Draining does not end shedding: only resolution drains load."""
        with self._lock:
            items, self._items = self._items, []
        now = self._clock()
        live = [r for r in items if not r.expired(now)]
        expired = [r for r in items if r.expired(now)]
        return live, expired

    def close(self) -> List[ServeRequest]:
        """Stop admissions; returns (without rejecting) whatever was still
        queued so the owner can reject it."""
        with self._lock:
            self._closed = True
            items, self._items = self._items, []
            self._nonempty.notify_all()
        return items
