"""Per-stream serving sessions: sticky host-side state and frame-skip
admission (counterpart of ``can_tpu/serve/streams.py``, line for line:
pure host-side Python, no torch).

Fixed cameras send continuous frames: requests from one camera are
TEMPORALLY REDUNDANT (the crowd count moves slowly between frames; an
answer a second stale is still an answer) and STICKY (the same
resolution hits the same bucket every time).  Session state lives on the
HOST, on the service — never on an engine — so a weight swap (and, with
the fleet, every replica fault) leaves every session intact.

A ``StreamSessionRegistry`` hangs off ``CountService`` and holds, per
stream: a count EWMA (and a density-map EWMA when density was fetched),
a count trend, the last-served timestamp, a monotonic frame sequence
with out-of-order/duplicate rejection, the degradation rung, and a
replica pin.

* **Frame-skip admission (the degradation ladder)** — full inference →
  frame-skip (answer from the EWMA, no launch) → reject, driven by
  per-stream load ``L = max(arrival pressure, backlog pressure)``:
  arrival pressure is the PRICED per-frame drain cost over the stream's
  arrival-gap EWMA (the sched core's cost model — serving one more frame
  costs ``cover_one(1) + launch_cost_slots`` slots at the bucket's
  measured seconds-per-slot), and backlog pressure is the stream's own
  outstanding frames over its allowance.  Rung transitions use
  hysteresis bands (enter at 1.0/3.0, exit at 0.5/1.5) AND a cooldown: a
  stream changes rung at most once per ``cooldown_s``.  Every degraded
  answer is labelled (``degraded: true`` + staleness seconds) in the
  ``ServeResult`` and the HTTP body.

* **Sticky stream→replica routing** (``pin_for``, ``repin_target``) —
  a stream is pinned to the replica that first served it, and a pin to
  a replica that left the live set is re-pinned deterministically.  The
  single-engine service records no pins; the multi-replica fleet is the
  caller.

* **TTL eviction** — idle sessions past ``ttl_s`` are swept (under the
  registry lock, on the submit path, amortised).

``telemetry`` (an object with ``emit(kind, **payload)``, or None) gets
``stream.session``, ``stream.degrade`` and ``stream.repin`` events.
Thread-safe (HTTP threads submit while the batcher completes) behind
one RLock.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from can_tpu_torch.sched.core import GAP_EWMA_ALPHA, MIN_GAP_INTERVALS

# degradation rungs, least to most degraded; index IS the rung level
STREAM_RUNG_FULL = "full"
STREAM_RUNG_SKIP = "skip"
STREAM_RUNG_REJECT = "reject"
_RUNGS = (STREAM_RUNG_FULL, STREAM_RUNG_SKIP, STREAM_RUNG_REJECT)

# count-EWMA smoothing: ~the last 5-6 frames dominate (a crowd count
# moves slowly frame to frame; heavier smoothing would lag real trends)
COUNT_EWMA_ALPHA = 0.3
# drain-cost smoothing (seconds-per-slot per bucket): measured from real
# batch completions, so it tracks the fleet's actual capacity through
# quarantines and scale events
DRAIN_EWMA_ALPHA = 0.25


class AdmitDecision:
    """Outcome of ``StreamSessionRegistry.admit`` for one frame."""

    __slots__ = ("kind", "count", "density", "staleness_s", "detail",
                 "rung", "prior_seq")

    # kinds: "serve" (full inference), "degrade" (answer from the EWMA,
    # drop the launch), "stale" (out-of-order/duplicate frame),
    # "overload" (reject rung / no EWMA to degrade to)
    def __init__(self, kind: str, *, count: Optional[float] = None,
                 density=None, staleness_s: Optional[float] = None,
                 detail: str = "", rung: str = STREAM_RUNG_FULL,
                 prior_seq: Optional[int] = None):
        self.kind = kind
        self.count = count
        self.density = density
        self.staleness_s = staleness_s
        self.detail = detail
        self.rung = rung
        # the session's seq BEFORE this frame committed it — what
        # ``rollback_seq`` restores when a "serve" decision's frame is
        # subsequently refused by the queue with nothing to degrade to
        self.prior_seq = prior_seq


class StreamSession:
    """One stream's host-side state.  Mutated only under the registry
    lock; the object itself survives every replica fault because no
    replica ever holds it."""

    __slots__ = ("stream_id", "created_ts", "last_seen_ts",
                 "last_served_ts", "seq", "served", "degraded",
                 "stale_rejects", "overload_rejects", "outstanding",
                 "count_ewma", "trend_per_s", "density_ewma", "bucket_hw",
                 "gap_ewma", "gap_n", "t_last_arrival", "rung",
                 "rung_since", "pin")

    def __init__(self, stream_id: str, now: float):
        self.stream_id = stream_id
        self.created_ts = now
        self.last_seen_ts = now
        self.last_served_ts: Optional[float] = None
        self.seq: Optional[int] = None    # highest ACCEPTED frame seq
        self.served = 0                   # frames fully inferred
        self.degraded = 0                 # frames answered from the EWMA
        self.stale_rejects = 0
        self.overload_rejects = 0
        self.outstanding = 0              # admitted, not yet resolved
        self.count_ewma: Optional[float] = None
        self.trend_per_s = 0.0            # d(count_ewma)/dt, smoothed
        self.density_ewma: Optional[np.ndarray] = None
        self.bucket_hw: Optional[Tuple[int, int]] = None
        # arrival-gap EWMA (the sched core's estimator shape/constants)
        self.gap_ewma = 0.0
        self.gap_n = 0
        self.t_last_arrival: Optional[float] = None
        self.rung = STREAM_RUNG_FULL
        self.rung_since = now
        # sticky routing: (replica index, incarnation token) of the
        # replica that first served this stream; invalidated + re-pinned
        # when that exact incarnation leaves the live set
        self.pin: Optional[Tuple[int, str]] = None

    def snapshot(self) -> dict:
        return {"stream": self.stream_id, "seq": self.seq,
                "served": self.served, "degraded": self.degraded,
                "stale_rejects": self.stale_rejects,
                "overload_rejects": self.overload_rejects,
                "outstanding": self.outstanding,
                "count_ewma": (None if self.count_ewma is None
                               else round(self.count_ewma, 4)),
                "trend_per_s": round(self.trend_per_s, 6),
                "rung": self.rung,
                "pin": None if self.pin is None else list(self.pin)}


def repin_target(stream_id: str, live_indices: List[int]) -> int:
    """Deterministic re-pin choice: spread streams over the live set by
    a stable hash of the stream id (Python's ``hash`` is salted per
    process — two hosts would disagree; crc32 is stable everywhere)."""
    order = sorted(live_indices)
    return order[zlib.crc32(stream_id.encode()) % len(order)]


class StreamSessionRegistry:
    """Every stream session of one ``CountService``, plus the shared
    drain pricing the degradation ladder consults.

    sched: the service's ``ServeSched`` (may be None — the legacy
    timer/pad service): supplies the cost model that prices one more
    frame's launch.  policy: "priced" (the ladder) or "off" (sessions,
    stickiness and sequence hygiene only — a frame is never skipped).
    """

    def __init__(self, *, ttl_s: float = 300.0, clock=time.monotonic,
                 telemetry=None, sched=None, policy: str = "priced",
                 skip_enter: float = 1.0, skip_exit: float = 0.5,
                 reject_enter: float = 3.0, reject_exit: float = 1.5,
                 outstanding_high: int = 4, cooldown_s: float = 1.0,
                 session_event_every: int = 32):
        if policy not in ("priced", "off"):
            raise ValueError(f"unknown degrade policy {policy!r} "
                             f"(priced | off)")
        if not 0.0 <= skip_exit < skip_enter <= reject_exit < reject_enter:
            raise ValueError(
                "hysteresis bands must satisfy skip_exit < skip_enter <= "
                f"reject_exit < reject_enter, got {skip_exit}/{skip_enter}"
                f"/{reject_exit}/{reject_enter}")
        if outstanding_high < 1:
            raise ValueError(f"outstanding_high must be >= 1, got "
                             f"{outstanding_high}")
        self.ttl_s = float(ttl_s)
        self.policy = policy
        self.sched = sched
        self.telemetry = telemetry
        self.skip_enter = float(skip_enter)
        self.skip_exit = float(skip_exit)
        self.reject_enter = float(reject_enter)
        self.reject_exit = float(reject_exit)
        self.outstanding_high = int(outstanding_high)
        self.cooldown_s = float(cooldown_s)
        self.session_event_every = int(session_event_every)
        self._clock = clock
        # RLock: admit() may evict (which emits) while a completion on
        # another thread updates a session; the dump-path rule from the
        # incident layer (re-entry must never deadlock) applies here too
        self._lock = threading.RLock()
        self._sessions: Dict[str, StreamSession] = {}
        # per-bucket drain pricing: EWMA of execute seconds PER SLOT,
        # measured from every completed batch (stream or not) — warm by
        # the time the first stream needs a skip decision
        self._drain: Dict[Tuple[int, int], float] = {}
        self._last_sweep = 0.0
        self._sweep_every = max(min(self.ttl_s / 8.0, 5.0), 0.05)
        self._evicted_total = 0
        self._repins_total = 0
        self._degrade_transitions = 0

    # -- drain pricing (the sched core's cost model, in seconds) --------
    def observe_batch(self, bucket_hw, execute_s: float,
                      slots: int) -> None:
        """Fold one completed batch into the bucket's seconds-per-slot
        EWMA — the measured drain rate the ladder prices against."""
        if slots <= 0 or execute_s <= 0:
            return
        key = (int(bucket_hw[0]), int(bucket_hw[1]))
        s_slot = float(execute_s) / float(slots)
        with self._lock:
            got = self._drain.get(key)
            self._drain[key] = (s_slot if got is None else
                                (1 - DRAIN_EWMA_ALPHA) * got
                                + DRAIN_EWMA_ALPHA * s_slot)

    def expected_cost_s(self, bucket_hw) -> Optional[float]:
        """Priced cost (seconds) of serving ONE more frame at this
        bucket: the sched core's model — a lone frame launches
        ``cover_one(1)`` slots plus the launch overhead — times the
        bucket's measured seconds-per-slot.  None until a batch at this
        bucket has completed (no evidence, no skipping: a cold stream
        is always served)."""
        key = (int(bucket_hw[0]), int(bucket_hw[1]))
        with self._lock:
            s_slot = self._drain.get(key)
        if s_slot is None:
            return None
        if self.sched is not None:
            return s_slot * (self.sched.cover_one(1)
                             + self.sched.launch_cost_slots)
        return s_slot

    # -- admission --------------------------------------------------------
    def admit(self, stream_id: str, frame_seq: Optional[int],
              now: Optional[float] = None,
              bucket_hw: Optional[Tuple[int, int]] = None
              ) -> AdmitDecision:
        """One frame at the front door: sequence hygiene, arrival-rate
        update, the ladder decision.  Called by ``CountService.submit``
        BEFORE the queue — a skipped frame never touches it."""
        now = self._clock() if now is None else now
        events: List[Tuple[str, dict]] = []
        with self._lock:
            self._sweep_locked(now, events)
            sess = self._sessions.get(stream_id)
            if sess is None:
                sess = self._sessions[stream_id] = StreamSession(
                    stream_id, now)
                events.append(("stream.session",
                               {"state": "open",
                                "active": len(self._sessions),
                                **sess.snapshot()}))
            sess.last_seen_ts = now
            if bucket_hw is not None:
                sess.bucket_hw = (int(bucket_hw[0]), int(bucket_hw[1]))
            # monotonic frame sequence GATE: a duplicate or out-of-order
            # frame is rejected BEFORE it can double-serve or regress
            # the session (cameras retransmit; the fleet redispatches —
            # the sequence gate is what makes "exactly once per frame"
            # hold through both).  The seq is only COMMITTED further
            # down, once the frame is actually accepted (served or
            # degraded): a load-based reject (503 = "retry later") must
            # leave the sequence untouched, or the camera's retry of a
            # never-served frame would bounce off this gate as 409
            # forever.
            if frame_seq is not None:
                if sess.seq is not None and int(frame_seq) <= sess.seq:
                    sess.stale_rejects += 1
                    self._emit(events)
                    return AdmitDecision(
                        "stale", rung=sess.rung,
                        detail=f"frame_seq {frame_seq} <= last accepted "
                               f"{sess.seq} (duplicate or out-of-order)")
            # arrival-gap EWMA (the sched core's estimator): every real
            # new frame feeds it — including ones the reject rung is
            # about to refuse, or the pressure estimate would freeze at
            # its overload value and the rung could never exit when the
            # camera slows.  Retransmits (caught above) must not fake a
            # rate spike.
            if sess.t_last_arrival is not None:
                gap = max(now - sess.t_last_arrival, 0.0)
                sess.gap_ewma = (gap if sess.gap_n == 0 else
                                 (1 - GAP_EWMA_ALPHA) * sess.gap_ewma
                                 + GAP_EWMA_ALPHA * gap)
                sess.gap_n += 1
            sess.t_last_arrival = now
            rung = self._decide_locked(sess, now, events)
            if rung == STREAM_RUNG_REJECT:
                sess.overload_rejects += 1
                self._emit(events)
                return AdmitDecision(
                    "overload", rung=rung,
                    detail=f"stream {stream_id} on the reject rung "
                           f"(arrival rate sustained past drain "
                           f"capacity; outstanding {sess.outstanding})")
            prior_seq = sess.seq
            if frame_seq is not None:
                sess.seq = int(frame_seq)  # accepted: commit the gate
            if rung == STREAM_RUNG_SKIP and sess.count_ewma is not None:
                dec = self._degrade_locked(sess, now)
                dec.prior_seq = prior_seq
                self._emit(events)
                return dec
            # full inference (or skip rung on a cold stream with no
            # EWMA yet: the only honest answer is a real one)
            self._emit(events)
            return AdmitDecision("serve", rung=rung,
                                 prior_seq=prior_seq)

    def rollback_seq(self, stream_id: str, frame_seq: Optional[int],
                     prior_seq: Optional[int]) -> None:
        """Un-commit a frame the queue refused with nothing to degrade
        to: the 503'd frame was never answered, so its retry must pass
        the sequence gate.  No-op if a LATER frame already advanced the
        seq (the camera moved on; reviving an old number would re-open
        the gate behind it)."""
        if frame_seq is None:
            return
        with self._lock:
            sess = self._sessions.get(stream_id)
            if sess is not None and sess.seq == int(frame_seq):
                sess.seq = prior_seq

    def degrade_fallback(self, stream_id: str,
                         now: Optional[float] = None
                         ) -> Optional[AdmitDecision]:
        """Degraded answer for a frame the QUEUE just refused
        (queue_full / backpressure): the last rung before a reject —
        a stream with an EWMA gets the EWMA, not the undifferentiated
        reject a stateless client gets.  None when no EWMA exists."""
        if self.policy == "off":
            return None  # the ladder is off: a refusal stays a refusal
        now = self._clock() if now is None else now
        with self._lock:
            sess = self._sessions.get(stream_id)
            if sess is None or sess.count_ewma is None:
                return None
            return self._degrade_locked(sess, now)

    def _degrade_locked(self, sess: StreamSession,
                        now: float) -> AdmitDecision:
        sess.degraded += 1
        staleness = (now - sess.last_served_ts
                     if sess.last_served_ts is not None else None)
        return AdmitDecision(
            "degrade", count=float(sess.count_ewma),
            density=sess.density_ewma,
            staleness_s=(None if staleness is None
                         else round(max(staleness, 0.0), 6)),
            rung=sess.rung)

    # -- the ladder -------------------------------------------------------
    def _load_locked(self, sess: StreamSession) -> Optional[float]:
        """The stream's load score: max of arrival pressure (priced
        per-frame drain cost over the arrival-gap EWMA — > 1 means
        frames arrive faster than the fleet can serve them) and backlog
        pressure (outstanding over the allowance).  None when neither
        signal has evidence yet."""
        pressure = None
        if (self.policy == "priced" and sess.gap_n >= MIN_GAP_INTERVALS
                and sess.gap_ewma > 0.0 and sess.bucket_hw is not None):
            cost_s = self.expected_cost_s(sess.bucket_hw)
            if cost_s is not None:
                pressure = cost_s / sess.gap_ewma
        backlog = sess.outstanding / float(self.outstanding_high)
        if pressure is None:
            return backlog if sess.outstanding > 0 else None
        return max(pressure, backlog)

    def _decide_locked(self, sess: StreamSession, now: float,
                       events: list) -> str:
        if self.policy == "off":
            return STREAM_RUNG_FULL
        load = self._load_locked(sess)
        cur = _RUNGS.index(sess.rung)
        if load is None:
            target = 0
        else:
            up = (self.skip_enter, self.reject_enter)
            down = (self.skip_exit, self.reject_exit)
            target = cur
            while target < 2 and load >= up[target]:
                target += 1
            while target > 0 and load <= down[target - 1]:
                target -= 1
        if target != cur:
            # the flap bound: one rung CHANGE per cooldown, however fast
            # the load oscillates around a band edge (pinned)
            if now - sess.rung_since < self.cooldown_s:
                return sess.rung
            # can-tpu-lint: disable=LOCKHELD(_decide_locked runs only under admit()'s `with self._lock`; the _locked suffix is the contract)
            self._degrade_transitions += 1
            events.append(("stream.degrade",
                           {"stream": sess.stream_id,
                            "rung": _RUNGS[target],
                            "from_rung": _RUNGS[cur],
                            "load": (None if load is None
                                     else round(load, 4)),
                            "outstanding": sess.outstanding,
                            "cooldown_s": self.cooldown_s}))
            sess.rung = _RUNGS[target]
            sess.rung_since = now
        return sess.rung

    # -- completion / accounting -----------------------------------------
    def note_admitted(self, request) -> None:
        """A stream frame entered the queue: count it outstanding, and
        decrement when it resolves (result OR rejection — the request's
        done hook fires exactly once either way)."""
        sid = request.stream_id
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                return
            sess.outstanding += 1
        request.add_done_hook(lambda _r: self._note_done(sid))

    def _note_done(self, stream_id: str) -> None:
        with self._lock:
            sess = self._sessions.get(stream_id)
            if sess is not None and sess.outstanding > 0:
                sess.outstanding -= 1

    def note_completed(self, stream_id: str, count: float, density,
                       bucket_hw, *, now: Optional[float] = None,
                       replica: Optional[int] = None,
                       token: Optional[str] = None) -> None:
        """A frame came back from the device: fold it into the EWMA /
        trend, refresh the staleness anchor, and pin the stream to the
        serving replica if it has no pin yet (pins MOVE only via
        invalidation — work stealing must not thrash them)."""
        now = self._clock() if now is None else now
        events: List[Tuple[str, dict]] = []
        with self._lock:
            sess = self._sessions.get(stream_id)
            if sess is None:
                return
            prev, t_prev = sess.count_ewma, sess.last_served_ts
            if prev is None:
                sess.count_ewma = float(count)
            else:
                sess.count_ewma = ((1 - COUNT_EWMA_ALPHA) * prev
                                   + COUNT_EWMA_ALPHA * float(count))
                if t_prev is not None and now > t_prev:
                    slope = (sess.count_ewma - prev) / (now - t_prev)
                    sess.trend_per_s = ((1 - COUNT_EWMA_ALPHA)
                                        * sess.trend_per_s
                                        + COUNT_EWMA_ALPHA * slope)
            if density is not None:
                d = np.asarray(density, np.float32)
                if (sess.density_ewma is not None
                        and sess.density_ewma.shape == d.shape):
                    sess.density_ewma = (
                        (1 - COUNT_EWMA_ALPHA) * sess.density_ewma
                        + COUNT_EWMA_ALPHA * d)
                else:
                    sess.density_ewma = d.copy()
            sess.last_served_ts = now
            sess.last_seen_ts = now
            sess.served += 1
            sess.bucket_hw = (int(bucket_hw[0]), int(bucket_hw[1]))
            if sess.pin is None and replica is not None:
                sess.pin = (int(replica), str(token))
            if (self.session_event_every > 0
                    and sess.served % self.session_event_every == 0):
                events.append(("stream.session",
                               {"state": "snapshot",
                                "active": len(self._sessions),
                                "staleness_s": 0.0,
                                **sess.snapshot()}))
        self._emit(events)

    # -- sticky routing ---------------------------------------------------
    def pin_for(self, requests, live_tokens: Dict[int, str],
                now: Optional[float] = None) -> Optional[int]:
        """The replica this assembled batch PREFERS, from its stream
        pins: validate each stream's pin against the live
        ``{index: incarnation token}`` set (re-pinning invalid ones —
        the fault path: quarantine, wedge, scale-down, or a
        resurrection that replaced the incarnation), then majority-vote
        across the batch.  None for a batch with no pinned streams or
        an empty live set."""
        if not live_tokens:
            return None
        now = self._clock() if now is None else now
        events: List[Tuple[str, dict]] = []
        votes: Dict[int, int] = {}
        with self._lock:
            for r in requests:
                sid = getattr(r, "stream_id", None)
                if sid is None:
                    continue
                sess = self._sessions.get(sid)
                if sess is None or sess.pin is None:
                    continue
                idx, tok = sess.pin
                if live_tokens.get(idx) != tok:
                    # the pinned incarnation is gone (dead replica, or
                    # resurrected under a fresh engine): re-pin to a
                    # live one — a pinned stream must never wait behind
                    # a corpse
                    new_idx = repin_target(sid, list(live_tokens))
                    self._repins_total += 1
                    events.append(("stream.repin",
                                   {"stream": sid, "from_replica": idx,
                                    "to_replica": new_idx,
                                    "reason": "replica_lost"}))
                    sess.pin = (new_idx, live_tokens[new_idx])
                    idx = new_idx
                votes[idx] = votes.get(idx, 0) + 1
        self._emit(events)
        if not votes:
            return None
        # majority, smallest index on ties — deterministic per batch
        return min(votes, key=lambda k: (-votes[k], k))

    # -- TTL eviction -----------------------------------------------------
    def _sweep_locked(self, now: float, events: list) -> None:
        if now - self._last_sweep < self._sweep_every:
            return
        # can-tpu-lint: disable=LOCKHELD(_sweep_locked runs only under admit()/evict_idle()'s `with self._lock`; the _locked suffix is the contract)
        self._last_sweep = now
        dead = [sid for sid, s in self._sessions.items()
                if now - s.last_seen_ts >= self.ttl_s]
        for sid in dead:
            sess = self._sessions.pop(sid)
            # can-tpu-lint: disable=LOCKHELD(_sweep_locked runs only under the registry lock, see above)
            self._evicted_total += 1
            events.append(("stream.session",
                           {"state": "evicted",
                            "idle_s": round(now - sess.last_seen_ts, 3),
                            "active": len(self._sessions),
                            **sess.snapshot()}))

    def evict_idle(self, now: Optional[float] = None) -> int:
        """Force a TTL sweep (tests and the stats path); returns the
        number of sessions evicted."""
        now = self._clock() if now is None else now
        events: List[Tuple[str, dict]] = []
        with self._lock:
            before = len(self._sessions)
            self._last_sweep = 0.0
            self._sweep_locked(now, events)
            n = before - len(self._sessions)
        self._emit(events)
        return n

    # -- introspection ----------------------------------------------------
    def get(self, stream_id: str) -> Optional[StreamSession]:
        with self._lock:
            return self._sessions.get(stream_id)

    def active_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
            return {
                "sessions": len(sessions),
                "outstanding": sum(s.outstanding for s in sessions),
                "served_total": sum(s.served for s in sessions),
                "degraded_total": sum(s.degraded for s in sessions),
                "stale_rejects_total": sum(s.stale_rejects
                                           for s in sessions),
                "overload_rejects_total": sum(s.overload_rejects
                                              for s in sessions),
                "rungs": {r: sum(1 for s in sessions if s.rung == r)
                          for r in _RUNGS},
                "repins_total": self._repins_total,
                "evicted_total": self._evicted_total,
                "degrade_transitions": self._degrade_transitions,
            }

    # -- event plumbing ---------------------------------------------------
    def _emit(self, events: List[Tuple[str, dict]]) -> None:
        """Flush queued events OUTSIDE the registry lock where possible
        (callers batch under the lock, then call this; the RLock makes
        the occasional still-locked emit safe, never torn).  One literal
        emit per kind — the EMITKIND lint pins every declared kind to a
        real emitter, and a variable-kind loop would hide all three."""
        if self.telemetry is None:
            events.clear()
            return
        for kind, payload in events:
            if kind == "stream.session":
                self.telemetry.emit("stream.session", **payload)
            elif kind == "stream.degrade":
                self.telemetry.emit("stream.degrade", **payload)
            else:
                self.telemetry.emit("stream.repin", **payload)
        events.clear()
