"""FlightRecorder: a bounded ring-buffer sink — the black box.

Counterpart of ``can_tpu/obs/flightrec.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The JSONL sink records everything forever; the exporter holds the latest
gauge values; NEITHER answers "what were the last thirty seconds of this
process's life" at the moment something dies.  A preempted host has a few
hundred milliseconds between SIGTERM and SIGKILL, a quarantined replica's
context is scattered across a multi-GB artifact, and a NaN abort's
interesting window is the steps right BEFORE the alert.  The recorder
keeps exactly that window in memory: one bounded ring per event kind
(chatty kinds — spans, step windows — cannot evict the rare ones — the
alert that explains the crash), appended O(1) from the bus's sink
fan-out and snapshotted wholesale into an incident bundle
(``obs/incidents.py``) when a trigger fires.

Cost discipline: the recorder is an ordinary bus sink, so a default run
(``telemetry=None``) never constructs one and pays nothing; an armed run
pays one deque append per event behind a single uncontended lock (the
lock exists for the snapshot path — ``collections.deque`` iteration
raises if a concurrent append mutates it mid-copy).  No serialisation,
no I/O, no per-event allocation beyond the event dict the bus already
built.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional

#: default events kept per kind; chatty kinds get their own caps below
DEFAULT_CAPACITY = 256

#: per-kind capacity overrides: high-rate kinds keep a deeper window
#: (a serve box does hundreds of requests/spans per second; 256 would be
#: under a second of context), metronome kinds keep a shallow one (64
#: heartbeats IS the liveness tail — more adds nothing)
DEFAULT_KIND_CAPACITY = {
    "trace.span": 1024,
    "serve.request": 1024,
    "serve.batch": 512,
    "step_window": 512,
    "heartbeat": 64,
}


class FlightRecorder:
    """Per-kind bounded rings over the telemetry stream.

    ``capacity``: default events kept per kind; ``kind_capacity`` maps
    kind -> its own cap (merged over :data:`DEFAULT_KIND_CAPACITY`).
    ``retain_s``: optional age bound applied at SNAPSHOT time (the ring
    itself is count-bounded — pruning by age per append would make the
    hot path O(evictions)); None keeps everything the rings hold.
    """

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 kind_capacity: Optional[Dict[str, int]] = None,
                 retain_s: Optional[float] = None):
        self.capacity = int(capacity)
        self.kind_capacity = dict(DEFAULT_KIND_CAPACITY)
        if kind_capacity:
            self.kind_capacity.update(kind_capacity)
        self.retain_s = retain_s
        # RLock: the SIGTERM handler's snapshot may interrupt the main
        # thread INSIDE emit()'s critical section (signals run on the
        # main thread between bytecodes) — same-thread re-entry must
        # succeed or the preemption dump deadlocks (obs/incidents.py)
        self._lock = threading.RLock()
        self._rings: Dict[str, deque] = {}
        self._seen: Dict[str, int] = {}

    # -- bus sink protocol ------------------------------------------------
    def emit(self, event: dict) -> None:
        kind = event.get("kind", "?")
        with self._lock:
            ring = self._rings.get(kind)
            if ring is None:
                cap = max(1, int(self.kind_capacity.get(kind,
                                                        self.capacity)))
                ring = self._rings[kind] = deque(maxlen=cap)
            ring.append(event)
            self._seen[kind] = self._seen.get(kind, 0) + 1

    def close(self) -> None:
        pass  # in-memory only; the bundle dump is the flush

    # -- reads ------------------------------------------------------------
    def snapshot(self, *, now: Optional[float] = None) -> List[dict]:
        """Every retained event, merged across kinds and sorted by the
        bus wall-clock ``ts`` (stable, so same-ts events keep their
        per-kind order).  ``now`` + ``retain_s`` bound the age; events
        without a numeric ts are kept (age unknowable, and dropping them
        would hide exactly the malformed event worth seeing)."""
        with self._lock:
            events = [e for ring in self._rings.values() for e in ring]
        if self.retain_s is not None and now is not None:
            floor = now - self.retain_s
            events = [e for e in events
                      if not isinstance(e.get("ts"), (int, float))
                      or e["ts"] >= floor]
        return sorted(events,
                      key=lambda e: (e.get("ts")
                                     if isinstance(e.get("ts"), (int, float))
                                     else 0.0))

    def stats(self) -> Dict[str, dict]:
        """Per-kind accounting for the bundle manifest: kept / seen /
        evicted / capacity.  ``evicted = seen - kept`` is exact because
        the rings only ever drop from the head on overflow."""
        with self._lock:
            return {kind: {"kept": len(ring),
                           "seen": self._seen.get(kind, 0),
                           "evicted": self._seen.get(kind, 0) - len(ring),
                           "capacity": ring.maxlen}
                    for kind, ring in sorted(self._rings.items())}

    def dump(self, path: str, *, now: Optional[float] = None) -> int:
        """Write the snapshot as telemetry-schema JSONL (the SAME format
        the per-host files use, so ``run_monitor`` / ``trace_export`` /
        ``telemetry_report`` read a ring dump with zero changes).
        Returns the event count."""
        events = self.snapshot(now=now)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)
