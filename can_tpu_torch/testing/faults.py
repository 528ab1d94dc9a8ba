"""Deterministic fault injection (counterpart of
``can_tpu/testing/faults.py``, copied whole: the same trigger, schema,
hooks and decisions).

Elastic shrink-and-continue is untestable without controlled failure: "a
host dies mid-epoch" must be reproducible to the step, or a chaos test
proves nothing and flakes forever.  This module delivers a SEEDED,
explicit fault schedule to real processes through an environment
trigger, so a worker can be killed at exactly step s of epoch e, a
checkpoint write can fail exactly n times, a rendezvous barrier can be
held past its timeout, and a serving replica can crash or hang at its
n-th batch — with zero cost and zero code reached when the variable is
unset.

Delivery: ``CAN_TPU_FAULTS`` holds either inline JSON or a path to a
JSON file (the file trigger lets a launcher write the schedule once and
point every worker at it).  Schema::

    {"faults": [
        {"kind": "kill", "rank": 1, "step": 3, "epoch": 0,
         "signal": "SIGTERM"},
        {"kind": "ckpt_io", "op": "save", "fails": 2, "rank": 0},
        {"kind": "rendezvous_timeout", "barrier": "elastic", "rank": 1,
         "delay_s": 30.0},
        {"kind": "replica_crash", "replica": 0, "batch": 3},
        {"kind": "replica_hang", "replica": 1, "batch": 2,
         "delay_s": 30.0},
        {"kind": "stream_burst", "stream": "cam0", "frame": 5,
         "burst": 8},
        {"kind": "frame_gap", "stream": "cam1", "frame": 4,
         "mode": "dup"}
    ]}

* ``kill`` — at the matching (rank, epoch, step) boundary the injector
  sends the named signal to ITS OWN process (default SIGTERM: the
  preemption notice, so the real grace-window choreography runs exactly
  as it would under a preemptor; SIGKILL for the no-grace hard death).
* ``ckpt_io`` — the first ``fails`` attempts of the matching checkpoint
  op raise ``InjectedFault`` (an OSError: the transient-FS class a
  checkpoint retry loop absorbs; set ``fails`` above the retry budget to
  exercise the give-up).
* ``rendezvous_timeout`` — the matching rank holds the matching barrier
  for ``delay_s`` before joining, so every OTHER member's bounded
  barrier times out for real.
* ``replica_crash`` — serve-side: when fleet replica ``replica`` is
  about to execute its ``batch``-th micro-batch (1-based, counted per
  replica), the hook raises ``InjectedFault`` INSIDE the worker's
  predict path, so the real quarantine → probation → resurrection
  choreography (``serve/fleet.py``) runs exactly as on a device fault.
  Fires once.
* ``replica_hang`` — serve-side: the matching (replica, batch) launch
  SLEEPS ``delay_s`` while holding the replica's dispatch lock — a
  wedged execute from the fleet's point of view — so the hang
  watchdog's deadline, batch re-dispatch, and wedged-replica probation
  run for real.  Fires once.
* ``stream_burst`` — client-side: when the matching (stream, frame) is
  about to be sent, the load generator submits ``burst`` EXTRA frames
  back-to-back first — an arrival-rate spike on ONE camera, the load
  shape the degradation ladder (``serve/streams.py``) exists to absorb.
  Fires once.
* ``frame_gap`` — client-side: the matching (stream, frame) is
  delivered wrong — ``mode: "dup"`` re-sends the previous frame's
  sequence number, ``mode: "reorder"`` sends this frame's seq minus
  two — so the session's monotonic-sequence gate runs for real.  Fires
  once.

The stream kinds are directives to the LOAD GENERATOR (a stream client
calls ``on_stream_frame`` before each submit and perturbs its own
traffic), because arrival timing and frame ordering belong to the
client side of the protocol.

Hooks are consulted only from sites that already gate on
``active_injector()``.  In this package that is the fleet worker's
``on_serve_batch`` (``serve/fleet.py``); the training hooks
(``on_step``, ``on_ckpt_io``, ``on_barrier``) wait for elastic training
(ROADMAP Queue 1 item 6), which calls them unchanged.  A production run
without the variable never constructs an injector.

``make_kill_schedule`` derives the kill step from a seed: chaos runs
randomise WHERE the fault lands across seeds while any single seed
reproduces exactly.

Standard library only: importable by any worker before torch loads.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import time
from typing import Dict, List, Optional

FAULTS_ENV = "CAN_TPU_FAULTS"


class InjectedFault(OSError):
    """A fault the schedule asked for (OSError: checkpoint-I/O faults
    must look like the transient filesystem errors the retry path
    handles)."""


def make_kill_schedule(seed: int, *, rank: int, max_step: int,
                       epoch: int = 0, min_step: int = 1,
                       sig: str = "SIGTERM") -> dict:
    """A one-kill schedule whose step is drawn from ``seed`` — different
    seeds move the preemption around the epoch, one seed reproduces
    bit-exactly.  Pure arithmetic (no numpy): workers import this before
    heavyweight deps."""
    if max_step < min_step:
        raise ValueError(f"max_step {max_step} < min_step {min_step}")
    # sha256 of the full key: well-mixed and deterministic across
    # platforms/processes (a cheap LCG scramble had degenerate low bits)
    import hashlib

    digest = hashlib.sha256(
        f"can_tpu.faults:{seed}:{rank}:{epoch}".encode()).digest()
    x = int.from_bytes(digest[:8], "big")
    step = min_step + x % (max_step - min_step + 1)
    return {"faults": [{"kind": "kill", "rank": int(rank),
                        "epoch": int(epoch), "step": int(step),
                        "signal": sig}]}


class FaultInjector:
    """Parsed fault schedule + per-site hooks.  Construct via
    :func:`active_injector` (env-gated) or directly in unit tests."""

    def __init__(self, spec: dict):
        faults = spec.get("faults")
        if not isinstance(faults, list):
            raise ValueError(
                "fault schedule must be {'faults': [...]}; got "
                f"{type(spec).__name__} without a fault list")
        self.faults: List[dict] = []
        for f in faults:
            if not isinstance(f, dict) or "kind" not in f:
                raise ValueError(f"malformed fault entry: {f!r}")
            if f["kind"] not in ("kill", "ckpt_io", "rendezvous_timeout",
                                 "replica_crash", "replica_hang",
                                 "stream_burst", "frame_gap"):
                raise ValueError(f"unknown fault kind {f['kind']!r}")
            if (f["kind"] == "frame_gap"
                    and f.get("mode", "dup") not in ("dup", "reorder")):
                raise ValueError(
                    f"frame_gap mode must be dup|reorder, got "
                    f"{f.get('mode')!r}")
            self.faults.append(dict(f))
        self._ckpt_attempts: Dict[str, int] = {}
        self.fired: List[dict] = []  # delivered faults, for assertions

    # -- hooks ------------------------------------------------------------
    def on_step(self, step: int, *, epoch: int = 0,
                rank: int = 0) -> None:
        """Train-loop boundary: deliver any matching ``kill`` by
        signalling OUR OWN process — the real handler chain (incident
        bundle, elastic leave flag) runs, exactly like an external
        preemptor's notice."""
        for f in self.faults:
            if (f["kind"] == "kill" and not f.get("_fired")
                    and int(f.get("rank", 0)) == rank
                    and int(f.get("epoch", 0)) == epoch
                    and int(f.get("step", 0)) == step):
                f["_fired"] = True
                self.fired.append(f)
                signum = getattr(_signal,
                                 str(f.get("signal", "SIGTERM")))
                os.kill(os.getpid(), signum)

    def on_ckpt_io(self, op: str, *, rank: int = 0) -> None:
        """Checkpoint save/restore attempt: raise for the first ``fails``
        matching attempts (a checkpoint retry loop consults this inside
        the loop — passing its real process index — so the backoff path
        is exercised for real).  A fault entry WITHOUT ``rank``
        fires on every process; with one, only on that rank."""
        for i, f in enumerate(self.faults):
            if f["kind"] != "ckpt_io" or f.get("op", "save") != op:
                continue
            frank = f.get("rank")
            if frank is not None and int(frank) != rank:
                continue
            key = f"{i}:{op}"
            n = self._ckpt_attempts.get(key, 0) + 1
            self._ckpt_attempts[key] = n
            if n <= int(f.get("fails", 1)):
                self.fired.append(f)
                raise InjectedFault(
                    f"injected checkpoint {op} I/O error "
                    f"(attempt {n}/{f.get('fails', 1)})")

    def on_serve_batch(self, *, replica: int = 0,
                       batch_index: int = 1) -> None:
        """Fleet-worker launch boundary (serve/fleet.py consults this
        inside the predict try, under the replica's dispatch lock):
        ``replica_crash`` raises into the quarantine path;
        ``replica_hang`` sleeps the worker — a wedged execute — into the
        watchdog's.  ``batch_index`` is 1-based per replica."""
        for f in self.faults:
            if (f["kind"] not in ("replica_crash", "replica_hang")
                    or f.get("_fired")
                    or int(f.get("replica", 0)) != replica
                    or int(f.get("batch", 1)) != batch_index):
                continue
            f["_fired"] = True
            self.fired.append(f)
            if f["kind"] == "replica_hang":
                time.sleep(float(f.get("delay_s", 30.0)))
            else:
                raise InjectedFault(
                    f"injected replica {replica} crash at batch "
                    f"{batch_index}")

    def on_stream_frame(self, *, stream: str = "",
                        frame: int = 1) -> Optional[dict]:
        """Stream-client boundary (consulted BEFORE the client submits
        the matching 1-based ``frame`` of ``stream``): returns the
        matching directive — ``{"kind": "stream_burst", "burst": n}``
        (submit n extra frames back-to-back first) or ``{"kind":
        "frame_gap", "mode": "dup"|"reorder"}`` (deliver this frame
        duplicated / out of order) — or None.  Fires once per entry."""
        for f in self.faults:
            if (f["kind"] not in ("stream_burst", "frame_gap")
                    or f.get("_fired")
                    or str(f.get("stream", "")) != stream
                    or int(f.get("frame", 1)) != frame):
                continue
            f["_fired"] = True
            self.fired.append(f)
            if f["kind"] == "stream_burst":
                return {"kind": "stream_burst",
                        "burst": int(f.get("burst", 8))}
            return {"kind": "frame_gap",
                    "mode": str(f.get("mode", "dup"))}
        return None

    def on_barrier(self, name: str, *, rank: int = 0) -> None:
        """Barrier entry: the matching rank HOLDS the barrier for
        ``delay_s`` — every other member's bounded wait then times out
        for real (a bounded barrier consults this before joining)."""
        for f in self.faults:
            if (f["kind"] == "rendezvous_timeout" and not f.get("_fired")
                    and int(f.get("rank", 0)) == rank
                    and str(f.get("barrier", "")) in name):
                f["_fired"] = True
                self.fired.append(f)
                time.sleep(float(f.get("delay_s", 30.0)))


_CACHED: Optional[FaultInjector] = None
_CACHED_SPEC: Optional[str] = None


def active_injector() -> Optional[FaultInjector]:
    """The process's injector, or None when ``CAN_TPU_FAULTS`` is unset —
    the one gate every production hook site checks.  The parsed injector
    is cached per spec value (attempt counters must persist across
    hook calls); a malformed schedule raises loudly at the FIRST hook
    rather than silently running the chaos test without its chaos."""
    global _CACHED, _CACHED_SPEC
    spec = os.environ.get(FAULTS_ENV, "")
    if not spec:
        return None
    if _CACHED is not None and spec == _CACHED_SPEC:
        return _CACHED
    text = spec
    if not spec.lstrip().startswith("{"):
        with open(spec) as f:  # a path trigger
            text = f.read()
    _CACHED = FaultInjector(json.loads(text))
    _CACHED_SPEC = spec
    return _CACHED
