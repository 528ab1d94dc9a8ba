"""Elastic preemption signal files: the monitor ↔ supervisor interface.

Counterpart of ``can_tpu/obs/signals.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

One tiny JSON file per (kind, host) in a shared directory is how
detection and reaction COMPOSE without a new daemon: ``tools/
run_monitor.py --emit-signal`` writes a ``dead`` file when a host's
heartbeat goes stale, a preempted host's SIGTERM hook writes its own
``leave`` file, and the elastic supervisor (parallel/elastic.py) polls
the directory from its per-step hook — whoever detects first, the
reaction path is the same.  ``stay`` files carry a survivor's
re-rendezvous address through a shrink.

Writes are atomic (tmp + rename) so a reader never sees a torn file;
foreign/undecodable JSON is skipped on read.  This module lives in
``obs`` (not beside the supervisor) because it must be importable
with the standard library alone — run_monitor's contract is pure
host-side file reading, runnable on any machine the artifacts were copied to.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, List, Optional, Set

SIGNAL_SCHEMA = "can_tpu.elastic.signal.v1"
SIGNAL_KINDS = ("leave", "dead", "stay")


def signal_path(signal_dir: str, kind: str, host_id: int) -> str:
    return os.path.join(signal_dir, f"signal-{kind}-h{int(host_id)}.json")


def write_signal(signal_dir: str, *, kind: str, host_id: int, reason: str,
                 detail: Optional[dict] = None,
                 ts: Optional[float] = None) -> str:
    """One machine-readable elastic signal file, written atomically.

    * ``leave`` — a host announces its own preemption (SIGTERM hook);
    * ``dead``  — an external monitor declares a host dead
      (``run_monitor --emit-signal``);
    * ``stay``  — a survivor advertises its re-rendezvous address during
      a shrink (consumed by ``elastic.reform_coordinator``).
    """
    if kind not in SIGNAL_KINDS:
        raise ValueError(f"unknown signal kind {kind!r} "
                         f"(known: {', '.join(SIGNAL_KINDS)})")
    os.makedirs(signal_dir, exist_ok=True)
    path = signal_path(signal_dir, kind, host_id)
    doc = {"schema": SIGNAL_SCHEMA, "kind": kind, "host_id": int(host_id),
           "reason": str(reason), "ts": time.time() if ts is None else ts,
           "detail": detail or {}}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def read_signals(signal_dir: str) -> List[dict]:
    """Every valid signal file in the dir, sorted by filename.  Torn or
    foreign JSON is skipped (atomic writes make torn rare; skipping is
    the correct read for a shared directory)."""
    out = []
    try:
        names = sorted(os.listdir(signal_dir))
    except OSError:
        return []
    for name in names:
        if not (name.startswith("signal-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(signal_dir, name)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(doc, dict) and doc.get("schema") == SIGNAL_SCHEMA:
            out.append(doc)
    return out


def leaver_hosts(signals: Iterable[dict]) -> Set[int]:
    """Hosts that leave/dead signals name — a host's local contribution
    to the fleet's shrink agreement mask."""
    return {int(s["host_id"]) for s in signals
            if s.get("kind") in ("leave", "dead")
            and isinstance(s.get("host_id"), int)}
