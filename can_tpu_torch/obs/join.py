"""Multi-host telemetry join: discovery, incremental tailing, clock-skew
offsets, and ts-merge — the ONE implementation every fleet-level reader
shares.

Counterpart of ``can_tpu/obs/join.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

Before this module, three tools each carried their own copy of "find the
``telemetry.host{k}.jsonl`` files, read them with torn-line counting,
merge by timestamp": ``tools/run_monitor.py`` (liveness), ``tools/
slo_report.py`` (grading), ``tools/trace_export.py`` (flame views).  The
live ``FleetCollector`` (obs/collector.py) is a fourth consumer — and the
one for which drift would be fatal, because its correctness oracle is
"the offline replay of the same files grades bit-identically".  So the
join lives here once, and a cross-tool consistency test pins all four to
it.

Clock-skew model (shared by the live and offline paths):

* every host stamps events with ITS OWN wall clock (``obs/bus.py``
  ``clock=time.time``); hosts drift, so a raw ts-merge interleaves
  wrongly and staleness-vs-newest-event lets a fast clock mask a dead
  peer;
* a per-host OFFSET (``offset_s > 0`` ⇒ that host's clock runs fast) is
  subtracted before any merge or staleness judgement:
  ``corrected = ts - offset``;
* offline, with no receive-time to compare against, the offset is
  estimated from the first heartbeat per host against the fleet median
  (hosts start together far more reliably than their clocks agree — the
  same anchor ``trace_export`` always used for span re-anchoring); the
  live collector measures it directly (heartbeat ts vs receive time) and
  records it in its snapshot manifest, which then WINS over estimation;
* offsets within ``snap_s`` of zero snap to exactly ``0.0``: ordinary
  emit jitter is not skew, and a snapped offset keeps single-clock
  fixtures byte-identical through the corrected path.

Pure host-side code (tools run on any machine the
artifacts were copied to).
"""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from can_tpu_torch.obs.report import read_events_counted

HOST_FILE_RE = re.compile(r"telemetry\.host(\d+)\.jsonl$")

#: offsets smaller than this are measurement noise, not skew — snapped
#: to 0.0 so the corrected path is a no-op on single-clock runs.
DEFAULT_SNAP_S = 30.0

#: manifest name marking a directory as a FleetCollector snapshot
#: (written last, atomically — same contract as incident bundles).
COLLECTOR_MANIFEST = "collector.json"
COLLECTOR_SCHEMA = "can_tpu.collector.v1"


def host_file_name(host_id: int) -> str:
    return f"telemetry.host{int(host_id)}.jsonl"


def discover_host_files(run_dir: str) -> Dict[int, str]:
    """``host_id -> path`` for every per-host file in ``run_dir``,
    sorted by host id (the canonical concatenation order)."""
    hosts: Dict[int, str] = {}
    for path in glob.glob(os.path.join(run_dir, "telemetry.host*.jsonl")):
        m = HOST_FILE_RE.search(path)
        if m:
            hosts[int(m.group(1))] = path
    return dict(sorted(hosts.items()))


def read_host_events(paths: Dict[int, str]
                     ) -> Tuple[Dict[int, list], Dict[int, int]]:
    """Read every per-host file with torn-line counting
    (``read_events_counted`` semantics: a complete line that fails to
    decode is counted skipped, never silently dropped)."""
    events: Dict[int, list] = {}
    skipped: Dict[int, int] = {}
    for hid in sorted(paths):
        events[hid], skipped[hid] = read_events_counted(paths[hid])
    return events, skipped


def corrected_ts(ts: float, offset: float) -> float:
    """THE skew correction — one expression, imported by both the live
    collector and the offline replay so the floats are bit-identical."""
    return ts - offset


def apply_offsets(events: Iterable[dict], offset: float) -> List[dict]:
    """Skew-correct one host's events (shallow copies; the zero-offset
    path returns the originals untouched so single-clock runs replay
    byte-identically)."""
    if not offset:
        return list(events)
    out = []
    for e in events:
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            e = dict(e, ts=corrected_ts(float(ts), offset))
        out.append(e)
    return out


def join_events(events_by_host: Dict[int, Sequence[dict]],
                offsets: Optional[Dict[int, float]] = None) -> List[dict]:
    """Concatenate per-host streams in sorted-host order with offsets
    applied.  This IS the merge contract: downstream consumers that need
    time order stable-sort by ``ts``, so equal timestamps resolve to
    (host, line) order — exactly what the live collector's
    ``(corrected_ts, host, seq)`` release key reproduces."""
    offsets = offsets or {}
    out: List[dict] = []
    for hid in sorted(events_by_host):
        out.extend(apply_offsets(events_by_host[hid],
                                 float(offsets.get(hid, 0.0))))
    return out


def first_heartbeat_ts(events: Iterable[dict]) -> Optional[float]:
    """First heartbeat timestamp in stream order (the offline skew
    anchor — NOT min over ts, so a restarted host anchors at its
    original start)."""
    for e in events:
        if e.get("kind") == "heartbeat" \
                and isinstance(e.get("ts"), (int, float)):
            return float(e["ts"])
    return None


def snap_offset(offset: float, *, snap_s: float = DEFAULT_SNAP_S) -> float:
    return 0.0 if abs(offset) < snap_s else float(offset)


def estimate_offsets(first_ts_by_host: Dict[int, Optional[float]], *,
                     snap_s: float = DEFAULT_SNAP_S) -> Dict[int, float]:
    """Post-hoc skew estimate: each host's first heartbeat against the
    fleet median first heartbeat.  Median, not min — one fast clock
    should read as "that host is fast", not as "everyone else is slow".
    A host without heartbeats gets offset 0 (nothing to anchor on)."""
    anchors = {h: t for h, t in first_ts_by_host.items() if t is not None}
    if len(anchors) < 2:
        return {h: 0.0 for h in first_ts_by_host}
    med = statistics.median(anchors.values())
    return {h: (snap_offset(anchors[h] - med, snap_s=snap_s)
                if h in anchors else 0.0)
            for h in first_ts_by_host}


def corrected_staleness(last_ts: Optional[float], offset: float,
                        now: float) -> Optional[float]:
    """Age of a host's newest (heartbeat) event on the CORRECTED
    clock — the one liveness rule both ``run_monitor`` modes and the
    live collector route through, so a host whose fast clock inflates
    its raw timestamps cannot mask a dead peer (or read live while
    dead)."""
    if last_ts is None:
        return None
    return now - corrected_ts(float(last_ts), offset)


# --- collector snapshots -------------------------------------------------
def is_collector_snapshot(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COLLECTOR_MANIFEST))


def load_collector_manifest(path: str) -> Optional[dict]:
    """The snapshot manifest, or None when absent/torn (the collector
    writes it atomically via tmp+rename, so a partial read means a torn
    copy, not a torn write)."""
    mpath = os.path.join(path, COLLECTOR_MANIFEST)
    try:
        with open(mpath) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return m if isinstance(m, dict) else None


def collector_offsets(manifest: Optional[dict]) -> Dict[int, float]:
    """Measured per-host clock offsets from a snapshot manifest — these
    WIN over post-hoc estimation (the collector saw receive times; the
    estimator only guesses from start alignment)."""
    out: Dict[int, float] = {}
    for hid, h in ((manifest or {}).get("hosts") or {}).items():
        try:
            out[int(hid)] = float((h or {}).get("clock_offset_s", 0.0))
        except (TypeError, ValueError):
            out[int(hid)] = 0.0
    return out


def resolve_offsets(run_dir: str,
                    events_by_host: Dict[int, Sequence[dict]], *,
                    snap_s: float = DEFAULT_SNAP_S) -> Dict[int, float]:
    """The offset source for a directory of per-host files: a collector
    snapshot's measured offsets when present, else the post-hoc
    first-heartbeat estimate."""
    if is_collector_snapshot(run_dir):
        measured = collector_offsets(load_collector_manifest(run_dir))
        return {h: float(measured.get(h, 0.0)) for h in events_by_host}
    return estimate_offsets(
        {h: first_heartbeat_ts(evs) for h, evs in events_by_host.items()},
        snap_s=snap_s)


def resolve_telemetry_source(target: str) -> Tuple[List[str], str]:
    """Shared path resolution for the offline tools: a telemetry JSONL
    file -> [it]; an incident bundle dir -> its ring dump; a run dir or
    collector snapshot -> its per-host files.  Returns ``(paths,
    source_kind)`` with kind in ``{"file", "bundle", "snapshot",
    "run"}``.  Raises ``SystemExit`` (usage-class) on an empty/missing
    target — callers map it to exit 2."""
    # local import: incidents pulls in nothing heavy, but keeping the
    # module-level deps minimal keeps join importable everywhere
    from can_tpu_torch.obs.incidents import (
        MANIFEST_NAME,
        bundle_ring_path,
        is_bundle_dir,
    )
    if os.path.isdir(target):
        if is_bundle_dir(target):
            try:
                return [bundle_ring_path(target)], "bundle"
            except ValueError as e:
                raise SystemExit(str(e))
        paths = [p for _, p in sorted(discover_host_files(target).items())]
        if not paths:
            raise SystemExit(
                f"no telemetry.host*.jsonl files (or {MANIFEST_NAME} / "
                f"{COLLECTOR_MANIFEST}) in {target}")
        return paths, ("snapshot" if is_collector_snapshot(target)
                       else "run")
    if not os.path.isfile(target):
        raise SystemExit(f"no such file or directory: {target}")
    return [target], "file"


def load_joined_events(target: str, *, estimate: bool = False,
                       snap_s: float = DEFAULT_SNAP_S
                       ) -> Tuple[List[dict], int, dict]:
    """One-call join for the offline tools: resolve ``target``, read
    with torn-line counting, skew-correct, concatenate.  Returns
    ``(events, skipped_lines, meta)`` with ``meta = {"kind", "offsets",
    "paths"}``.

    Offset policy: a collector snapshot's MEASURED offsets always
    apply; post-hoc ESTIMATION is opt-in (``estimate=True``) — liveness
    and trace re-anchoring want it (a fast clock must not mask a dead
    peer), but SLO grading of a plain run dir must not re-time events on
    a guess (a legitimately staggered start is not clock skew), so
    ``slo_report`` leaves it off."""
    paths, kind = resolve_telemetry_source(target)
    if kind in ("run", "snapshot"):
        hosts = discover_host_files(target)
        events_by_host, skipped = read_host_events(hosts)
        if kind == "snapshot":
            measured = collector_offsets(load_collector_manifest(target))
            offsets = {h: float(measured.get(h, 0.0))
                       for h in events_by_host}
        elif estimate:
            offsets = estimate_offsets(
                {h: first_heartbeat_ts(evs)
                 for h, evs in events_by_host.items()}, snap_s=snap_s)
        else:
            offsets = {h: 0.0 for h in events_by_host}
        return (join_events(events_by_host, offsets),
                sum(skipped.values()),
                {"kind": kind, "offsets": offsets,
                 "paths": [hosts[h] for h in sorted(hosts)]})
    events: List[dict] = []
    skipped_n = 0
    for p in paths:
        evs, sk = read_events_counted(p)
        events.extend(evs)
        skipped_n += sk
    return events, skipped_n, {"kind": kind, "offsets": {},
                               "paths": paths}


class HostTail:
    """Incremental JSONL reader: remembers the byte offset and keeps a
    partial trailing line in a buffer, so each poll costs O(new bytes)
    instead of re-parsing a multi-day run's whole file.  A line without
    its newline yet is a write IN PROGRESS, not a torn tail — it stays
    buffered until complete (only a decode failure on a COMPLETE line
    counts as skipped).  File truncation (rotation) resets the tail.

    Two consumption styles: ``run_monitor --follow`` re-reads the
    cumulative ``events`` list each poll; the live collector calls
    ``drain()`` to take ownership of just the new events (bounded
    memory — the collector archives them, it must not also hoard
    them)."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self._buf = ""
        self.events: list = []
        self.skipped = 0

    def poll(self) -> None:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return  # transiently unreadable; next poll retries
        if size < self.offset:  # truncated/rotated underneath us
            self.offset, self._buf = 0, ""
            self.events, self.skipped = [], 0
        with open(self.path) as f:
            f.seek(self.offset)
            chunk = f.read()
            self.offset = f.tell()
        *lines, self._buf = (self._buf + chunk).split("\n")
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                self.events.append(json.loads(line))
            except json.JSONDecodeError:
                self.skipped += 1

    def drain(self) -> list:
        """Take the accumulated events (clears the list, keeps the byte
        offset and partial-line buffer — the tail keeps tailing)."""
        out, self.events = self.events, []
        return out
