"""Live fleet observability plane: cross-host ingest, global SLO burn,
skew-corrected liveness, federated /metrics.

Counterpart of ``can_tpu/obs/collector.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

Every fleet-level question used to be answered POST-HOC: run_monitor,
slo_report and trace_export join the per-host ``telemetry.host*.jsonl``
after the fact, and every live gauge/burn is per host.  The
:class:`FleetCollector` is the live join — one daemon that:

* **ingests** per-host telemetry two ways: tailing local host files
  (the ``obs/join.py`` :class:`~can_tpu_torch.obs.join.HostTail` incremental
  machinery — O(new bytes) per poll, in-progress lines buffered), and an
  HTTP ``POST /ingest`` endpoint for hosts without a shared filesystem
  (batched JSONL, shipped by :class:`CollectorPushSink` riding the
  emitting host's own bus);
* **estimates clock skew** per host: each heartbeat's ``ts`` against the
  collector's receive clock; the offset freezes at the median of the
  first few samples (snapped to zero under ``snap_s`` — emit latency is
  not skew) and is subtracted before ANY merge or liveness judgement,
  surfaced as ``can_tpu_host_clock_skew_s{host}``;
* **evaluates GLOBAL SLO burn** by releasing the joined stream in
  ``(corrected_ts, host, seq)`` order — a watermark merge: events are
  held until every live host has reported past them — into ONE
  ``obs/slo.py`` engine.  The correctness oracle: replaying the
  snapshot's host files offline through ``slo_report`` (which applies
  the manifest's recorded offsets) grades BIT-IDENTICALLY — same
  ``slo.burn`` payload sequence, same verdict — because the release
  order reproduces exactly the offline stable-sort-by-ts of the files
  concatenated in host order, and both sides share the same feed/tail/
  aggregate code (``slo.replay_evals`` / ``slo.aggregate_grade``).
  Burn evaluation rides the EVENT clock, never the wall clock — a
  quiet fleet stops evaluating, exactly like the replay;
* **detects silent hosts**: heartbeat staleness on the CORRECTED clock
  (``join.corrected_staleness``) past ``stale_after_s`` marks the host
  stale — "no data ≠ healthy" — emitting one edge-triggered
  ``fleet.host`` event (incident bundle via ``obs/incidents.py``) and,
  when ``signal_dir`` is set, the same ``dead`` signal file grammar
  ``run_monitor --emit-signal`` writes, so detection drives the elastic
  shrink reaction with no new plumbing.  A stale host drops out of the
  watermark so the live stream keeps flowing without it;
* **bounds memory**: per-host gauges are O(metrics), recent raw events
  ride a per-host :class:`~can_tpu_torch.obs.flightrec.FlightRecorder` ring
  (chatty kinds capped), and the pre-watermark hold queue force-freezes
  a host's offset at ``pending_cap`` so an unfrozen host cannot hold
  events hostage;
* **serves**: ``GET /metrics`` — per-host labelled samples + fleet
  rollups (``obs/exporter.py`` ``aggregate_fleet``; one ``# TYPE`` per
  family) + ``can_tpu_fleet_hosts_live`` / ``can_tpu_slo_burn_global
  {objective,window_s}`` — plus ``GET /fleet/status`` (JSON) and
  ``GET /healthz``.

Known limit (documented, not silent): a host that backfills OLD
timestamps after being marked stale feeds late relative to the offline
sort; the snapshot replay remains the ground truth for grading.

Snapshots: with ``snapshot_dir`` set, every ingested event is archived
verbatim to ``telemetry.host{k}.jsonl`` beside the collector's own bus
(``fleet.jsonl``) and an atomically-replaced ``collector.json`` manifest
(measured offsets, host states, counts) — a self-contained artifact that
``run_monitor`` / ``slo_report`` / ``trace_export`` all recognise via
``obs/join.py``.

Pure host-side code; the collector runs on any box that
can reach the hosts' files or be reached by their push sinks.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from can_tpu_torch.obs.bus import JsonlSink, Telemetry
from can_tpu_torch.obs.exporter import (
    _PROM_CONTENT_TYPE,
    GaugeSink,
    aggregate_fleet,
    render_prometheus,
)
from can_tpu_torch.obs.flightrec import FlightRecorder
from can_tpu_torch.obs.join import (
    COLLECTOR_MANIFEST,
    COLLECTOR_SCHEMA,
    DEFAULT_SNAP_S,
    HostTail,
    corrected_staleness,
    corrected_ts,
    discover_host_files,
    host_file_name,
    snap_offset,
)
from can_tpu_torch.obs.signals import write_signal
from can_tpu_torch.obs.slo import SloEngine, aggregate_grade, tail_evaluate

#: the collector's own bus host id — outside the real host-id space, so
#: fleet.jsonl events are never confused with host 0's.
COLLECTOR_HOST_ID = -1


class _HostState:
    """Everything the collector tracks per ingesting host."""

    def __init__(self, host_id: int, transport: str, now: float):
        self.host_id = int(host_id)
        self.transport = transport          # "tail" | "push" (first seen)
        self.first_seen = now
        self.seq = 0                        # ingest order within host
        self.pending: deque = deque()       # (seq, raw event) pre-release
        self.offset: Optional[float] = None  # frozen clock offset (s)
        self.samples: List[float] = []      # pre-freeze skew samples
        self.last_raw_ts: Optional[float] = None
        self.last_hb_raw_ts: Optional[float] = None
        self.stale = False
        self.staleness_s: Optional[float] = None
        self.events = 0
        self.torn = 0
        self.fed = 0
        self.gauge_errors = 0
        self.gauges = GaugeSink()           # per-host live gauges (raw ts)
        self.ring = FlightRecorder()        # bounded recent-event window
        self.tail: Optional[HostTail] = None
        self.tail_skipped_seen = 0
        self.archive = None                 # snapshot file handle

    def provisional_offset(self, snap_s: float) -> float:
        """The frozen offset, or the best current estimate (median of
        the samples so far) — what liveness uses before freeze."""
        if self.offset is not None:
            return self.offset
        if self.samples:
            return snap_offset(statistics.median(self.samples),
                               snap_s=snap_s)
        return 0.0


class FleetCollector:
    """The daemon.  Construct, then either ``start()`` (HTTP server +
    poll thread) or drive ``poll(now=...)`` manually (tests inject the
    clock).  ``drain()`` force-releases everything and tail-evaluates —
    after it, ``grade()`` is the final verdict the offline replay must
    match."""

    def __init__(self, spec=None, *, run_dir: str = "",
                 snapshot_dir: str = "", stale_after_s: float = 180.0,
                 snap_s: float = DEFAULT_SNAP_S, freeze_after: int = 3,
                 reorder_slack_s: float = 1.0, pending_cap: int = 4096,
                 signal_dir: str = "", incident_dir: str = "",
                 host: str = "127.0.0.1", port: int = 0,
                 poll_interval_s: float = 2.0, prefix: str = "can_tpu",
                 clock: Callable[[], float] = time.time):
        if run_dir and snapshot_dir and \
                os.path.abspath(run_dir) == os.path.abspath(snapshot_dir):
            raise ValueError(
                "snapshot_dir must differ from run_dir — archiving into "
                "the tailed directory would re-ingest the archive")
        self.spec = spec
        self.run_dir = run_dir
        self.snapshot_dir = snapshot_dir
        self.stale_after_s = float(stale_after_s)
        self.snap_s = float(snap_s)
        self.freeze_after = max(1, int(freeze_after))
        self.reorder_slack_s = float(reorder_slack_s)
        self.pending_cap = max(1, int(pending_cap))
        self.signal_dir = signal_dir
        self.host = host
        self.port = int(port)
        self.poll_interval_s = float(poll_interval_s)
        self.prefix = prefix
        self._clock = clock
        self._lock = threading.RLock()
        self._hosts: Dict[int, _HostState] = {}
        self._evals: List[Tuple[float, dict]] = []
        self._last_payload: Dict[str, dict] = {}
        self._fed = 0
        self._last_fed_ts: Optional[float] = None
        self._torn_unattributed = 0
        self._drained = False
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        if self.snapshot_dir:
            os.makedirs(self.snapshot_dir, exist_ok=True)
        # the collector's OWN bus: fleet.host / collector.ingest /
        # slo.burn land in fleet gauges, a bounded ring, fleet.jsonl
        # (named so a snapshot replay never mistakes it for host data),
        # and — via the watcher list — the incident manager
        self.fleet_gauges = GaugeSink(prefix)
        self.recorder = FlightRecorder()
        sinks: list = [self.fleet_gauges, self.recorder]
        if self.snapshot_dir:
            sinks.append(JsonlSink(os.path.join(self.snapshot_dir,
                                                "fleet.jsonl")))
        self.tel = Telemetry(sinks, host_id=COLLECTOR_HOST_ID, clock=clock)
        self.incidents = None
        if incident_dir:
            from can_tpu_torch.obs.incidents import IncidentManager

            self.incidents = IncidentManager(
                self.tel, self.recorder, incident_dir=incident_dir,
                gauges=self.fleet_gauges, host_id=COLLECTOR_HOST_ID,
                clock=clock)
            self.tel.watchers.append(self.incidents)
        # ONE global engine over the merged stream; its slo.burn
        # emissions ride the fleet bus (gauges, ring, incident trigger).
        # It is NOT a bus watcher — only released host events feed it.
        self.engine = SloEngine(spec, telemetry=self.tel) if spec else None

    # -- ingest -----------------------------------------------------------
    def _host_locked(self, host_id: int, transport: str,
                     now: float) -> _HostState:
        st = self._hosts.get(int(host_id))
        if st is None:
            st = _HostState(host_id, transport, now)
            if self.snapshot_dir:
                st.archive = open(os.path.join(
                    self.snapshot_dir, host_file_name(host_id)), "a")
            self._hosts[int(host_id)] = st
        return st

    def _ingest_locked(self, st: _HostState, events, now: float) -> int:
        n = 0
        for e in events:
            if not isinstance(e, dict):
                st.torn += 1
                continue
            n += 1
            st.events += 1
            st.seq += 1
            ts = e.get("ts")
            if isinstance(ts, (int, float)) and not isinstance(ts, bool):
                fts = float(ts)
                st.last_raw_ts = (fts if st.last_raw_ts is None
                                  else max(st.last_raw_ts, fts))
                if e.get("kind") == "heartbeat":
                    st.last_hb_raw_ts = (fts if st.last_hb_raw_ts is None
                                         else max(st.last_hb_raw_ts, fts))
                    if st.offset is None:
                        # the skew measurement: host clock vs ours, at
                        # the least-buffered event the host emits
                        st.samples.append(fts - now)
                        if len(st.samples) >= self.freeze_after:
                            st.offset = snap_offset(
                                statistics.median(st.samples),
                                snap_s=self.snap_s)
            try:
                st.gauges.emit(e)
            except Exception as ex:  # noqa: BLE001 — one malformed
                # payload must not kill ingest; the event still archives
                # and feeds the engine (which type-guards its samples)
                st.gauge_errors += 1
                if st.gauge_errors == 1:
                    print(f"[collector] host {st.host_id} gauge update "
                          f"failed: {type(ex).__name__}: {ex}", flush=True)
            st.ring.emit(e)
            if st.archive is not None:
                st.archive.write(json.dumps(e) + "\n")
            st.pending.append((st.seq, e))
            if len(st.pending) >= self.pending_cap and st.offset is None:
                # bounded hold: a host that never heartbeats cannot keep
                # the fleet's merge (or our memory) hostage
                st.offset = st.provisional_offset(self.snap_s)
        return n

    def ingest_events(self, host_id: int, events, *,
                      transport: str = "push", torn: int = 0,
                      now: Optional[float] = None) -> int:
        """Ingest one batch for one host (the push handler and the tail
        poll both land here).  Returns the number of events accepted."""
        now = self._clock() if now is None else now
        with self._lock:
            st = self._host_locked(host_id, transport, now)
            st.torn += int(torn)
            n = self._ingest_locked(st, events, now)
        if n or torn:
            self.tel.emit("collector.ingest", host=int(host_id), events=n,
                          torn=int(torn), transport=transport)
        return n

    def ingest_push(self, body: bytes) -> dict:
        """``POST /ingest`` body: batched JSONL (one bus event per
        line), grouped by each event's own ``host_id``.  Undecodable
        lines are counted torn — unattributed when the line never parsed
        far enough to name a host.  The push CLIENT ships whole lines
        (``CollectorPushSink``); in-progress-line buffering is the tail
        transport's job (``HostTail``)."""
        text = body.decode("utf-8", errors="replace")
        by_host: Dict[int, list] = {}
        torn = 0
        for line in text.split("\n"):
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                torn += 1
                continue
            if not isinstance(e, dict):
                torn += 1
                continue
            try:
                hid = int(e.get("host_id", 0))
            except (TypeError, ValueError):
                torn += 1
                continue
            by_host.setdefault(hid, []).append(e)
        accepted = 0
        for hid in sorted(by_host):
            accepted += self.ingest_events(hid, by_host[hid],
                                           transport="push")
        if torn:
            with self._lock:
                self._torn_unattributed += torn
        return {"accepted": accepted, "torn": torn,
                "hosts": sorted(by_host)}

    # -- the poll loop ----------------------------------------------------
    def poll(self, now: Optional[float] = None) -> None:
        """One collector iteration: advance the tails, judge liveness,
        release the watermark batch into the global engine, refresh the
        snapshot manifest.  Tests drive this directly with an injected
        ``now``; ``start()``'s thread loops it."""
        now = self._clock() if now is None else now
        ingests: List[Tuple[int, int, int]] = []
        with self._lock:
            if self.run_dir:
                for hid, path in discover_host_files(self.run_dir).items():
                    st = self._host_locked(hid, "tail", now)
                    if st.tail is None or st.tail.path != path:
                        st.tail = HostTail(path)
                        st.tail_skipped_seen = 0
                    st.tail.poll()
                    new = st.tail.drain()
                    delta = st.tail.skipped - st.tail_skipped_seen
                    if delta < 0:  # rotation reset the tail's counter
                        delta = st.tail.skipped
                    st.tail_skipped_seen = st.tail.skipped
                    if new or delta:
                        self._ingest_locked(st, new, now)
                        st.torn += delta
                        ingests.append((hid, len(new), delta))
            transitions = self._liveness_locked(now)
            batch = self._release_locked()
        for hid, n, delta in ingests:
            self.tel.emit("collector.ingest", host=hid, events=n,
                          torn=delta, transport="tail")
        for t in transitions:
            self.tel.emit("fleet.host", **t)
            if t["state"] == "stale" and self.signal_dir:
                # the exact grammar run_monitor --emit-signal writes, so
                # the elastic supervisor's reaction needs no new wiring
                path = write_signal(
                    self.signal_dir, kind="dead", host_id=t["host"],
                    reason="heartbeat_stale",
                    detail={"staleness_s": t["staleness_s"],
                            "source": "collector"}, ts=now)
                print(f"[collector] dead-host signal -> {path}",
                      flush=True)
        with self._lock:
            self._feed_locked(batch)
        self._write_manifest(now)

    def _liveness_locked(self, now: float) -> List[dict]:
        """Edge-triggered host state transitions on the skew-corrected
        clock.  A host with NO timestamped data yet ages from its first
        contact — silence is never health."""
        out = []
        for hid in sorted(self._hosts):
            st = self._hosts[hid]
            ref = (st.last_hb_raw_ts if st.last_hb_raw_ts is not None
                   else st.last_raw_ts)
            if ref is None:
                staleness = now - st.first_seen
            else:
                staleness = corrected_staleness(
                    ref, st.provisional_offset(self.snap_s), now)
            st.staleness_s = staleness
            stale = staleness > self.stale_after_s
            if stale != st.stale:
                st.stale = stale
                out.append({"host": hid,
                            "state": "stale" if stale else "live",
                            "staleness_s": round(staleness, 3),
                            "transport": st.transport})
        if out:
            live = sum(1 for s in self._hosts.values() if not s.stale)
            for t in out:
                t["live"] = live
                t["stale"] = len(self._hosts) - live
        return out

    def _release_locked(self, drain: bool = False) -> List[tuple]:
        """The watermark merge.  Watermark = min over live frozen hosts
        of (newest corrected ts − reorder slack): nothing releases until
        every host still counted on has reported past it, so the release
        order — sorted ``(corrected_ts, host, seq)`` — reproduces the
        offline stable-sort exactly.  Stale hosts drop out of the
        minimum (their silence must not dam the fleet); an unfrozen host
        with pending events blocks until it freezes (bounded by
        ``pending_cap``)."""
        marks = []
        for st in self._hosts.values():
            if st.stale:
                continue
            if st.offset is None:
                if st.pending and not drain:
                    return []
                continue
            if st.last_raw_ts is not None:
                marks.append(corrected_ts(st.last_raw_ts, st.offset))
        if drain:
            wm = float("inf")
        elif not marks:
            return []
        else:
            wm = min(marks) - self.reorder_slack_s
        batch = []
        for hid, st in self._hosts.items():
            if drain and st.offset is None:
                st.offset = st.provisional_offset(self.snap_s)
            off = st.offset if st.offset is not None else 0.0
            while st.pending:
                seq, e = st.pending[0]
                ts = e.get("ts")
                if not isinstance(ts, (int, float)) \
                        or isinstance(ts, bool):
                    # archived + gauged already; the engine feed skips
                    # non-timestamped events exactly like the replay
                    st.pending.popleft()
                    continue
                cts = corrected_ts(float(ts), off)
                if cts > wm:
                    break
                st.pending.popleft()
                batch.append((cts, hid, seq, e))
        batch.sort(key=lambda t: (t[0], t[1], t[2]))
        return batch

    def _feed_locked(self, batch: List[tuple]) -> None:
        for cts, hid, seq, e in batch:
            # zero-offset events pass through UNTOUCHED (int ts stays
            # int), matching join.apply_offsets — the replay side
            ev = e if e.get("ts") == cts else dict(e, ts=cts)
            self._fed += 1
            self._last_fed_ts = cts
            self._hosts[hid].fed += 1
            if self.engine is None:
                continue
            out = self.engine.on_event(ev)
            if out:
                for p in out:
                    self._evals.append((cts, p))
                    self._last_payload[str(p.get("objective"))] = p

    def drain(self, now: Optional[float] = None) -> None:
        """Terminal flush: freeze every offset, release ALL pending in
        global sorted order, then tail-evaluate at the last fed ts —
        mirroring ``slo.replay_evals`` exactly, so ``grade()`` after a
        drain is what the offline replay of the snapshot computes."""
        now = self._clock() if now is None else now
        with self._lock:
            batch = self._release_locked(drain=True)
            self._feed_locked(batch)
            last_ts = self._last_fed_ts
            self._drained = True
        if self.engine is not None and last_ts is not None:
            payloads = tail_evaluate(self.engine, last_ts)
            with self._lock:
                for p in payloads:
                    self._evals.append((last_ts, p))
                    self._last_payload[str(p.get("objective"))] = p
        self._write_manifest(now)

    # -- verdicts ---------------------------------------------------------
    def evals(self) -> List[Tuple[float, dict]]:
        """Every ``(eval_ts, slo.burn payload)`` so far, in feed order —
        the sequence the bit-identity oracle compares."""
        with self._lock:
            return list(self._evals)

    def grade(self) -> Optional[dict]:
        """The live verdict, through the SAME ``aggregate_grade`` the
        offline ``slo_report`` uses.  Call after ``drain()`` for a final
        grade; mid-run it grades what has been released so far."""
        if self.engine is None:
            return None
        with self._lock:
            evals = list(self._evals)
            fed = self._fed
        return aggregate_grade(self.spec, evals,
                               self.engine.run_totals(), n_events=fed)

    # -- snapshot ---------------------------------------------------------
    def _host_row_locked(self, st: _HostState) -> dict:
        return {
            "clock_offset_s": st.provisional_offset(self.snap_s),
            "offset_frozen": st.offset is not None,
            "skew_samples": len(st.samples),
            "state": "stale" if st.stale else "live",
            "staleness_s": (round(st.staleness_s, 3)
                            if st.staleness_s is not None else None),
            "transport": st.transport,
            "events": st.events,
            "torn": st.torn,
            "fed": st.fed,
            "pending": len(st.pending),
            "last_ts": st.last_raw_ts,
            "last_heartbeat_ts": st.last_hb_raw_ts,
        }

    def _write_manifest(self, now: Optional[float] = None) -> Optional[str]:
        """Atomic ``collector.json`` refresh (tmp + rename — the
        manifest-written-last contract: a reader that sees it sees a
        consistent snapshot; the archives were flushed first)."""
        if not self.snapshot_dir:
            return None
        with self._lock:
            for st in self._hosts.values():
                if st.archive is not None:
                    st.archive.flush()
            doc = {
                "schema": COLLECTOR_SCHEMA,
                "ts": self._clock() if now is None else now,
                "stale_after_s": self.stale_after_s,
                "snap_s": self.snap_s,
                "reorder_slack_s": self.reorder_slack_s,
                "drained": self._drained,
                "objectives": ([o.name for o in self.spec.objectives]
                               if self.spec else []),
                "hosts": {str(hid): self._host_row_locked(st)
                          for hid, st in sorted(self._hosts.items())},
                "counts": {
                    "events": sum(s.events for s in self._hosts.values()),
                    "torn": sum(s.torn for s in self._hosts.values()),
                    "torn_unattributed": self._torn_unattributed,
                    "fed": self._fed,
                    "evaluations": len(self._evals),
                },
            }
        path = os.path.join(self.snapshot_dir, COLLECTOR_MANIFEST)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    # -- reads ------------------------------------------------------------
    def status(self) -> dict:
        """The ``/fleet/status`` document."""
        with self._lock:
            live = sum(1 for s in self._hosts.values() if not s.stale)
            return {
                "hosts": {str(hid): self._host_row_locked(st)
                          for hid, st in sorted(self._hosts.items())},
                "hosts_live": live,
                "hosts_stale": len(self._hosts) - live,
                "events": sum(s.events for s in self._hosts.values()),
                "torn": (sum(s.torn for s in self._hosts.values())
                         + self._torn_unattributed),
                "fed": self._fed,
                "evaluations": len(self._evals),
                "drained": self._drained,
                "slo": {name: {"alerting": p.get("alerting"),
                               "burn_max": p.get("burn_max"),
                               "windows": p.get("windows")}
                        for name, p in sorted(self._last_payload.items())},
            }

    def render_metrics(self) -> str:
        """The federated exposition: per-host labelled samples + fleet
        rollups (one ``# TYPE`` per family), collector vitals, and the
        GLOBAL burn — ``can_tpu_slo_burn_global{objective,window_s}``
        from the one engine that saw the merged stream (a per-host fold
        cannot compute a cross-host quantile; this can)."""
        pre = self.prefix
        with self._lock:
            snaps = {hid: st.gauges.snapshot()
                     for hid, st in self._hosts.items()}
            g, c, lg = aggregate_fleet(snaps)
            live = sum(1 for s in self._hosts.values() if not s.stale)
            g[f"{pre}_fleet_hosts_live"] = float(live)
            g[f"{pre}_fleet_hosts_stale"] = float(len(self._hosts) - live)
            g[f"{pre}_collector_pending_events"] = float(
                sum(len(s.pending) for s in self._hosts.values()))
            c[(f"{pre}_collector_fed_events_total", ())] = float(self._fed)
            if self._torn_unattributed:
                c[(f"{pre}_collector_torn_unattributed_total", ())] = \
                    float(self._torn_unattributed)
            for hid, st in sorted(self._hosts.items()):
                hl = (("host", str(hid)),)
                lg[(f"{pre}_host_clock_skew_s", hl)] = \
                    float(st.provisional_offset(self.snap_s))
                if st.staleness_s is not None:
                    lg[(f"{pre}_host_staleness_s", hl)] = \
                        round(float(st.staleness_s), 3)
                lg[(f"{pre}_host_stale", hl)] = 1.0 if st.stale else 0.0
                c[(f"{pre}_collector_events_total", hl)] = float(st.events)
                if st.torn:
                    c[(f"{pre}_collector_torn_total", hl)] = \
                        float(st.torn)
            for name, p in sorted(self._last_payload.items()):
                ol = ("objective", name)
                for w, info in (p.get("windows") or {}).items():
                    if isinstance(info, dict) \
                            and info.get("burn") is not None:
                        lg[(f"{pre}_slo_burn_global",
                            (ol, ("window_s", str(w))))] = \
                            float(info["burn"])
                lg[(f"{pre}_slo_alerting_global", (ol,))] = \
                    1.0 if p.get("alerting") else 0.0
        return render_prometheus(g, c, lg)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "FleetCollector":
        """HTTP endpoints + the poll loop, both daemon threads."""
        self._start_server()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="can-tpu-fleet-collector")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 — the plane must
                # outlive one bad poll; the failure itself is the news
                print(f"[collector] poll failed: {type(e).__name__}: {e}",
                      flush=True)

    def _start_server(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        col = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # scrapes are not news
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import urlparse

                path = urlparse(self.path).path
                if path == "/metrics":
                    self._send(200, col.render_metrics().encode(),
                               _PROM_CONTENT_TYPE)
                elif path == "/fleet/status":
                    self._send(200, json.dumps(col.status()).encode(),
                               "application/json")
                elif path == "/healthz":
                    s = col.status()
                    body = json.dumps({"ok": True,
                                       "hosts_live": s["hosts_live"],
                                       "hosts_stale": s["hosts_stale"]})
                    self._send(200, body.encode(), "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": f"no such path: {path}"}).encode(),
                        "application/json")

            def do_POST(self):
                from urllib.parse import urlparse

                if urlparse(self.path).path != "/ingest":
                    self._send(404, json.dumps(
                        {"error": "POST /ingest only"}).encode(),
                        "application/json")
                    return
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    res = col.ingest_push(self.rfile.read(n))
                except Exception as e:  # noqa: BLE001 — a bad request
                    # must answer 400, not kill the handler thread
                    self._send(400, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
                    return
                self._send(200, json.dumps(res).encode(),
                           "application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port=0
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="can-tpu-collector-http")
        self._http_thread.start()

    def close(self, *, drain: bool = True) -> None:
        """Stop the loop, take a final poll, drain (final grade +
        manifest), shut the server, close the archives and the bus."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        try:
            self.poll()
        except Exception as e:  # noqa: BLE001 — teardown still proceeds
            print(f"[collector] final poll failed: {type(e).__name__}: "
                  f"{e}", flush=True)
        if drain:
            self.drain()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None
        with self._lock:
            for st in self._hosts.values():
                if st.archive is not None:
                    st.archive.close()
                    st.archive = None
        self.tel.close()


class CollectorPushSink:
    """Bus sink that ships events to a :class:`FleetCollector`'s
    ``/ingest`` over HTTP — the no-shared-filesystem transport.  An
    ordinary sink (``obs.Telemetry([..., CollectorPushSink(url)])`` or
    the CLIs' ``--collector-push``): ``emit()`` serialises under a lock
    into a bounded queue (drop-OLDEST with a counter when full — recent
    telemetry outranks old); a daemon flusher batches JSONL ``POST``\\ s
    via stdlib urllib.  Failures drop the batch with a counter and warn
    once per failure streak (the bus's sink discipline) — the emitting
    run must never block or die on the collector's availability.
    ``close()`` stops the flusher after a final flush attempt."""

    def __init__(self, url: str, *, capacity: int = 4096,
                 flush_interval_s: float = 0.5, batch_max: int = 500,
                 timeout_s: float = 5.0):
        if "://" not in url:
            url = "http://" + url
        self.url = url.rstrip("/")
        self.capacity = max(1, int(capacity))
        self.flush_interval_s = float(flush_interval_s)
        self.batch_max = max(1, int(batch_max))
        self.timeout_s = float(timeout_s)
        self.dropped = 0
        self.pushed_events = 0
        self.push_failures = 0
        self._warned = False
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="can-tpu-collector-push")
        self._thread.start()

    # -- bus sink protocol ------------------------------------------------
    def emit(self, event: dict) -> None:
        try:
            line = json.dumps(event)
        except (TypeError, ValueError):
            self.dropped += 1  # unserialisable event: counted, not fatal
            return
        with self._lock:
            if len(self._q) >= self.capacity:
                self._q.popleft()
                self.dropped += 1
            self._q.append(line)
        self._wake.set()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=2 * self.timeout_s + 5.0)

    # -- the flusher ------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            self._flush()
        self._flush()  # final flush after stop — close()'s last chance

    def _flush(self) -> None:
        while True:
            with self._lock:
                if not self._q:
                    return
                batch = [self._q.popleft()
                         for _ in range(min(len(self._q), self.batch_max))]
            data = ("\n".join(batch) + "\n").encode()
            req = urllib.request.Request(
                self.url + "/ingest", data=data,
                headers={"Content-Type": "application/x-ndjson"},
                method="POST")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout_s) as r:
                    r.read()
            except OSError as e:  # URLError subclasses OSError
                self.push_failures += 1
                self.dropped += len(batch)
                if not self._warned:
                    self._warned = True
                    print(f"[collector-push] POST {self.url}/ingest "
                          f"failed ({e}); dropping batches until it "
                          f"recovers", flush=True)
                return
            self.pushed_events += len(batch)
            self._warned = False
