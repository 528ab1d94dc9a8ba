"""IncidentManager: trigger -> one self-contained incident bundle.

Counterpart of ``can_tpu/obs/incidents.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The bus records everything and the health layer alerts live, but when a
process actually dies — NaN abort, quarantined replica, preemption
SIGTERM, an exception unwinding through the loop — the context an
operator needs is scattered: the last seconds of telemetry are in a
multi-GB JSONL (or an unflushed buffer), the gauge values are gone with
the exporter, and the Python stacks are gone with the process.  An
incident bundle is one directory holding all of it, written AT the
moment of the trigger:

    incident-<ms>-h<host>-<reason>/
        ring.jsonl      last-N-events flight-recorder dump (bus schema —
                        readable by run_monitor / trace_export /
                        telemetry_report unchanged)
        gauges.json     GaugeSink snapshot (incl. can_tpu_slo_* burns)
        costs.json      ProgramCostLedger rows (per-program MFU/roofline)
        stacks.txt      every Python thread's stack
        memory.json     device-memory + host-RSS snapshot
        incident.json   manifest — schema, reason, severity, run config,
                        exception traceback, ring accounting, extra info
                        sources.  Written LAST, so a bundle torn by
                        SIGKILL mid-write reads as absent, never as
                        trusted-but-partial (the prepared-store rule).

Triggers (wired as a ``Telemetry.watchers`` entry — watchers run after
sink fan-out and OUTSIDE the bus lock, so a trigger may itself emit):

* ``health.alert`` with ``alert`` in nan / stall_budget — the run-health
  layer's "this run is dying / starving" verdicts (obs/health.py; the
  nan alert is emitted BEFORE ``NonFiniteLossError`` unwinds, so the
  bundle exists when the process exits).
* ``fleet.replica`` quarantine — a serving replica just failed out of
  dispatch (serve/fleet.py).
* ``slo.burn`` with ``alerting`` — a fast SLO burn (obs/slo.py).
* :meth:`on_exception` — an unhandled loop exception, called by
  ``train/loop.py`` before the stack unwinds.
* :meth:`on_signal` — SIGTERM/preemption, via
  :func:`install_sigterm_handler`: dump + flush, then chain to the
  previous handler (or raise ``SystemExit`` so the CLI ``finally``
  teardown runs — obs/lifecycle.py).

Bounded by construction: per-reason rate limiting (a NaN alert storm or
a flapping replica writes ONE bundle per cooldown, with suppressed
repeats counted into the next manifest) and directory retention (oldest
bundles beyond ``max_bundles`` are deleted before each write).  A bundle
write failure warns and returns None — incident capture must never kill
the run it is documenting.

This module imports no torch at import time (the memory snapshot's
import is lazy) — bundle reading tools stay runnable anywhere.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

BUNDLE_SCHEMA = "can_tpu.incident.v1"
MANIFEST_NAME = "incident.json"
RING_NAME = "ring.jsonl"

#: health.alert payload ``alert`` values that dump a bundle (spikes and
#: plateaus are advisories; nan and stall_budget are the run dying)
TRIGGER_ALERTS = ("nan", "stall_budget")

_SLUG_RE = re.compile(r"[^a-z0-9]+")


def _slug(reason: str) -> str:
    return _SLUG_RE.sub("-", str(reason).lower()).strip("-") or "unknown"


def all_thread_stacks() -> str:
    """Every Python thread's current stack, named — what a post-mortem
    debugger would ask for first on a hang or a deadlocked teardown."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for ident, frame in sorted(sys._current_frames().items()):
        lines.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        lines.extend(line.rstrip("\n")
                     for line in traceback.format_stack(frame))
    return "\n".join(lines) + "\n"


def read_manifest(bundle_dir: str) -> Optional[dict]:
    """The bundle's manifest, or None when absent/torn (a dump killed
    before its final write is NOT a bundle — manifest-last contract)."""
    path = os.path.join(bundle_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def is_bundle_dir(path: str) -> bool:
    """A directory with a manifest IS a bundle (torn dumps have none)."""
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def bundle_ring_path(bundle_dir: str) -> str:
    """The bundle's ring dump path — the single resolver every reading
    tool shares (slo_report, trace_export), so a bundle-layout change
    cannot diverge them.  Raises ``ValueError`` when the bundle carries
    no ring (dumped without a flight recorder)."""
    ring = os.path.join(bundle_dir, RING_NAME)
    if not os.path.isfile(ring):
        raise ValueError(f"incident bundle {bundle_dir} has no "
                         f"{RING_NAME} (dumped without a flight "
                         f"recorder?)")
    return ring


class IncidentManager:
    """Owns the incident directory; dumps a bundle per trigger.

    telemetry: the bus (the manager emits ``incident.bundle`` events and
      reads the run-local step + the armed ledger off it).
    recorder: a :class:`~can_tpu_torch.obs.flightrec.FlightRecorder` sharing
      the same bus (its snapshot IS the bundle's ring.jsonl); None skips
      the ring section.
    gauges: a ``GaugeSink`` to snapshot (None skips).
    run_config: the CLI's schedule-bearing flag dict, recorded verbatim.
    rate_limit_s / max_bundles: the storm bounds described above.
    """

    def __init__(self, telemetry, recorder=None, *, incident_dir: str,
                 gauges=None, run_config: Optional[dict] = None,
                 rate_limit_s: float = 60.0, max_bundles: int = 16,
                 host_id: int = 0, clock: Callable[[], float] = time.time):
        if not incident_dir:
            raise ValueError("incident_dir is required")
        os.makedirs(incident_dir, exist_ok=True)
        self._tel = telemetry
        self.recorder = recorder
        self.gauges = gauges
        self.run_config = run_config
        self.incident_dir = incident_dir
        self.rate_limit_s = float(rate_limit_s)
        self.max_bundles = max(1, int(max_bundles))
        self.host_id = int(host_id)
        self._clock = clock
        # RLock: a signal landing while THIS thread is mid-trigger must
        # be able to re-enter (signals run on the main thread); the
        # per-reason rate limiter still bounds the work
        self._lock = threading.RLock()
        self._last: Dict[str, float] = {}       # reason -> last dump ts
        self._suppressed: Dict[str, int] = {}   # reason -> rate-limited count
        self._info_sources: Dict[str, Callable[[], dict]] = {}
        self._restore_signals: Optional[Callable[[], None]] = None
        self.bundles_written = 0

    # -- collaborators ----------------------------------------------------
    def add_info_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Fold ``fn()`` into every future bundle's manifest under
        ``info[name]`` (e.g. the serve CLI registers
        ``CountService.stats`` so a bundle carries live queue depth and
        per-replica health).  Failures are recorded, not raised."""
        self._info_sources[name] = fn

    # -- trigger entry points --------------------------------------------
    def on_event(self, event: dict) -> None:
        """``Telemetry.watchers`` hook: runs after sink fan-out, outside
        the bus lock (so the triggering event is already in the ring,
        and the bundle's own ``incident.bundle`` emission cannot
        deadlock).  ``incident.*`` kinds are ignored by construction —
        a bundle must not trigger a bundle."""
        kind = event.get("kind", "")
        if kind.startswith("incident."):
            return
        p = event.get("payload", {})
        if kind == "health.alert" and p.get("alert") in TRIGGER_ALERTS:
            self.trigger(f"health_{p.get('alert')}", detail=p)
        elif kind == "fleet.replica" and p.get("state") == "quarantined":
            self.trigger("fleet_quarantine", detail=p)
        elif kind == "fleet.host" and p.get("state") == "stale":
            # a silent HOST (obs/collector.py liveness rule): the moment
            # "no data ≠ healthy" fires is exactly when its recent
            # telemetry is worth freezing
            self.trigger("fleet_host_stale", detail=p)
        elif kind == "slo.burn" and p.get("alerting"):
            self.trigger(f"slo_{p.get('objective', '?')}", detail=p,
                         severity="warning")

    def on_exception(self, exc: BaseException, **context) -> Optional[str]:
        """An unhandled loop exception (``train/loop.py`` calls this
        before re-raising): the bundle records the traceback while the
        frames are still live."""
        return self.trigger("exception", exc=exc, detail=context or None)

    def on_signal(self, signum: int) -> Optional[str]:
        """The preemption path: dump + flush before the process dies."""
        try:
            name = signal.Signals(signum).name.lower()
        except ValueError:
            name = str(signum)
        return self.trigger(f"signal_{name}", severity="preemption",
                            detail={"signum": int(signum)})

    def close(self) -> None:
        """Teardown: restore any installed signal handlers.  No bundle —
        a clean exit is not an incident."""
        if self._restore_signals is not None:
            self._restore_signals()
            self._restore_signals = None

    # -- the dump ---------------------------------------------------------
    def trigger(self, reason: str, *, detail: Optional[dict] = None,
                exc: Optional[BaseException] = None,
                severity: str = "error") -> Optional[str]:
        """Rate-limited bundle dump; returns the bundle path, or None
        when suppressed (cooldown) or the write failed."""
        now = self._clock()
        with self._lock:
            last = self._last.get(reason)
            if last is not None and now - last < self.rate_limit_s:
                self._suppressed[reason] = \
                    self._suppressed.get(reason, 0) + 1
                return None
            try:
                path, manifest = self._dump(reason, now, detail=detail,
                                            exc=exc, severity=severity)
            except Exception as e:  # noqa: BLE001 — capture must never
                # kill the run it documents; the failure itself is news.
                # The cooldown is NOT consumed: a transient I/O failure
                # must not suppress the next trigger's retry, or a
                # recoverable hiccup loses the incident entirely
                print(f"[incident] bundle write FAILED for {reason!r}: "
                      f"{type(e).__name__}: {e}", flush=True)
                return None
            self._last[reason] = now  # only a WRITTEN bundle cools down
            self.bundles_written += 1
            suppressed = dict(sorted(self._suppressed.items()))
        # outside the manager lock: the emit fans out to sinks AND back
        # through the watcher list (where on_event ignores incident.*)
        self._tel.emit("incident.bundle", reason=reason, severity=severity,
                       path=path, ring_events=manifest.get("ring_events", 0),
                       suppressed=suppressed)
        return path

    def _existing_bundles(self):
        out = []
        try:
            for name in os.listdir(self.incident_dir):
                if name.startswith("incident-"):
                    full = os.path.join(self.incident_dir, name)
                    if os.path.isdir(full):
                        out.append(full)
        except OSError:
            return []
        return sorted(out)

    def _dump(self, reason, now, *, detail, exc, severity):
        # retention FIRST: the directory never exceeds max_bundles even
        # transiently (bundle names sort by their ms timestamp, so the
        # oldest are the lexicographic head)
        existing = self._existing_bundles()
        for stale in existing[: max(0, len(existing) - self.max_bundles + 1)]:
            shutil.rmtree(stale, ignore_errors=True)
        base = (f"incident-{int(now * 1000):013d}-h{self.host_id}"
                f"-{_slug(reason)}")
        path = os.path.join(self.incident_dir, base)
        n = 1
        while os.path.exists(path):  # same-ms retrigger (fake clocks)
            n += 1
            path = os.path.join(self.incident_dir, f"{base}.{n}")
        os.makedirs(path)
        files = []
        errors = {}

        def section(name, fn):
            try:
                fn()
                files.append(name)
            except Exception as e:  # noqa: BLE001 — one failing section
                # (a half-dead gauge source) must not lose the others;
                # the manifest records what is missing and why
                errors[name] = f"{type(e).__name__}: {e}"

        ring_events = 0
        if self.recorder is not None:
            def _ring():
                nonlocal ring_events
                ring_events = self.recorder.dump(
                    os.path.join(path, RING_NAME), now=now)
            section(RING_NAME, _ring)
        if self.gauges is not None:
            section("gauges.json", lambda: self._write_json(
                path, "gauges.json", self.gauges.snapshot()))
        ledger = getattr(self._tel, "ledger", None)
        if ledger is not None:
            section("costs.json", lambda: self._write_json(
                path, "costs.json", {"programs": ledger.rows(),
                                     "summary": ledger.summary()}))
        section("stacks.txt", lambda: self._write_text(
            path, "stacks.txt", all_thread_stacks()))
        section("memory.json", lambda: self._write_memory(path))
        info = {}
        for name, fn in sorted(self._info_sources.items()):
            try:
                info[name] = fn()
            except Exception as e:  # noqa: BLE001 — a dead stats source
                # is itself incident context, recorded in place
                info[name] = {"error": f"{type(e).__name__}: {e}"}
        manifest = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "severity": severity,
            "ts": now,
            "time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime(now)),
            "host_id": self.host_id,
            "pid": os.getpid(),
            "step": getattr(self._tel, "step", None),
            "run_config": self.run_config,
            "detail": detail,
            "exception": (None if exc is None else {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
            }),
            "ring_events": ring_events,
            "ring_stats": (self.recorder.stats()
                           if self.recorder is not None else None),
            "suppressed": dict(sorted(self._suppressed.items())),
            "info": info,
            "files": sorted(files),
            "section_errors": errors,
        }
        # manifest LAST: its presence is the bundle's validity bit
        self._write_json(path, MANIFEST_NAME, manifest)
        return path, manifest

    @staticmethod
    def _write_json(bundle: str, name: str, doc) -> None:
        with open(os.path.join(bundle, name), "w") as f:
            json.dump(doc, f, indent=1, default=str)

    @staticmethod
    def _write_text(bundle: str, name: str, text: str) -> None:
        with open(os.path.join(bundle, name), "w") as f:
            f.write(text)

    @staticmethod
    def _write_memory(bundle: str) -> None:
        from can_tpu_torch.obs.sources import device_memory_snapshot

        IncidentManager._write_json(bundle, "memory.json",
                                    device_memory_snapshot())


def install_sigterm_handler(manager: IncidentManager,
                            signums=(signal.SIGTERM,)):
    """Arm the preemption hook: on each signal, dump a bundle (the JSONL
    sinks flush per event, so the ``incident.bundle`` record is on disk
    too), then chain to the previously installed handler — or, when the
    previous disposition was the default, raise ``SystemExit(128+n)`` so
    the CLI's ``finally`` teardown (``obs/lifecycle.py``) runs the same
    deterministic close order as a clean exit.

    Returns a ``restore()`` callable (also stored on the manager, so
    ``manager.close()`` restores), or None when not on the main thread
    (``signal.signal`` is main-thread-only; a library consumer embedding
    this off-main simply gets no signal hook, never a crash)."""
    previous: dict = {}
    installed: list = []

    def _handler(signum, frame):
        manager.on_signal(signum)
        prev = previous.get(signum)
        if callable(prev):
            prev(signum, frame)
        else:
            raise SystemExit(128 + signum)

    try:
        for s in signums:
            previous[s] = signal.signal(s, _handler)
            installed.append(s)
    except ValueError:  # not the main thread: roll back what we set
        for s in installed:
            try:
                signal.signal(s, previous[s]
                              if previous[s] is not None else signal.SIG_DFL)
            # can-tpu-lint: disable=SWALLOW(rollback is best-effort off the main thread; install already failed)
            except (ValueError, TypeError):
                pass
        return None

    def restore() -> None:
        for s in installed:
            try:
                signal.signal(s, previous[s]
                              if previous[s] is not None else signal.SIG_DFL)
            # can-tpu-lint: disable=SWALLOW(teardown restore is best-effort; process is exiting anyway)
            except (ValueError, TypeError):
                pass

    manager._restore_signals = restore
    return restore
