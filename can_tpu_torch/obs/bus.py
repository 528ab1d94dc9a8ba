"""Telemetry event bus: one process-local stream, pluggable sinks.

Counterpart of ``can_tpu/obs/bus.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The reference repo's observability is tqdm bars and optional wandb scalars
(SURVEY §5: "Tracing/profiling: ABSENT"); until this subsystem can_tpu
mirrored that.  A production pod needs a machine-readable record of where
each step's time and memory went — recompiles, input stalls, memory pressure —
that survives the process and is diffable across runs and hosts.

Schema: one JSON object per line, identical across train / eval / bench so
artifacts are directly comparable::

    {"ts": <unix seconds>, "kind": <str>, "step": <int|null>,
     "host_id": <int>, "payload": {...}}

Kinds emitted by the library: ``compile`` (new (shape, dtype) signature hit
a jitted step, with elapsed first-call time), ``step_window`` (a windowed
batch of per-step wall times), ``stall`` (seconds the consumer spent
blocked on the input pipeline), ``memory`` (device/host memory snapshot),
``heartbeat`` (liveness timestamp from a daemon thread), ``epoch``
(per-epoch scalars — the row wandb used to get directly), ``bench``
(benchmark result records), ``run`` (run-level config, emitted once).
Sinks must tolerate kinds they don't know: the set is open.

Multi-host: every host writes its OWN file (``telemetry.host{k}.jsonl``,
see ``open_host_telemetry``) — no cross-host collectives on the hot path;
merging is an offline join on ``ts``/``host_id``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

# the kinds the acceptance contract and tools/telemetry_report.py know;
# informational — emit() accepts any kind string.  serve.* kinds come from
# the online serving subsystem (can_tpu_torch/serve): per-request completions,
# per-flush micro-batches (carrying the queue-depth gauge), and typed
# rejections.  data.* kinds come from the host data pipeline
# (can_tpu_torch/data/prepared.py): per-split prepared-store status (active or
# the fallback reason) and per-epoch decoded-item-cache counters.
# health.* kinds come from the run-health layer (can_tpu_torch/obs/health.py):
# live anomaly alerts (spike / plateau / nan_precursor / nan /
# throughput_regression / stall_budget) and the per-epoch rollup.
# data.planner carries the batch planner's per-epoch decisions and
# schedule economics (padding/schedule overhead, program and lowered-
# launch counts, predicted-vs-realized plan cost — ShardedBatcher.
# planner_stats), exported as can_tpu_planner_* gauges by obs/exporter.py.
# perf.summary and trace.span come from the performance-attribution layer:
# perf.summary is the ProgramCostLedger's aggregate (per-program MFU /
# roofline class / empirical launch cost, obs/costs.py — numeric keys
# become can_tpu_mfu_* etc. gauges) and trace.span is one completed span
# of a request/step trace tree (obs/spans.py; exported to Chrome
# trace-event JSON by tools/trace_export.py).
# tests/test_perf.py pins this tuple against the emit literals in the
# tree — add the kind HERE when adding an emitter, or that test fails.
# fleet.* kinds come from the serving fleet (can_tpu_torch/serve/fleet.py):
# fleet.replica is a replica state transition (quarantine on failure,
# wedge on a watchdog deadline, drain on scale-down, generation bump on
# rollout flip) and fleet.rollout is one completed blue/green checkpoint
# rollout report.  The self-healing layer adds fleet.probe (one
# probation health probe, ok or failed with the escalated backoff),
# fleet.resurrect (a quarantined/wedged replica re-staged at the current
# generation and back in dispatch — can_tpu_fleet_resurrections_total),
# and fleet.scale (one add/remove replica transition, with
# time_to_first_ready_s on the up direction —
# can_tpu_fleet_scale_events_total).
# incident.bundle and slo.burn come from the incident layer:
# incident.bundle records one written incident bundle (obs/incidents.py
# — reason/severity/path/suppressed counts; GaugeSink counts them as
# can_tpu_incidents_total{reason}), and slo.burn is one objective's
# multi-window burn-rate evaluation (obs/slo.py — exported as
# can_tpu_slo_* gauges; `alerting` payloads trigger incident bundles).
# elastic.transition comes from the elastic supervisor
# (parallel/elastic.py): one completed shrink-and-continue transition —
# old/new world (processes, dp), interrupted epoch + step, consumed vs
# remaining items, and the lr/global-batch rescaling applied.
# stream.* kinds come from the per-stream session layer
# (serve/streams.py): stream.session is a session lifecycle mark (open /
# periodic snapshot / TTL evict, carrying the active-session gauge),
# stream.degrade is one degradation-ladder RUNG TRANSITION (full ->
# frame-skip -> reject; individual EWMA-served answers ride
# serve.request with degraded=true + staleness_s), and stream.repin is
# one sticky-pin invalidation after a fleet fault (quarantine / wedge /
# scale-down / resurrection at a new incarnation) with the live replica
# the stream re-pinned to.
# fleet.host and collector.ingest come from the fleet observability
# plane (obs/collector.py): fleet.host is a HOST-level liveness
# transition on the collector's skew-corrected clock (stale when
# heartbeats age past the bound — "no data ≠ healthy" — or back to live
# on recovery; carries the live/stale host counts and triggers an
# incident bundle), and collector.ingest is one accepted ingest batch
# for one host (tail or push transport, event + torn-line counts —
# can_tpu_collector_events_total{host}).
EVENT_KINDS = ("compile", "step_window", "stall", "memory", "heartbeat",
               "epoch", "bench", "run",
               "serve.request", "serve.batch", "serve.reject",
               "serve.warmup",
               "fleet.replica", "fleet.rollout",
               "fleet.probe", "fleet.resurrect", "fleet.scale",
               "fleet.host", "collector.ingest",
               "stream.session", "stream.degrade", "stream.repin",
               "data.prepared", "data.cache", "data.planner",
               "health.alert", "health.summary",
               "perf.summary", "trace.span",
               "incident.bundle", "slo.burn",
               "elastic.transition")


def _jsonable(v):
    """Coerce numpy scalars/arrays and torch tensors (a 0-d tensor becomes
    its ``.item()``) into JSON-serialisable python values."""
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    # no tensor can exist before torch is imported: the bus never imports it
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class JsonlSink:
    """Append events to a JSONL file, one line per event, flushed per event
    (an abandoned run's last heartbeat must be ON DISK, not in a buffer)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutSink:
    """Human-greppable one-liners; for quick local runs without a dir."""

    def __init__(self, prefix: str = "[telemetry]"):
        self.prefix = prefix

    def emit(self, event: dict) -> None:
        step = event.get("step")
        print(f"{self.prefix} {event['kind']}"
              f"{'' if step is None else f' step {step}'} "
              f"{json.dumps(event['payload'])}", flush=True)

    def close(self) -> None:
        pass


class MetricLoggerSink:
    """Forward scalar payload entries of selected kinds to a MetricLogger,
    so the existing stdout/wandb logging keeps working unchanged when the
    CLI routes its per-epoch metrics through the bus."""

    def __init__(self, logger, kinds=("epoch",)):
        self.logger = logger
        self.kinds = tuple(kinds)

    def emit(self, event: dict) -> None:
        if event["kind"] not in self.kinds:
            return
        scalars = {k: v for k, v in event["payload"].items()
                   if isinstance(v, (int, float, np.floating, np.integer))
                   and not isinstance(v, bool)}
        if scalars:
            self.logger.log(scalars, step=event.get("step"))

    def close(self) -> None:
        pass  # the CLI owns the logger's lifecycle (logger.finish())


class Telemetry:
    """The bus: builds schema'd events and fans them out to sinks.

    Thread-safe (the heartbeat thread emits concurrently with the train
    loop).  A sink that raises is dropped after one warning — telemetry
    must never kill a training run.  ``step_tick()`` maintains the
    process-global step counter (counts from 0 at construction; a resumed
    run restarts the count — ``step`` in events is a run-local ordinal,
    not the optimizer step) and drives the optional trace window.
    """

    def __init__(self, sinks=(), *, host_id: int = 0, trace=None,
                 clock=time.time):
        self._sinks = list(sinks)
        self.host_id = host_id
        self.trace = trace
        self._clock = clock
        # RLock, not Lock: the SIGTERM/preemption hook (obs/incidents.py)
        # runs ON the main thread at a bytecode boundary — if the signal
        # lands while that thread is inside this very lock (the sink
        # fan-out below), the handler's own bundle emit must be able to
        # re-enter or the process deadlocks in the exact window the
        # incident layer exists to survive.  Each sink.emit writes whole
        # events (one write call per line), so a re-entrant fan-out
        # interleaves complete events, never torn ones.
        self._lock = threading.RLock()
        self._step = 0
        # RecompileTracker keeps per-wrapped-step-name signature sets here
        # so re-wrapping each epoch doesn't re-attribute old signatures
        self.signature_registry: dict = {}
        # performance-attribution collaborators (armed by the CLIs when a
        # consumer exists; None keeps every producer's guard dead cheap):
        # ledger = obs.costs.ProgramCostLedger, spans = obs.spans.SpanTracer
        self.ledger = None
        self.spans = None
        # watchers: called with every event AFTER sink fan-out and
        # OUTSIDE the bus lock, so a watcher may itself emit (the
        # incident manager dumps a bundle + emits incident.bundle; the
        # SLO engine emits slo.burn) without deadlocking.  Armed by the
        # CLIs (obs/incidents.py, obs/slo.py); the default empty list
        # costs one truth test per event.  ``incidents`` is the armed
        # IncidentManager (or None) — the handle the loops use to
        # snapshot an unhandled exception before the stack unwinds.
        self.watchers: list = []
        self.incidents = None

    @property
    def step(self) -> int:
        return self._step

    def step_tick(self) -> int:
        """Advance the run-local step counter; drives the trace window."""
        with self._lock:
            self._step += 1
            step = self._step
        if self.trace is not None:
            self.trace.on_step(step)
        return step

    def emit(self, kind: str, *, step: Optional[int] = None,
             **payload) -> None:
        event = {"ts": self._clock(), "kind": kind,
                 "step": self._step if step is None else int(step),
                 "host_id": self.host_id, "payload": _jsonable(payload)}
        with self._lock:
            for sink in self._sinks:
                try:
                    sink.emit(event)
                    sink._telemetry_warned = False
                except Exception as e:  # noqa: BLE001 — never kill the run
                    # KEEP the sink and retry on the next event: one
                    # transient wandb/filesystem hiccup must not silently
                    # end the run's primary metric record (warn once per
                    # failure streak, not once per event)
                    if not getattr(sink, "_telemetry_warned", False):
                        sink._telemetry_warned = True
                        print(f"[telemetry] sink {type(sink).__name__} "
                              f"failed ({type(e).__name__}: {e}); kept — "
                              f"will retry on the next event", flush=True)
        for watcher in tuple(self.watchers):
            try:
                watcher.on_event(event)
                watcher._telemetry_warned = False
            except Exception as e:  # noqa: BLE001 — same contract as
                # sinks: observation must never kill the run (warn once
                # per failure streak, keep the watcher)
                if not getattr(watcher, "_telemetry_warned", False):
                    watcher._telemetry_warned = True
                    print(f"[telemetry] watcher {type(watcher).__name__} "
                          f"failed ({type(e).__name__}: {e}); kept",
                          flush=True)

    def close(self) -> None:
        if self.trace is not None:
            self.trace.close()
            self.trace = None
        # watchers BEFORE sinks: their close() may emit final events
        # (the SLO engine's tail evaluation) that must still land in the
        # open sinks; the incident manager restores signal handlers here
        for watcher in tuple(self.watchers):
            try:
                watcher.close()
            # can-tpu-lint: disable=SWALLOW(best-effort watcher close at teardown, mirrors the sink-close rule below)
            except Exception:
                pass
        self.watchers = []
        self.incidents = None
        with self._lock:
            for sink in self._sinks:
                try:
                    sink.close()
                # can-tpu-lint: disable=SWALLOW(best-effort sink close at teardown; emit() already warned per failure streak)
                except Exception:
                    pass
            self._sinks = []


def open_host_telemetry(telemetry_dir: str, *, host_id: int = 0,
                        extra_sinks=(), trace=None) -> Telemetry:
    """The standard wiring: ``<dir>/telemetry.host{k}.jsonl`` for THIS host
    plus any extra sinks.  Every host calls this with its own
    ``process_index()`` — per-host files, no cross-host coordination."""
    sinks = [JsonlSink(os.path.join(telemetry_dir,
                                    f"telemetry.host{host_id}.jsonl"))]
    sinks.extend(extra_sinks)
    return Telemetry(sinks, host_id=host_id, trace=trace)
