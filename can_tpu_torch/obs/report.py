"""Summarize a telemetry JSONL into the numbers an operator asks first.

Counterpart of ``can_tpu/obs/report.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

``tools/telemetry_report.py`` is the CLI; this module is the importable
(and tier-1-tested) core: read events, aggregate, format one table.
Tolerant by design — unknown kinds are counted and otherwise ignored, and
a truncated last line (a run killed mid-write) is skipped, because the
reader's job is post-mortem triage of exactly such runs.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional, Tuple

import numpy as np


def read_events_counted(path: str) -> Tuple[List[dict], int]:
    """Read a telemetry JSONL, returning ``(events, skipped_lines)``.

    A run killed mid-write leaves a torn final line — exactly the runs
    this reader triages — so undecodable lines are skipped, but COUNTED:
    the note distinguishes "clean artifact" from "crashed mid-event"
    (and more than one skip flags real corruption, not a torn tail)."""
    events = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                skipped += 1  # torn tail write of a killed run
    return events, skipped


def read_events(path: str) -> List[dict]:
    return read_events_counted(path)[0]


def _percentile(samples: List[float], q: float) -> Optional[float]:
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, np.float64), q))


def summarize(events: Iterable[dict]) -> dict:
    """Aggregate one host's event stream.  Step-time percentiles pool the
    raw per-step samples every ``step_window`` event carries, so they are
    exact over the run, not a merge of per-window approximations."""
    events = list(events)
    by_kind: dict = {}
    samples: List[float] = []
    steps = 0
    images = 0.0
    compile_s = 0.0
    stall_s = 0.0
    stall_events = 0
    peak_hbm = None
    peak_rss_mb = None
    first_ts = None
    last_ts = None
    last_heartbeat_ts = None
    epochs = set()
    serve_lat: List[float] = []
    serve_queue_wait: List[float] = []
    serve_device: List[float] = []
    serve_rejects: dict = {}
    serve_batches = 0
    serve_slots = 0
    serve_valid = 0
    serve_queue_depth_max = None
    # stream sessions (serve/streams.py): degraded answers off
    # serve.request, lifecycle/ladder/pin counts off the stream.* kinds
    stream_degraded = 0
    stream_staleness: List[float] = []
    stream_sessions_last = None
    stream_evictions = 0
    stream_degrade_by_rung: dict = {}
    stream_repins = 0
    # scheduling core (can_tpu_torch/sched): per-flush economics off serve.batch
    sched_padded = 0
    sched_pred_px = 0.0
    sched_real_px = 0.0
    sched_mismatches = 0
    perf_last: Optional[dict] = None
    span_names: dict = {}
    fleet_rollouts = 0
    fleet_generation = None
    fleet_quarantines: dict = {}
    fleet_states: dict = {}
    fleet_scale = {"up": 0, "down": 0}
    fleet_live_last = None
    fleet_resurrections = 0
    fleet_probes = {"ok": 0, "failed": 0}
    fleet_ttfr_last = None
    fleet_host_states: dict = {}
    fleet_host_stale_events = 0
    collector_ingested = 0
    collector_torn = 0
    cache_last: Optional[dict] = None
    planner_last: Optional[dict] = None
    prepared_splits: dict = {}
    alerts: dict = {}
    health_last: Optional[dict] = None
    incidents_by_reason: dict = {}
    incident_last: Optional[dict] = None
    slo_last: dict = {}
    slo_alert_events = 0
    elastic_transitions = 0
    elastic_last: Optional[dict] = None
    for e in events:
        kind = e.get("kind", "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            first_ts = ts if first_ts is None else min(first_ts, ts)
            last_ts = ts if last_ts is None else max(last_ts, ts)
        p = e.get("payload", {})
        if kind == "step_window":
            steps += int(p.get("steps", 0))
            images += float(p.get("images", 0.0))
            samples.extend(float(s) for s in p.get("samples_s", ()))
        elif kind == "compile":
            compile_s += float(p.get("seconds", 0.0))
        elif kind == "stall":
            stall_s += float(p.get("seconds", 0.0))
            stall_events += int(p.get("count", 0))
        elif kind == "memory":
            for d in p.get("devices", ()):
                for key in ("peak_bytes_in_use", "bytes_in_use"):
                    if key in d:
                        v = int(d[key])
                        peak_hbm = v if peak_hbm is None else max(peak_hbm, v)
                        break
            rss = p.get("host_rss_mb")
            if rss is not None:
                peak_rss_mb = (rss if peak_rss_mb is None
                               else max(peak_rss_mb, rss))
        elif kind == "heartbeat":
            last_heartbeat_ts = (ts if last_heartbeat_ts is None
                                 else max(last_heartbeat_ts, ts))
        elif kind == "epoch":
            if e.get("step") is not None:
                epochs.add(int(e["step"]))
        elif kind == "serve.request":
            if "latency_s" in p:
                serve_lat.append(float(p["latency_s"]))
            if "queue_wait_s" in p:
                serve_queue_wait.append(float(p["queue_wait_s"]))
            if "device_s" in p:
                serve_device.append(float(p["device_s"]))
            if p.get("degraded"):
                stream_degraded += 1
                if p.get("staleness_s") is not None:
                    stream_staleness.append(float(p["staleness_s"]))
        elif kind == "serve.batch":
            serve_batches += 1
            serve_slots += int(p.get("size", 0))
            serve_valid += int(p.get("valid", 0))
            sched_padded += int(p.get("padded_slots", 0))
            if p.get("predicted_cost_px") is not None:
                from can_tpu_torch.sched.core import costs_match

                sched_pred_px += float(p["predicted_cost_px"])
                sched_real_px += float(p.get("realized_cost_px", 0.0))
                if not costs_match(p["predicted_cost_px"],
                                   p.get("realized_cost_px", 0.0)):
                    sched_mismatches += 1
            depth = p.get("queue_depth")
            if depth is not None:
                d = int(depth)
                serve_queue_depth_max = (
                    d if serve_queue_depth_max is None
                    else max(serve_queue_depth_max, d))
        elif kind == "serve.reject":
            reason = str(p.get("reason", "?"))
            serve_rejects[reason] = (serve_rejects.get(reason, 0)
                                     + int(p.get("count", 1)))
        elif kind == "health.alert":
            tag = f"{p.get('signal', '?')}/{p.get('alert', '?')}"
            alerts[tag] = alerts.get(tag, 0) + 1
        elif kind == "health.summary":
            health_last = p  # per-epoch rollup: the last wins
        elif kind == "data.cache":
            cache_last = p  # counters are cumulative: the last wins
        elif kind == "data.planner":
            planner_last = p  # plan is epoch-invariant: the last wins
        elif kind == "data.prepared":
            split = str(p.get("split", "?"))
            prepared_splits[split] = ("on" if p.get("active")
                                      else f"legacy({p.get('reason', '?')})")
        elif kind == "fleet.rollout":
            fleet_rollouts += 1
            if p.get("generation") is not None:
                g = int(p["generation"])
                fleet_generation = (g if fleet_generation is None
                                    else max(fleet_generation, g))
        elif kind == "fleet.replica":
            rk = str(p.get("replica", "?"))
            fleet_states[rk] = str(p.get("state", "?"))  # last state wins
            if p.get("state") in ("quarantined", "wedged"):
                fleet_quarantines[rk] = fleet_quarantines.get(rk, 0) + 1
        elif kind == "fleet.scale":
            d = str(p.get("direction", "?"))
            fleet_scale[d] = fleet_scale.get(d, 0) + 1
            if p.get("live") is not None:
                fleet_live_last = int(p["live"])
            if p.get("time_to_first_ready_s") is not None:
                fleet_ttfr_last = float(p["time_to_first_ready_s"])
        elif kind == "fleet.resurrect":
            fleet_resurrections += 1
            if p.get("live") is not None:
                fleet_live_last = int(p["live"])
        elif kind == "fleet.probe":
            fleet_probes["ok" if p.get("ok") else "failed"] += 1
        elif kind == "fleet.host":
            hk = str(p.get("host", "?"))
            fleet_host_states[hk] = str(p.get("state", "?"))  # last wins
            if p.get("state") == "stale":
                fleet_host_stale_events += 1
        elif kind == "collector.ingest":
            collector_ingested += int(p.get("events", 0))
            collector_torn += int(p.get("torn", 0))
        elif kind == "stream.session":
            if p.get("active") is not None:
                stream_sessions_last = int(p["active"])
            if p.get("state") == "evicted":
                stream_evictions += 1
        elif kind == "stream.degrade":
            rung = str(p.get("rung", "?"))
            stream_degrade_by_rung[rung] = \
                stream_degrade_by_rung.get(rung, 0) + 1
        elif kind == "stream.repin":
            stream_repins += 1
        elif kind == "incident.bundle":
            reason = str(p.get("reason", "?"))
            incidents_by_reason[reason] = \
                incidents_by_reason.get(reason, 0) + 1
            incident_last = p  # the freshest bundle is the triage entry
        elif kind == "slo.burn":
            slo_last[str(p.get("objective", "?"))] = p  # last eval wins
            if p.get("alerting"):
                slo_alert_events += 1
        elif kind == "elastic.transition":
            elastic_transitions += 1
            elastic_last = p  # the newest world formation wins
        elif kind == "perf.summary":
            perf_last = p  # the ledger is cumulative: the last wins
        elif kind == "trace.span":
            name = str(p.get("name", "?"))
            span_names[name] = span_names.get(name, 0) + 1
    wall_s = (last_ts - first_ts) if first_ts is not None else None
    return {
        "events": len(events),
        "by_kind": dict(sorted(by_kind.items())),
        "steps": steps,
        "images": images,
        "epochs": len(epochs),
        "wall_s": round(wall_s, 3) if wall_s is not None else None,
        "step_p50_s": _percentile(samples, 50),
        "step_p95_s": _percentile(samples, 95),
        "step_max_s": max(samples) if samples else None,
        "recompiles": by_kind.get("compile", 0),
        "compile_s": round(compile_s, 3),
        "stall_s": round(stall_s, 3),
        "stall_events": stall_events,
        "peak_hbm_bytes": peak_hbm,
        "peak_host_rss_mb": peak_rss_mb,
        "heartbeats": by_kind.get("heartbeat", 0),
        "last_heartbeat_ts": last_heartbeat_ts,
        # online serving (can_tpu_torch/serve); zeros/Nones for offline runs
        "serve_requests": by_kind.get("serve.request", 0),
        "serve_latency_p50_s": _percentile(serve_lat, 50),
        "serve_latency_p95_s": _percentile(serve_lat, 95),
        "serve_latency_max_s": max(serve_lat) if serve_lat else None,
        "serve_batches": serve_batches,
        "serve_mean_fill": (round(serve_valid / serve_slots, 4)
                            if serve_slots else None),
        "serve_rejects": sum(serve_rejects.values()),
        "serve_rejects_by_reason": dict(sorted(serve_rejects.items())),
        "serve_queue_depth_max": serve_queue_depth_max,
        # scheduling core (can_tpu_torch/sched); Nones/zeros pre-r14 artifacts
        "sched_fill_pct": (round(100.0 * serve_valid / serve_slots, 2)
                           if serve_slots else None),
        "sched_padded_slots": sched_padded,
        "sched_predicted_cost_px": round(sched_pred_px, 1),
        "sched_realized_cost_px": round(sched_real_px, 1),
        "sched_cost_mismatches": sched_mismatches,
        # per-request breakdown (from the span timestamps; Nones pre-r9)
        "serve_queue_wait_p50_s": _percentile(serve_queue_wait, 50),
        "serve_queue_wait_p95_s": _percentile(serve_queue_wait, 95),
        "serve_device_p95_s": _percentile(serve_device, 95),
        # stream sessions (serve/streams.py); zeros/Nones pre-stream
        "stream_sessions": stream_sessions_last,
        "stream_degraded": stream_degraded,
        "stream_staleness_p95_s": _percentile(stream_staleness, 95),
        "stream_degrade_transitions": dict(
            sorted(stream_degrade_by_rung.items())),
        "stream_repins": stream_repins,
        "stream_evictions": stream_evictions,
        # serving fleet (can_tpu_torch/serve/fleet.py); zeros/empty single-engine
        "fleet_rollouts": fleet_rollouts,
        "fleet_generation": fleet_generation,
        "fleet_quarantines": sum(fleet_quarantines.values()),
        "fleet_replica_states": dict(sorted(fleet_states.items())),
        # self-healing layer (ISSUE 13): scale transitions, probation
        # probes, resurrections, last time-to-first-ready
        "fleet_scale_up": fleet_scale.get("up", 0),
        "fleet_scale_down": fleet_scale.get("down", 0),
        "fleet_live_replicas": fleet_live_last,
        "fleet_resurrections": fleet_resurrections,
        "fleet_probes_ok": fleet_probes["ok"],
        "fleet_probes_failed": fleet_probes["failed"],
        "fleet_ttfr_last_s": fleet_ttfr_last,
        # fleet observability plane (obs/collector.py): per-HOST
        # liveness transitions + ingest totals; empty/zero off-collector
        "fleet_host_states": dict(sorted(fleet_host_states.items())),
        "fleet_host_stale_events": fleet_host_stale_events,
        "collector_ingested": collector_ingested,
        "collector_torn": collector_torn,
        # host data pipeline (can_tpu_torch/data/prepared.py); Nones/empty offline
        "prepared_splits": dict(sorted(prepared_splits.items())),
        "cache_hits": cache_last.get("hits") if cache_last else None,
        "cache_misses": cache_last.get("misses") if cache_last else None,
        "cache_hit_rate": cache_last.get("hit_rate") if cache_last else None,
        "cache_bytes": cache_last.get("bytes") if cache_last else None,
        "cache_capacity_bytes": (cache_last.get("capacity_bytes")
                                 if cache_last else None),
        "cache_evictions": (cache_last.get("evictions")
                            if cache_last else None),
        # batch planner (can_tpu_torch/data/planner.py); Nones when not emitted
        "planner_mode": planner_last.get("plan_mode") if planner_last else None,
        "planner_padding_overhead": (planner_last.get("padding_overhead")
                                     if planner_last else None),
        "planner_schedule_overhead": (planner_last.get("schedule_overhead")
                                      if planner_last else None),
        "planner_programs": (planner_last.get("program_count")
                             if planner_last else None),
        "planner_lowered_launches": (planner_last.get("lowered_launches")
                                     if planner_last else None),
        "planner_realized_programs": (planner_last.get("realized_programs")
                                      if planner_last else None),
        # run-health layer (can_tpu_torch/obs/health.py); zeros/Nones when off
        "health_alerts": sum(alerts.values()),
        "health_alerts_by_kind": dict(sorted(alerts.items())),
        "health_suppressed": (health_last.get("suppressed")
                              if health_last else None),
        # performance attribution (can_tpu_torch/obs/costs.py + spans.py);
        # Nones/zeros when the ledger/tracer were never armed
        "perf_programs": perf_last.get("perf_programs") if perf_last else None,
        "perf_mfu_weighted": (perf_last.get("mfu_weighted")
                              if perf_last else None),
        "perf_mfu_best": perf_last.get("mfu_best") if perf_last else None,
        "perf_mfu_worst": perf_last.get("mfu_worst") if perf_last else None,
        "perf_roofline_compute": (perf_last.get("roofline_compute_bound")
                                  if perf_last else None),
        "perf_roofline_memory": (perf_last.get("roofline_memory_bound")
                                 if perf_last else None),
        "perf_roofline_unknown": (perf_last.get("roofline_unknown")
                                  if perf_last else None),
        "perf_launch_cost_mpx": (perf_last.get("launch_cost_mpx_empirical")
                                 if perf_last else None),
        "perf_launch_cost_drift": (perf_last.get("launch_cost_drift")
                                   if perf_last else None),
        "perf_peak_nominal": (bool(perf_last.get("peak_nominal"))
                              if perf_last else None),
        "trace_spans": by_kind.get("trace.span", 0),
        "trace_spans_by_name": dict(sorted(span_names.items())),
        # incident layer (can_tpu_torch/obs/incidents.py + slo.py); zeros/empty
        # when never armed
        "incidents": sum(incidents_by_reason.values()),
        "incidents_by_reason": dict(sorted(incidents_by_reason.items())),
        "incident_last_path": (incident_last.get("path")
                               if incident_last else None),
        # elastic transitions (parallel/elastic.py); zeros/Nones when the
        # run never shrank
        "elastic_transitions": elastic_transitions,
        "elastic_last": (None if elastic_last is None else {
            "epoch": elastic_last.get("epoch"),
            "steps_done": elastic_last.get("steps_done"),
            "processes_old": elastic_last.get("processes_old"),
            "processes_new": elastic_last.get("processes_new"),
            "dp_old": elastic_last.get("dp_old"),
            "dp_new": elastic_last.get("dp_new"),
            "lr_scale": elastic_last.get("lr_scale"),
            "remaining_items": elastic_last.get("remaining_items"),
            "reason": elastic_last.get("reason"),
        }),
        "slo_objectives": {
            name: {"burn_min": p.get("burn_min"),
                   "burn_max": p.get("burn_max"),
                   "alerting": bool(p.get("alerting")),
                   "run_good": p.get("run_good"),
                   "run_bad": p.get("run_bad")}
            for name, p in sorted(slo_last.items())},
        "slo_alert_events": slo_alert_events,
    }


def _fmt(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}{unit}"
    return f"{v}{unit}"


def format_report(summary: dict, *, title: str = "telemetry") -> str:
    """One aligned two-column table; the whole contract of the CLI tool."""
    gib = (summary["peak_hbm_bytes"] / 2**30
           if summary["peak_hbm_bytes"] is not None else None)
    rows = [
        ("events", _fmt(summary["events"])),
        ("kinds", " ".join(f"{k}={n}"
                           for k, n in summary["by_kind"].items()) or "-"),
        ("epochs", _fmt(summary["epochs"])),
        ("steps", _fmt(summary["steps"])),
        ("images", _fmt(summary["images"])),
        ("wall", _fmt(summary["wall_s"], " s")),
        ("step p50", _fmt(summary["step_p50_s"], " s")),
        ("step p95", _fmt(summary["step_p95_s"], " s")),
        ("step max", _fmt(summary["step_max_s"], " s")),
        ("recompiles", _fmt(summary["recompiles"])),
        ("compile time", _fmt(summary["compile_s"], " s")),
        ("input stall", _fmt(summary["stall_s"], " s")),
        ("peak HBM", _fmt(round(gib, 3) if gib is not None else None,
                          " GiB")),
        ("peak host RSS", _fmt(summary["peak_host_rss_mb"], " MB")),
        ("heartbeats", _fmt(summary["heartbeats"])),
    ]
    if summary.get("prepared_splits"):
        rows.append(("prepared store",
                     " ".join(f"{k}={v}" for k, v in
                              summary["prepared_splits"].items())))
    if summary.get("cache_hits") is not None:
        cap = summary.get("cache_capacity_bytes")
        rows += [
            ("item cache", f"hits={summary['cache_hits']} "
                           f"misses={summary['cache_misses']} "
                           f"hit_rate={_fmt(summary['cache_hit_rate'])}"),
            ("item cache bytes",
             f"{_fmt(summary['cache_bytes'])} / {_fmt(cap)}"
             f" (evictions={_fmt(summary['cache_evictions'])})"),
        ]
    if summary.get("planner_schedule_overhead") is not None:
        rows.append(
            ("batch planner",
             f"mode={summary['planner_mode']} "
             f"padding={_fmt(summary['planner_padding_overhead'])} "
             f"schedule={_fmt(summary['planner_schedule_overhead'])} "
             f"programs={_fmt(summary['planner_programs'])}"
             + (f" (realized {summary['planner_realized_programs']})"
                if summary.get("planner_realized_programs") is not None
                else "")
             + (f" lowered={summary['planner_lowered_launches']}"
                if summary.get("planner_lowered_launches") else "")))
    if summary.get("perf_programs"):
        nominal = " (NOMINAL peak)" if summary.get("perf_peak_nominal") else ""
        rows.append(
            ("perf MFU",
             f"weighted={_fmt(summary['perf_mfu_weighted'])} "
             f"best={_fmt(summary['perf_mfu_best'])} "
             f"worst={_fmt(summary['perf_mfu_worst'])} "
             f"programs={summary['perf_programs']}{nominal}"))
        rows.append(
            ("perf roofline",
             f"compute={_fmt(summary['perf_roofline_compute'])} "
             f"memory={_fmt(summary['perf_roofline_memory'])} "
             f"unknown={_fmt(summary['perf_roofline_unknown'])}"))
        if summary.get("perf_launch_cost_mpx") is not None:
            rows.append(
                ("perf launch cost",
                 f"empirical={_fmt(summary['perf_launch_cost_mpx'])} Mpx"
                 + (f" drift={_fmt(summary['perf_launch_cost_drift'])}x"
                    if summary.get("perf_launch_cost_drift") is not None
                    else "")))
    if summary.get("trace_spans"):
        names = summary.get("trace_spans_by_name") or {}
        rows.append(("trace spans",
                     f"{summary['trace_spans']} ("
                     + " ".join(f"{k}={n}" for k, n in names.items()) + ")"))
    if summary.get("elastic_transitions"):
        e = summary.get("elastic_last") or {}
        rows.append(
            ("elastic",
             f"transitions={summary['elastic_transitions']} "
             f"last: epoch {_fmt(e.get('epoch'))} "
             f"step {_fmt(e.get('steps_done'))} "
             f"world {_fmt(e.get('processes_old'))}proc/"
             f"dp{_fmt(e.get('dp_old'))} -> "
             f"{_fmt(e.get('processes_new'))}proc/"
             f"dp{_fmt(e.get('dp_new'))} "
             f"lr x{_fmt(e.get('lr_scale'))} "
             f"remaining={_fmt(e.get('remaining_items'))} "
             f"({e.get('reason', '?')})"))
    if summary.get("incidents"):
        by_reason = summary.get("incidents_by_reason") or {}
        rows.append(("incidents",
                     " ".join(f"{k}={n}" for k, n in by_reason.items())))
        if summary.get("incident_last_path"):
            rows.append(("last bundle", summary["incident_last_path"]))
    if summary.get("slo_objectives"):
        parts = []
        for name, o in summary["slo_objectives"].items():
            burn = o.get("burn_max")
            tag = _fmt(burn) if burn is not None else "-"
            parts.append(f"{name}={tag}"
                         + ("(ALERT)" if o.get("alerting") else ""))
        rows.append(("SLO burn (max)", " ".join(parts)))
        if summary.get("slo_alert_events"):
            rows.append(("SLO alert evals",
                         _fmt(summary["slo_alert_events"])))
    if summary.get("health_alerts"):
        by_kind = summary.get("health_alerts_by_kind") or {}
        rows.append(("health alerts",
                     " ".join(f"{k}={n}" for k, n in by_kind.items())))
        if summary.get("health_suppressed"):
            rows.append(("alerts suppressed",
                         _fmt(summary["health_suppressed"])))
    if summary.get("serve_requests") or summary.get("serve_rejects"):
        rejects = summary.get("serve_rejects_by_reason") or {}
        rows += [
            ("serve requests", _fmt(summary["serve_requests"])),
            ("serve p50", _fmt(summary["serve_latency_p50_s"], " s")),
            ("serve p95", _fmt(summary["serve_latency_p95_s"], " s")),
            ("serve max", _fmt(summary["serve_latency_max_s"], " s")),
            ("serve batches", _fmt(summary["serve_batches"])),
            ("serve mean fill", _fmt(summary["serve_mean_fill"])),
            ("serve rejects", " ".join(f"{k}={n}"
                                       for k, n in rejects.items()) or "0"),
            ("serve queue max", _fmt(summary["serve_queue_depth_max"])),
        ]
        if summary.get("serve_queue_wait_p95_s") is not None:
            rows.append(
                ("serve breakdown",
                 f"queue_wait p95={_fmt(summary['serve_queue_wait_p95_s'])} s"
                 f" device p95={_fmt(summary['serve_device_p95_s'])} s"))
        if summary.get("sched_fill_pct") is not None:
            # the scheduling core's per-flush economics (can_tpu_torch/sched):
            # fill %, dead slots, and the predicted==realized invariant
            mism = summary.get("sched_cost_mismatches", 0)
            rows.append(
                ("scheduler",
                 f"fill={_fmt(summary['sched_fill_pct'])}% "
                 f"padded_slots={summary['sched_padded_slots']} "
                 f"predicted={_fmt(summary['sched_predicted_cost_px'])}px "
                 f"realized={_fmt(summary['sched_realized_cost_px'])}px "
                 + ("predicted==realized" if not mism
                    else f"MISMATCHES={mism}")))
    if (summary.get("stream_sessions") is not None
            or summary.get("stream_degraded")
            or summary.get("stream_repins")):
        by_rung = summary.get("stream_degrade_transitions") or {}
        rungs = (" transitions: " + " ".join(f"{k}={n}" for k, n
                                             in by_rung.items())
                 if by_rung else "")
        rows.append(
            ("streams",
             f"sessions={_fmt(summary.get('stream_sessions'))} "
             f"degraded={summary['stream_degraded']} "
             f"staleness p95={_fmt(summary['stream_staleness_p95_s'], ' s')} "
             f"repins={summary['stream_repins']} "
             f"evictions={summary['stream_evictions']}" + rungs))
    if (summary.get("fleet_rollouts") or summary.get("fleet_quarantines")
            or summary.get("fleet_replica_states")):
        states = summary.get("fleet_replica_states") or {}
        rows.append(
            ("serving fleet",
             f"rollouts={summary['fleet_rollouts']} "
             f"generation={_fmt(summary.get('fleet_generation'))} "
             f"quarantines={summary['fleet_quarantines']}"
             + ((" replicas: "
                 + " ".join(f"r{k}={v}" for k, v in states.items()))
                if states else "")))
    if (summary.get("fleet_resurrections") or summary.get("fleet_scale_up")
            or summary.get("fleet_scale_down")
            or summary.get("fleet_probes_ok")
            or summary.get("fleet_probes_failed")):
        rows.append(
            ("fleet healing",
             f"resurrections={summary['fleet_resurrections']} "
             f"probes ok={summary['fleet_probes_ok']}/"
             f"failed={summary['fleet_probes_failed']} "
             f"scale up={summary['fleet_scale_up']}/"
             f"down={summary['fleet_scale_down']}"
             + (f" live={summary['fleet_live_replicas']}"
                if summary.get("fleet_live_replicas") is not None else "")
             + (f" ttfr={_fmt(summary['fleet_ttfr_last_s'])} s"
                if summary.get("fleet_ttfr_last_s") is not None else "")))
    if (summary.get("fleet_host_states")
            or summary.get("collector_ingested")
            or summary.get("collector_torn")):
        hosts = summary.get("fleet_host_states") or {}
        rows.append(
            ("fleet hosts",
             f"ingested={summary.get('collector_ingested', 0)} "
             f"torn={summary.get('collector_torn', 0)} "
             f"stale events={summary.get('fleet_host_stale_events', 0)}"
             + ((" hosts: "
                 + " ".join(f"h{k}={v}" for k, v in hosts.items()))
                if hosts else "")))
    width = max(len(k) for k, _ in rows)
    lines = [f"# {title}"]
    lines += [f"{k.ljust(width)}  {v}" for k, v in rows]
    return "\n".join(lines)
