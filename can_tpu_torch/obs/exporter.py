"""Prometheus-text ``/metrics`` + ``/healthz`` for live runs.

Counterpart of ``can_tpu/obs/exporter.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The JSONL artifact answers "what happened"; a scrape endpoint answers
"what is happening".  ``GaugeSink`` is an ordinary bus sink — it derives
in-memory gauges/counters from the SAME events every other sink sees (no
new instrumentation, no extra hot-path work beyond a dict update per
event) — and ``MetricsExporter`` serves them over a stdlib
``ThreadingHTTPServer`` (the ``serve/service.py`` pattern: threads hold
blocked scrapers; the run owns the device).

One scrape config covers training AND serving: the serve CLI registers
``CountService.stats()`` as an extra source, so its request/reject/queue
counters come out in the same Prometheus text at the same port.

Exposition format (text/plain; version=0.0.4)::

    # TYPE can_tpu_loss gauge
    can_tpu_loss 0.1234
    # TYPE can_tpu_events_total counter
    can_tpu_events_total{kind="step_window"} 42

Nothing here touches the default path: no ``--metrics-port``, no
``GaugeSink``, no server thread.
"""

from __future__ import annotations

import json
import math
import statistics
import threading
from typing import Callable, Dict, Optional, Tuple

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# serve/service.py stats() keys that are monotonic counts (rendered with
# the Prometheus ``_total`` suffix); the rest of the dict is gauges
_SERVE_COUNTER_KEYS = frozenset(
    {"submitted", "completed", "rejected", "batches", "batch_slots",
     "batch_valid", "compile_count", "failures"})


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _labelled_block(by_name: Dict[str, list], mtype: str) -> list:
    lines = []
    for name in sorted(by_name):
        lines.append(f"# TYPE {name} {mtype}")
        for labels, v in sorted(by_name[name], key=lambda kv: kv[0]):
            if labels:
                lab = ",".join(f'{k}="{str(val)}"' for k, val in labels)
                lines.append(f"{name}{{{lab}}} {_fmt_value(v)}")
            else:
                lines.append(f"{name} {_fmt_value(v)}")
    return lines


def render_prometheus(gauges: Dict[str, float],
                      counters: Dict[Tuple[str, tuple], float],
                      labelled_gauges: Optional[
                          Dict[Tuple[str, tuple], float]] = None) -> str:
    """One exposition block: gauges, then counters.  Labelled maps key on
    ``(name, ((label, value), ...))``.  A name appearing both plain and
    labelled (the fleet's service-wide vs per-replica ``generation``)
    renders as ONE group under ONE ``# TYPE`` line — the Prometheus text
    parser rejects a second TYPE line for the same metric, and that would
    void the whole scrape."""
    by_name: Dict[str, list] = {}
    for name in sorted(gauges):
        v = gauges[name]
        if v is None:
            continue
        by_name.setdefault(name, []).append(((), v))
    if labelled_gauges:
        for (name, labels), v in labelled_gauges.items():
            by_name.setdefault(name, []).append((labels, v))
    lines = _labelled_block(by_name, "gauge")
    by_name = {}
    for (name, labels), v in counters.items():
        by_name.setdefault(name, []).append((labels, v))
    lines += _labelled_block(by_name, "counter")
    return "\n".join(lines) + "\n" if lines else ""


class GaugeSink:
    """Bus sink -> in-memory Prometheus state.

    Gauges (last value wins): run-local ``can_tpu_step``, the per-window
    ``can_tpu_loss`` / ``can_tpu_grad_norm`` / ``can_tpu_update_norm``
    means the loop folds into ``step_window`` events, window median step
    time, per-epoch scalars (``can_tpu_train_loss``, ``can_tpu_mae``,
    ...), heartbeat timestamp, peak HBM / host RSS.  Counters: events by
    kind, steps/images, compiles (+seconds), stall seconds, health alerts
    by signal+kind.  Thread-safe: the bus emits under its own lock from
    several threads, and scrape threads read concurrently."""

    def __init__(self, prefix: str = "can_tpu"):
        self.prefix = prefix
        # RLock: the SIGTERM bundle's gauge snapshot may interrupt the
        # main thread inside emit()'s own critical section — same-thread
        # re-entry must succeed (see obs/incidents.py)
        self._lock = threading.RLock()
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[Tuple[str, tuple], float] = {}
        # labelled gauges (the SLO layer's per-objective/window burns):
        # key (name, ((label, value), ...)), rendered in the same group
        # as any same-named plain gauge
        self._labelled: Dict[Tuple[str, tuple], float] = {}

    # -- bus sink protocol ----------------------------------------------
    def emit(self, event: dict) -> None:
        kind = event.get("kind", "?")
        p = event.get("payload", {})
        pre = self.prefix
        with self._lock:
            self._count((f"{pre}_events_total", (("kind", kind),)))
            if kind == "step_window":
                if event.get("step") is not None:
                    self._gauges[f"{pre}_step"] = event["step"]
                self._count((f"{pre}_steps_total", ()),
                            float(p.get("steps", 0)))
                self._count((f"{pre}_images_total", ()),
                            float(p.get("images", 0.0)))
                samples = p.get("samples_s", ())
                if samples:
                    self._gauges[f"{pre}_step_time_p50_s"] = float(
                        statistics.median(samples))
                for key in ("loss", "grad_norm", "update_norm"):
                    if key in p:
                        self._gauges[f"{pre}_{key}"] = float(p[key])
            elif kind == "compile":
                self._count((f"{pre}_compiles_total", ()))
                self._count((f"{pre}_compile_seconds_total", ()),
                            float(p.get("seconds", 0.0)))
            elif kind == "stall":
                self._count((f"{pre}_stall_seconds_total", ()),
                            float(p.get("seconds", 0.0)))
            elif kind == "epoch":
                if event.get("step") is not None:
                    self._gauges[f"{pre}_epoch"] = event["step"]
                for k, v in p.items():
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        self._gauges[f"{pre}_{_sanitize(k)}"] = float(v)
            elif kind == "heartbeat":
                self._gauges[f"{pre}_last_heartbeat_ts"] = event.get("ts")
            elif kind == "memory":
                for d in p.get("devices", ()):
                    for key in ("peak_bytes_in_use", "bytes_in_use"):
                        if key in d:
                            g = f"{pre}_peak_hbm_bytes"
                            self._gauges[g] = max(
                                self._gauges.get(g, 0), int(d[key]))
                            break
                rss = p.get("host_rss_mb")
                if rss is not None:
                    self._gauges[f"{pre}_host_rss_mb"] = float(rss)
            elif kind == "health.alert":
                self._count((f"{pre}_health_alerts_total",
                             (("signal", str(p.get("signal", "?"))),
                              ("kind", str(p.get("alert", "?"))))))
            elif kind == "serve.request":
                # stream degradation visibility: EWMA-served answers
                # count (vs the fresh-inference total riding
                # events_total{kind="serve.request"}) and the last
                # served staleness — the live view of the ladder's
                # "degrade instead of drown" contract
                if p.get("degraded"):
                    self._count((f"{pre}_stream_degraded_total", ()))
                    if p.get("staleness_s") is not None:
                        self._gauges[f"{pre}_stream_staleness_s"] = \
                            float(p["staleness_s"])
            elif kind == "stream.session":
                if p.get("active") is not None:
                    # sampled exactly when the session set changes or
                    # snapshots (the serve.batch queue-depth discipline)
                    self._gauges[f"{pre}_stream_sessions"] = \
                        float(p["active"])
                if str(p.get("state")) == "evicted":
                    self._count((f"{pre}_stream_evictions_total", ()))
            elif kind == "stream.degrade":
                # one ladder rung TRANSITION (not one degraded answer)
                self._count((f"{pre}_stream_degrade_total",
                             (("rung", str(p.get("rung", "?"))),)))
            elif kind == "stream.repin":
                self._count((f"{pre}_stream_repins_total", ()))
            elif kind == "serve.batch":
                # scheduler economics (can_tpu_torch/sched): per-flush fill %
                # and dead slots, plus the predicted-vs-realized launch
                # cost the core's invariant rides on — a mismatch count
                # above zero is a scheduling bug, live on the scrape
                if p.get("fill_pct") is not None:
                    self._gauges[f"{pre}_sched_fill_pct"] = \
                        float(p["fill_pct"])
                self._count((f"{pre}_sched_batches_total", ()))
                self._count((f"{pre}_sched_slots_total", ()),
                            float(p.get("size", 0)))
                self._count((f"{pre}_sched_padded_slots_total", ()),
                            float(p.get("padded_slots", 0)))
                pred = p.get("predicted_cost_px")
                real = p.get("realized_cost_px")
                if pred is not None and real is not None:
                    self._count((f"{pre}_sched_predicted_cost_px_total",
                                 ()), float(pred))
                    self._count((f"{pre}_sched_realized_cost_px_total",
                                 ()), float(real))
                    from can_tpu_torch.sched.core import costs_match

                    if not costs_match(pred, real):
                        self._count(
                            (f"{pre}_sched_cost_mismatch_total", ()))
            elif kind == "data.planner":
                # batch-planner economics (ShardedBatcher.planner_stats):
                # padding/schedule overhead, program + lowered-launch
                # counts, plan cost — numeric payload entries become
                # can_tpu_planner_* gauges (last epoch wins)
                for k, v in p.items():
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool) and v is not None:
                        self._gauges[f"{pre}_planner_{_sanitize(k)}"] = \
                            float(v)
            elif kind == "fleet.rollout":
                self._count((f"{pre}_fleet_rollouts_total", ()))
                if "generation" in p:
                    self._gauges[f"{pre}_fleet_generation"] = \
                        float(p["generation"])
            elif kind == "fleet.replica":
                # state transitions: count quarantines per replica (flip
                # events re-announce "active" and are not failures); a
                # watchdog wedge is the hang flavour of the same loss
                if str(p.get("state")) in ("quarantined", "wedged"):
                    self._count((f"{pre}_fleet_quarantines_total",
                                 (("replica", str(p.get("replica", "?"))),)))
            elif kind == "fleet.scale":
                # one autoscale/manual add/remove transition; the live
                # count gauge rides the event (sampled exactly when it
                # changes, the serve.batch queue-depth discipline)
                self._count((f"{pre}_fleet_scale_events_total",
                             (("direction",
                               str(p.get("direction", "?"))),)))
                if p.get("live") is not None:
                    self._gauges[f"{pre}_fleet_live_replicas"] = \
                        float(p["live"])
            elif kind == "fleet.resurrect":
                self._count((f"{pre}_fleet_resurrections_total",
                             (("replica", str(p.get("replica", "?"))),)))
                if p.get("live") is not None:
                    self._gauges[f"{pre}_fleet_live_replicas"] = \
                        float(p["live"])
            elif kind == "fleet.probe":
                self._count((f"{pre}_fleet_probes_total",
                             (("ok", "1" if p.get("ok") else "0"),)))
            elif kind == "slo.burn":
                # one objective's multi-window burn evaluation
                # (obs/slo.py): per-window burns and the alerting state
                # become labelled gauges — the admission / scale-up
                # signal an autoscaler scrapes — and alert transitions
                # count.  A window below min_samples has burn None and
                # emits nothing (absence beats a fake zero).
                name = str(p.get("objective", "?"))
                for w, info in (p.get("windows") or {}).items():
                    burn = (info.get("burn")
                            if isinstance(info, dict) else None)
                    if burn is not None:
                        self._labelled[(f"{pre}_slo_burn",
                                        (("objective", name),
                                         ("window_s", str(w))))] = \
                            float(burn)
                self._labelled[(f"{pre}_slo_alerting",
                                (("objective", name),))] = \
                    1.0 if p.get("alerting") else 0.0
                if p.get("alerting"):
                    self._count((f"{pre}_slo_alerts_total",
                                 (("objective", name),)))
            elif kind == "fleet.host":
                # a HOST-level liveness transition (obs/collector.py):
                # stale = heartbeats older than the bound on the
                # skew-corrected clock — "no data ≠ healthy".  The live
                # counts ride the event (sampled exactly when the set
                # changes, the serve.batch queue-depth discipline)
                self._count((f"{pre}_fleet_host_transitions_total",
                             (("state", str(p.get("state", "?"))),)))
                if p.get("live") is not None:
                    self._gauges[f"{pre}_fleet_hosts_live"] = \
                        float(p["live"])
                if p.get("stale") is not None:
                    self._gauges[f"{pre}_fleet_hosts_stale"] = \
                        float(p["stale"])
            elif kind == "collector.ingest":
                # one collector ingest batch accepted for one host:
                # events/torn-line counts by host label, transport
                # (tail|push) recorded as its own counter dimension
                host = str(p.get("host", "?"))
                self._count((f"{pre}_collector_events_total",
                             (("host", host),)),
                            float(p.get("events", 0)))
                if p.get("torn"):
                    self._count((f"{pre}_collector_torn_total",
                                 (("host", host),)),
                                float(p["torn"]))
            elif kind == "incident.bundle":
                self._count((f"{pre}_incidents_total",
                             (("reason", str(p.get("reason", "?"))),)))
            elif kind == "perf.summary":
                # performance-attribution aggregates (obs/costs.py
                # ProgramCostLedger.summary): the payload keys are already
                # gauge-shaped (mfu_weighted, roofline_*_bound,
                # launch_cost_mpx_empirical, launch_cost_drift, ...), so
                # numeric entries map verbatim to can_tpu_<key>; the
                # per-program "detail" list and string provenance are for
                # the JSONL/report, not the scrape
                for k, v in p.items():
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        self._gauges[f"{pre}_{_sanitize(k)}"] = float(v)

    def close(self) -> None:
        pass  # in-memory only; the exporter's lifecycle is the CLI's

    # -- reads -----------------------------------------------------------
    def _count(self, key: Tuple[str, tuple], by: float = 1.0) -> None:
        self._counters[key] = self._counters.get(key, 0) + by

    def alerts_total(self) -> int:
        with self._lock:
            return int(sum(v for (name, _), v in self._counters.items()
                           if name == f"{self.prefix}_health_alerts_total"))

    def render(self) -> str:
        with self._lock:
            return render_prometheus(dict(self._gauges),
                                     dict(self._counters),
                                     dict(self._labelled))

    def snapshot(self) -> dict:
        """JSON-ready point-in-time copy of every gauge and counter —
        what an incident bundle freezes (obs/incidents.py): the same
        values a /metrics scrape would have shown at the moment of
        death, without needing the exporter to still be alive."""
        with self._lock:
            return {
                "gauges": dict(self._gauges),
                "labelled_gauges": [
                    {"name": n, "labels": dict(labels), "value": v}
                    for (n, labels), v in sorted(self._labelled.items())],
                "counters": [
                    {"name": n, "labels": dict(labels), "value": v}
                    for (n, labels), v in sorted(self._counters.items())],
            }


# how a fleet rollup folds one gauge across hosts (obs/collector.py's
# federated /metrics): "sum" for capacity-like gauges where the fleet
# value is the total, "last" for stream-position gauges where the most
# recently heartbeating host is the truth, "max" (the default) for
# watermarks and progress.  Counters always sum — they are totals by
# construction.
DEFAULT_FLEET_AGG: Dict[str, str] = {
    "can_tpu_stream_sessions": "sum",
    "can_tpu_fleet_live_replicas": "sum",
    "can_tpu_host_rss_mb": "sum",
    "can_tpu_loss": "last",
    "can_tpu_step_time_p50_s": "last",
}


def aggregate_fleet(snapshots: Dict[int, dict], *, label: str = "host",
                    agg: Optional[Dict[str, str]] = None
                    ) -> Tuple[Dict[str, float],
                               Dict[Tuple[str, tuple], float],
                               Dict[Tuple[str, tuple], float]]:
    """Fold per-host ``GaugeSink.snapshot()`` dicts into one federated
    exposition: every per-host sample re-emitted with a ``host`` label,
    PLUS one plain fleet rollup per gauge/counter family.  Returns
    ``(gauges, counters, labelled_gauges)`` shaped for
    :func:`render_prometheus` — which renders a family's plain rollup
    and its host-labelled members under ONE ``# TYPE`` line (the PR-8
    dup-TYPE rule, now extended to host-labelled families).

    Rollups: counters sum; gauges follow ``agg`` (name -> sum|max|last,
    over :data:`DEFAULT_FLEET_AGG`, default max), where "last" takes the
    value from the host with the newest heartbeat.  Per-host LABELLED
    gauges (per-objective burns etc.) are host-labelled but not rolled
    up — cross-host aggregates of those need real cross-host arithmetic
    (the collector's global SLO engine), not a per-name fold."""
    rules = dict(DEFAULT_FLEET_AGG)
    rules.update(agg or {})
    gauges: Dict[str, float] = {}
    counters: Dict[Tuple[str, tuple], float] = {}
    labelled: Dict[Tuple[str, tuple], float] = {}
    # hosts ordered oldest-heartbeat first, so for "last" the newest
    # heartbeat's value lands last and wins the fold
    def _hb(item):
        hid, snap = item
        hb = (snap.get("gauges") or {}).get("can_tpu_last_heartbeat_ts")
        return (hb if isinstance(hb, (int, float)) else float("-inf"),
                hid)
    ordered = sorted(snapshots.items(), key=_hb)
    for hid, snap in ordered:
        hl = (label, str(hid))
        for name, v in sorted((snap.get("gauges") or {}).items()):
            if v is None:
                continue
            labelled[(name, (hl,))] = v
            rule = rules.get(name, "max")
            if rule == "sum":
                gauges[name] = gauges.get(name, 0.0) + float(v)
            elif rule == "last":
                gauges[name] = v
            else:
                gauges[name] = (v if name not in gauges
                                else max(gauges[name], v))
        for row in snap.get("labelled_gauges") or ():
            labels = tuple(sorted(dict(row.get("labels") or {},
                                       **{label: str(hid)}).items()))
            labelled[(row["name"], labels)] = row["value"]
        for row in snap.get("counters") or ():
            base = dict(row.get("labels") or {})
            base.pop(label, None)
            labels = tuple(sorted({**base, label: str(hid)}.items()))
            counters[(row["name"], labels)] = \
                counters.get((row["name"], labels), 0.0) + row["value"]
            roll = tuple(sorted(base.items()))
            counters[(row["name"], roll)] = \
                counters.get((row["name"], roll), 0.0) + row["value"]
    return gauges, counters, labelled


def render_stats(stats: dict, *, prefix: str = "can_tpu_serve",
                 counter_keys=_SERVE_COUNTER_KEYS) -> str:
    """Flat numeric stats dict -> Prometheus text (serve's ``/stats``
    counters in the same scrape).  Count-like keys get ``_total``; bools
    become 0/1 gauges; Nones and other nested values are skipped — EXCEPT
    the fleet's ``"replicas"`` sub-dicts, whose numeric entries become
    per-replica LABELLED lines (``can_tpu_serve_batches_total{replica=
    "k"}``), so one scrape shows which replica is serving, quarantined,
    or lagging a rollout generation."""
    gauges: Dict[str, float] = {}
    counters: Dict[Tuple[str, tuple], float] = {}
    labelled_gauges: Dict[Tuple[str, tuple], float] = {}
    for k, v in stats.items():
        if k == "replicas" and isinstance(v, dict):
            for rk, sub in v.items():
                if not isinstance(sub, dict):
                    continue
                label = (("replica", str(rk)),)
                for sk, sv in sub.items():
                    if sv is None or not isinstance(sv, (int, float, bool)):
                        continue
                    name = f"{prefix}_{_sanitize(sk)}"
                    if sk in counter_keys and not isinstance(sv, bool):
                        counters[(f"{name}_total", label)] = sv
                    else:  # quarantined/generation: state gauges
                        labelled_gauges[(name, label)] = sv
            continue
        if v is None or not isinstance(v, (int, float, bool)):
            continue
        name = f"{prefix}_{_sanitize(k)}"
        if k in counter_keys and not isinstance(v, bool):
            counters[(f"{name}_total", ())] = v
        else:
            gauges[name] = v
    return render_prometheus(gauges, counters, labelled_gauges)


class MetricsExporter:
    """The scrape endpoint: ``GET /metrics`` (gauge sink + every
    registered stats source) and ``GET /healthz`` (liveness + the alert
    counter, so a probe can distinguish "up" from "up but screaming").

    ``port=0`` binds an ephemeral port (tests); ``.port`` is the bound
    one.  ``start()`` launches a daemon thread — scrapes must never block
    the train loop, and a hung scraper dies with the process."""

    def __init__(self, gauges: GaugeSink, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.gauges = gauges
        self.host = host
        self.port = int(port)
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def add_stats_source(self, prefix: str,
                         stats_fn: Callable[[], dict]) -> None:
        """Expose a flat numeric stats dict (e.g. ``CountService.stats``)
        as ``can_tpu_<prefix>_*`` lines in the same scrape."""
        self._sources[prefix] = stats_fn

    def render(self) -> str:
        parts = [self.gauges.render()]
        for prefix, fn in sorted(self._sources.items()):
            try:
                parts.append(render_stats(fn(),
                                          prefix=f"can_tpu_{prefix}"))
            except Exception as e:  # noqa: BLE001 — a dead source must
                # not kill the scrape: the OTHER metrics still matter
                parts.append(f"# source {prefix} failed: "
                             f"{type(e).__name__}\n")
        return "".join(p for p in parts if p)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "MetricsExporter":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

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
                    self._send(200, exporter.render().encode(),
                               _PROM_CONTENT_TYPE)
                elif path == "/healthz":
                    body = json.dumps(
                        {"ok": True,
                         "alerts_total": exporter.gauges.alerts_total()})
                    self._send(200, body.encode(), "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": f"no such path: {path}"}).encode(),
                        "application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="can-tpu-metrics-exporter")
        self._thread.start()
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
