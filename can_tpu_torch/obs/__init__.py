"""can_tpu_torch.obs — structured telemetry: event bus, sources, spans,
health, SLOs, incidents and the fleet collector (counterpart of
``can_tpu/obs``, with its module paths, public names, JSONL schema and
``can_tpu_*`` metric names).

Quickstart (what the serve CLI wires up from ``--telemetry-dir``)::

    from can_tpu_torch import obs

    tel = obs.open_host_telemetry(out_dir, host_id=0)
    hb = obs.Heartbeat(tel, interval_s=60)
    try:
        tel.emit("epoch", step=epoch, train_loss=loss)
    finally:
        obs.shutdown_telemetry(tel, heartbeat=hb)

Every layer that does device work takes an optional ``telemetry`` and
stays zero-cost when it is None.  The device side (ROADMAP Queue 1 item
5b, done): the cost ledger (``ProgramCostLedger``: per-program flops and
bytes counted on each first call, MFU against ``cli.common``'s peaks,
roofline class, the launch-cost fit) and the step trace window
(``StepTraceWindow``, ``parse_trace_steps``: ``--trace-steps`` on
``torch.profiler``).  ``__all__`` is the JAX package's; ``ProgramCost``
(a ledger row) is importable here as there.
"""

from can_tpu_torch.obs.bus import (
    EVENT_KINDS,
    JsonlSink,
    MetricLoggerSink,
    StdoutSink,
    Telemetry,
    open_host_telemetry,
)
from can_tpu_torch.obs.collector import (
    COLLECTOR_HOST_ID,
    CollectorPushSink,
    FleetCollector,
)
from can_tpu_torch.obs.costs import ProgramCost, ProgramCostLedger
from can_tpu_torch.obs.exporter import (
    GaugeSink,
    MetricsExporter,
    aggregate_fleet,
    render_stats,
)
from can_tpu_torch.obs.flightrec import FlightRecorder
from can_tpu_torch.obs.health import (
    EwmaMadDetector,
    HealthMonitor,
    PlateauDetector,
    ThroughputDetector,
)
from can_tpu_torch.obs.incidents import IncidentManager, install_sigterm_handler
from can_tpu_torch.obs.lifecycle import shutdown_telemetry, supervised_loop
from can_tpu_torch.obs.report import (
    format_report,
    read_events,
    read_events_counted,
    summarize,
)
from can_tpu_torch.obs.slo import (
    SloEngine,
    SloObjective,
    SloSpec,
    grade_events,
    load_slo_spec,
)
from can_tpu_torch.obs.sources import (
    Heartbeat,
    RecompileTracker,
    StallClock,
    device_memory_snapshot,
    emit_memory,
)
from can_tpu_torch.obs.spans import SpanTracer
from can_tpu_torch.obs.trace import StepTraceWindow, parse_trace_steps

__all__ = [
    "COLLECTOR_HOST_ID",
    "CollectorPushSink",
    "EVENT_KINDS",
    "FleetCollector",
    "EwmaMadDetector",
    "FlightRecorder",
    "GaugeSink",
    "Heartbeat",
    "HealthMonitor",
    "IncidentManager",
    "JsonlSink",
    "MetricLoggerSink",
    "MetricsExporter",
    "PlateauDetector",
    "ProgramCostLedger",
    "RecompileTracker",
    "SloEngine",
    "SloObjective",
    "SloSpec",
    "SpanTracer",
    "StallClock",
    "StdoutSink",
    "StepTraceWindow",
    "Telemetry",
    "ThroughputDetector",
    "device_memory_snapshot",
    "emit_memory",
    "aggregate_fleet",
    "format_report",
    "grade_events",
    "install_sigterm_handler",
    "load_slo_spec",
    "open_host_telemetry",
    "parse_trace_steps",
    "read_events",
    "read_events_counted",
    "render_stats",
    "shutdown_telemetry",
    "supervised_loop",
    "summarize",
]
