"""Cross-stack span tracing: trace_id/span trees on the telemetry bus.

Counterpart of ``can_tpu/obs/spans.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The latency percentiles (serve) and step windows (train) say HOW LONG;
nothing says WHERE the milliseconds went for one request or one step
window.  Spans close that gap with the smallest possible mechanism: each
span is one ``trace.span`` event on the existing bus —

    payload: {trace_id, span_id, parent_id, name, start_s, duration_s,
              ...attrs}

— so spans inherit the bus's sinks, per-host files, crash semantics, and
report tooling, and ``tools/trace_export.py`` converts them to
Chrome/Perfetto trace-event JSON offline.

Clock discipline: ``start_s`` is in the EMITTER's clock (the serve path
uses the service's monotonic clock so fake-clock tests stay
deterministic; the train loop uses ``time.perf_counter`` stamps it
already takes).  All spans of one run share a base, which is all the
export needs — it normalises to the file's earliest span.  Parents may be
emitted after their children (a root span's duration isn't known until it
ends); consumers must not assume emission order.

The tracer is armed exactly like the ledger: ``Telemetry.spans`` is None
unless a CLI consumer exists, and every producer guards with
``getattr(telemetry, "spans", None)`` — zero cost on default runs.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional


class SpanTracer:
    """Mints ids and emits ``trace.span`` events.

    Ids carry the pid plus a short random tag so traces from several
    hosts/processes joined into one artifact can't collide — pid alone
    is not enough: two containerised replicas typically BOTH run as
    pid 1.  The per-process counter keeps ids cheap within a run.
    Thread-safe: ``itertools.count`` is atomic under CPython, and
    emission goes through the bus's own lock.
    """

    def __init__(self, telemetry, *, prefix: Optional[str] = None):
        self._tel = telemetry
        self.prefix = (prefix if prefix is not None
                       else f"{os.getpid():x}{os.urandom(2).hex()}")
        self._ids = itertools.count(1)

    def new_trace_id(self, hint: str = "") -> str:
        tag = f"{hint}-" if hint else ""
        return f"{tag}{self.prefix}-{next(self._ids):x}"

    def new_span_id(self) -> str:
        return f"s{self.prefix}-{next(self._ids):x}"

    def emit(self, *, trace_id: str, name: str, start: float, end: float,
             span_id: Optional[str] = None, parent_id: Optional[str] = None,
             step: Optional[int] = None, **attrs) -> str:
        """Emit one completed span; returns its span_id (pre-mint with
        ``new_span_id()`` to emit children before their parent)."""
        sid = span_id if span_id is not None else self.new_span_id()
        self._tel.emit("trace.span", step=step, trace_id=trace_id,
                       span_id=sid, parent_id=parent_id, name=name,
                       start_s=round(float(start), 6),
                       duration_s=round(max(float(end) - float(start),
                                            0.0), 6),
                       **attrs)
        return sid
