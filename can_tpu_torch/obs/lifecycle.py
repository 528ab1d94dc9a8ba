"""Deterministic telemetry teardown and the supervised daemon loop
(counterpart of ``can_tpu/obs/lifecycle.py``, copied whole).

``shutdown_telemetry`` closes a telemetry stack in the one correct
order:

1. **heartbeat** — stop the only background EMITTER first, so nothing
   new enters the bus while it drains.
2. **telemetry.close()** — which itself closes watchers (final SLO
   evaluation lands its last events in the still-open sinks) and THEN
   the sinks.
3. **exporter** — last, so a scraper polling through the shutdown can
   still read the final gauge values the watcher flush just produced.

Idempotent — a double call (signal during teardown) is a no-op.  The
serve CLI tears its ``build_telemetry`` stack down with it;
``supervised_loop`` runs the serving fleet's maintenance thread and the
autoscaler.
"""

from __future__ import annotations


def shutdown_telemetry(telemetry, *, heartbeat=None, exporter=None) -> None:
    """Close a ``build_telemetry`` stack in the documented order.  Every
    argument may be None; every step is individually guarded so one
    failing close cannot leak the others."""
    for step in (
        (lambda: heartbeat.close()) if heartbeat is not None else None,
        (lambda: telemetry.close()) if telemetry is not None else None,
        (lambda: exporter.close()) if exporter is not None else None,
    ):
        if step is None:
            continue
        try:
            step()
        except Exception as e:  # noqa: BLE001 — teardown must finish
            print(f"[telemetry] teardown step failed "
                  f"({type(e).__name__}: {e}); continuing", flush=True)


def supervised_loop(stop, interval_s: float, tick, label: str) -> None:
    """The daemon-supervisor loop body shared by the fleet maintenance
    thread and the autoscaler: ``tick()`` every ``interval_s`` until
    ``stop`` (a ``threading.Event``) is set, surviving any single sick
    tick under the sink contract — warn once per FAILURE STREAK (a
    recovery re-arms the warning), never kill the loop."""
    warned = False
    while not stop.wait(interval_s):
        try:
            tick()
            warned = False
        except Exception as e:  # noqa: BLE001 — the supervisor must
            # outlive any single sick tick
            if not warned:
                warned = True
                print(f"[{label}] tick failed ({type(e).__name__}: {e});"
                      f" kept — will retry next interval", flush=True)
