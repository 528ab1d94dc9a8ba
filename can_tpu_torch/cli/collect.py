"""Fleet collector daemon CLI — the observability plane's aggregation
point (``can_tpu_torch/obs/collector.py``; counterpart of
``can_tpu/cli/collect.py``).

    python -m can_tpu_torch.cli.collect runs/exp1/ --spec slo_spec.json \
        --port 9900 --snapshot-dir runs/exp1-fleet/

One process joins every host's telemetry live — tailing the run dir's
``telemetry.host*.jsonl`` files AND accepting HTTP ``POST /ingest``
batches from remote hosts started with ``--collector-push`` — and
serves:

* ``GET /metrics``   — federated Prometheus text: per-host gauges with
  a ``host`` label, fleet rollups, per-host clock skew, and the GLOBAL
  SLO burn (``can_tpu_slo_burn_global{objective,window_s}``) computed
  by ONE engine over the skew-corrected ts-merged stream;
* ``GET /fleet/status`` — machine-readable fleet liveness + counters;
* silent-host detection ("no data ≠ healthy"): a host whose corrected
  heartbeat goes stale raises a ``fleet.host`` event, an incident
  bundle (with ``--incident-dir``), and a dead-host signal file (with
  ``--emit-signal`` — the same obs/signals.py grammar the elastic
  supervisor polls, so detection drives the fleet's shrink reaction).

``--snapshot-dir`` archives everything ingested plus a ``collector.json``
manifest recording the MEASURED per-host clock offsets; pointing
``tools/slo_report.py`` at that snapshot replays the live global burn
bit-identically, and ``tools/trace_export.py`` renders skew-corrected
cross-host timelines from it.

Pure host-side code, runs on any box that can reach the
run dir or be reached by the pushing hosts.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?", default="",
                   help="directory of telemetry.host*.jsonl to tail "
                        "(optional — push-only fleets omit it)")
    p.add_argument("--spec", default="",
                   help="SLO spec JSON (slo_spec.json) for the global "
                        "burn engine; omit to collect without grading")
    p.add_argument("--listen", default="127.0.0.1",
                   help="bind address (0.0.0.0 for remote pushers)")
    p.add_argument("--port", type=int, default=0,
                   help="HTTP port for /metrics, /fleet/status and "
                        "POST /ingest (0 = ephemeral)")
    p.add_argument("--interval-s", type=float, default=2.0,
                   help="tail-poll / liveness-check interval")
    p.add_argument("--stale-after-s", type=float, default=180.0,
                   help="corrected heartbeat age that marks a host "
                        "stale (~3x the hosts' heartbeat interval)")
    p.add_argument("--snapshot-dir", default="",
                   help="archive ingested telemetry + collector.json "
                        "manifest here (must differ from run_dir); the "
                        "offline-replay artifact for tools/slo_report.py "
                        "and tools/trace_export.py")
    p.add_argument("--incident-dir", default="",
                   help="dump incident bundles here on stale hosts and "
                        "fast global SLO burn (obs/incidents.py)")
    p.add_argument("--emit-signal", metavar="DIR", default="",
                   help="write a dead-host signal file (obs/signals.py "
                        "schema) into DIR when a host goes stale — the "
                        "directory an elastic supervisor polls")
    p.add_argument("--json", action="store_true",
                   help="print the final /fleet/status document as JSON "
                        "on exit (after the drain)")
    args = p.parse_args(argv)

    # import after parsing: --help must not pay for anything
    from can_tpu_torch.obs.collector import FleetCollector
    from can_tpu_torch.obs.slo import load_slo_spec

    spec = None
    if args.spec:
        try:
            spec = load_slo_spec(args.spec)
        except (OSError, ValueError) as e:
            print(f"collect: bad spec: {e}", file=sys.stderr)
            return 2
    try:
        collector = FleetCollector(
            spec, run_dir=args.run_dir, snapshot_dir=args.snapshot_dir,
            stale_after_s=args.stale_after_s,
            signal_dir=args.emit_signal, incident_dir=args.incident_dir,
            host=args.listen, port=args.port,
            poll_interval_s=args.interval_s)
    except ValueError as e:
        print(f"collect: {e}", file=sys.stderr)
        return 2
    collector.start()
    print(f"[collect] /metrics + /fleet/status + POST /ingest on "
          f"http://{collector.host}:{collector.port}"
          + (f", tailing {args.run_dir}" if args.run_dir else "")
          + (f", snapshots -> {args.snapshot_dir}"
             if args.snapshot_dir else ""), flush=True)
    # a supervisor stops the daemon with SIGTERM: that must reach the
    # drain below (watermark release + final snapshot with
    # ``drained: true``), exactly like ^C — not die mid-archive
    rc = 0

    def _on_term(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _on_term)
    try:
        while True:
            time.sleep(3600.0)  # poll/HTTP threads do the work
    except KeyboardInterrupt:
        pass
    except SystemExit as e:
        rc = e.code or 0
    finally:
        collector.close(drain=True)
    if args.json:
        print(json.dumps(collector.status()))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
