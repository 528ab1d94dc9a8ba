"""The port's exporter, join and fleet collector (``can_tpu_torch/obs/
exporter.py``, ``join.py``, ``collector.py``) and ``python -m
can_tpu_torch.cli.collect`` against the JAX package's on the CPU.

Compared exactly, on the shared event script (``test_torch_obs``) and
one fake clock: the Prometheus text and snapshot of one ``GaugeSink``;
``render_stats`` / ``aggregate_fleet``; the exporter's ``/metrics``,
``/healthz`` and 404 over loopback (port 0); the multi-host join
(discovery, offsets, the ts-merge, the incremental tail); a
``FleetCollector`` driven through three hosts — one tailed, one pushed
with a +120 s clock, one that goes silent — its status, federated
metrics, grade, snapshot manifest, ``fleet.jsonl``, dead-host signal and
incident bundle.  Over loopback, the port's ``CollectorPushSink`` feeds
the port's collector and the JAX package's, and the two CLIs, run on one
run dir and stopped with SIGTERM, drain to the same snapshot.  Every
server binds port 0 and is closed in ``finally``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_obs import PKGS, ROOT, T0, FakeClock, drive, event_script

from can_tpu.obs import collector as jcol
from can_tpu.obs import exporter as jexp
from can_tpu.obs import join as jjoin
from can_tpu_torch.obs import collector as tcol
from can_tpu_torch.obs import exporter as texp
from can_tpu_torch.obs import join as tjoin

COL = {"jax": jcol, "port": tcol}
EXP = {"jax": jexp, "port": texp}
JOIN = {"jax": jjoin, "port": tjoin}
SPEC = str(ROOT / "slo_spec.json")
PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (-?[0-9.e+E-]+|NaN|[+-]Inf)$")


def _ev(ts, kind, hid, **payload):
    return {"ts": ts, "kind": kind, "step": None, "host_id": hid, "payload": payload}


def _jsonl(events) -> bytes:
    return ("\n".join(json.dumps(e) for e in events) + "\n").encode()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, "", ""


def _prometheus(text):
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert PROM_LINE.match(line), line


# -- exporter ------------------------------------------------------------------
def _gauges(pkg, seed=31):
    g = pkg.GaugeSink()
    drive(pkg, [g], event_script(seed))
    return g


def test_gauge_sink_prometheus_text_equal():
    got = {name: (g.render(), g.snapshot(), g.alerts_total())
           for name, g in ((n, _gauges(p)) for n, p in PKGS.items())}
    assert got["port"] == got["jax"]
    text = got["port"][0]
    _prometheus(text)
    for name in ("can_tpu_events_total", "can_tpu_fleet_generation",
                 "can_tpu_stream_degraded_total"):
        assert name in text, name


def _stats():
    rng = np.random.default_rng(32)
    return {"submitted": 48, "completed": 48, "rejected": 0, "degraded": 0,
            "batches": 12, "queue_depth": 0, "shedding": False,
            "latency_p50_s": float(rng.uniform(0.01, 0.02)),
            "latency_p99_s": float(rng.uniform(0.02, 0.05)),
            "rejects": {"deadline": 0, "queue_full": 0},
            "sched": {"menu": [8, 3, 1], "cost_mismatches": 0},
            "replicas": [{"replica": 0, "state": "active", "batches": 6},
                         {"replica": 1, "state": "quarantined", "batches": 2}],
            "streams": {"active": 1}, "name": "text is skipped"}


def test_render_stats_and_aggregate_fleet_equal():
    got = {}
    for name, pkg in PKGS.items():
        snaps = {h: _gauges(pkg, 40 + h).snapshot() for h in range(3)}
        got[name] = (pkg.render_stats(_stats()),
                     pkg.render_stats(_stats(), prefix="can_tpu_x"),
                     pkg.aggregate_fleet(snaps))
    assert got["port"] == got["jax"]
    _prometheus(got["port"][0])
    assert "can_tpu_serve_completed_total 48" in got["port"][0]


def test_metrics_exporter_endpoints_equal_over_loopback():
    got = {}
    for name, pkg in PKGS.items():
        exporter = pkg.MetricsExporter(_gauges(pkg), host="127.0.0.1", port=0)
        exporter.add_stats_source("serve", _stats)
        exporter.start()
        try:
            assert exporter.port > 0
            metrics = _get(exporter.port, "/metrics")
            health = _get(exporter.port, "/healthz")
            got[name] = (metrics, (health[0], json.loads(health[1])),
                         _get(exporter.port, "/nope")[0])
        finally:
            exporter.close()
    assert got["port"] == got["jax"]
    (code, text, ctype), _, missing = got["port"]
    assert code == 200 and ctype.startswith("text/plain") and missing == 404
    _prometheus(text)


def test_metrics_exporter_port_in_use_raises():
    """``--metrics-port`` that cannot bind is an error, never a silent
    run without metrics."""
    first = texp.MetricsExporter(texp.GaugeSink(), port=0).start()
    try:
        with pytest.raises(OSError):
            texp.MetricsExporter(texp.GaugeSink(), port=first.port).start()
    finally:
        first.close()


# -- join ----------------------------------------------------------------------
def _write_hosts(run_dir, skews=(0.0, 120.0, -3.0)):
    """The shared script split over three host files, each on its own
    clock (``skews``), with a torn line in host 1's."""
    run_dir.mkdir(parents=True, exist_ok=True)
    script = event_script(33, n=300)
    for h, skew in enumerate(skews):
        with open(run_dir / f"telemetry.host{h}.jsonl", "w") as f:
            for i, (ts, kind, step, p) in enumerate(script):
                if i % 3 == h or kind == "heartbeat" or i % 20 == 0:
                    f.write(json.dumps({"ts": ts + skew, "kind": kind, "step": step,
                                        "host_id": h, "payload": p}) + "\n")
                if h == 1 and i == 50:
                    f.write('{"ts": 1, "kind": "tor\n')
    return script


def test_join_equal(tmp_path):
    run_dir = tmp_path / "run"
    _write_hosts(run_dir)
    got = {}
    for name, mod in JOIN.items():
        files = mod.discover_host_files(str(run_dir))
        by_host, torn = mod.read_host_events(files)
        firsts = {h: mod.first_heartbeat_ts(evs) for h, evs in by_host.items()}
        offsets = mod.estimate_offsets(firsts)
        joined = mod.join_events({h: mod.apply_offsets(evs, offsets[h])
                                  for h, evs in by_host.items()})
        tail = mod.HostTail(files[1])
        tail.poll()
        first = tail.drain()
        tail.poll()
        got[name] = ({h: os.path.basename(p) for h, p in files.items()}, torn,
                     firsts, offsets, joined,
                     mod.load_joined_events(str(run_dir), estimate=True),
                     (first, tail.drain(), tail.skipped),
                     mod.resolve_telemetry_source(str(run_dir))[1],
                     mod.snap_offset(119.7), mod.corrected_staleness(T0, 120.0, T0 + 200))
    assert got["port"] == got["jax"]
    assert got["port"][3][1] == 120.0 and got["port"][6][2] == 1


# -- the collector ---------------------------------------------------------------
def _three_hosts(mod, tmp):
    """The reference's three-host scenario on a fake clock: host 0 tailed
    from the run dir, host 1 pushed with a clock +120 s fast, host 2
    pushed and silent after t = 1050."""
    run_dir = tmp / "run"
    run_dir.mkdir(parents=True)
    clock = FakeClock(1000.0)
    spec = PKGS_BY_MOD[mod].load_slo_spec(SPEC)
    col = mod.FleetCollector(spec, run_dir=str(run_dir), snapshot_dir=str(tmp / "snap"),
                             stale_after_s=40.0, signal_dir=str(tmp / "sig"),
                             incident_dir=str(tmp / "inc"), clock=clock)
    rng = np.random.default_rng(34)
    with open(run_dir / "telemetry.host0.jsonl", "a") as f0:
        for k, ti in enumerate(range(1000, 1101, 10)):
            t = float(ti)
            clock.t = t
            lat = [float(x) for x in rng.choice([0.02, 3.0], 3, p=[0.6, 0.4])]
            f0.write(json.dumps(_ev(ti, "heartbeat", 0, seq=k, start_ts=1000)) + "\n")
            f0.write(json.dumps(_ev(ti, "serve.request", 0, latency_s=lat[0])) + "\n")
            if k == 4:
                f0.write('{"ts": 1040, "kind": "hea\n')
            f0.flush()
            col.ingest_push(_jsonl([
                _ev(t + 120.0, "heartbeat", 1, seq=k, start_ts=1120.0),
                _ev(t + 121.0, "serve.request", 1, latency_s=lat[1])]))
            if t <= 1050.0:
                body = _jsonl([_ev(t, "heartbeat", 2, seq=k, start_ts=1000.0),
                               _ev(t + 0.5, "serve.request", 2, latency_s=lat[2])])
                if k == 2:
                    body += b"garbage push line\n"
                col.ingest_push(body)
            col.poll(now=t)
    col.drain(now=1100.0)
    return col


PKGS_BY_MOD = {jcol: PKGS["jax"], tcol: PKGS["port"]}


def _normalise(text, tmp):
    return text.replace(str(tmp), "<tmp>")


def test_fleet_collector_three_hosts_equal(tmp_path):
    got = {}
    for name, mod in COL.items():
        tmp = tmp_path / name
        col = _three_hosts(mod, tmp)
        manifest = JOIN[name].load_collector_manifest(str(tmp / "snap"))
        bundles = sorted(os.listdir(tmp / "inc"))
        inc = PKGS[name]
        mans = [inc.incidents.read_manifest(str(tmp / "inc" / b)) for b in bundles]
        for m in mans:
            m.pop("pid")
        sigs = inc.signals.read_signals(str(tmp / "sig")) if hasattr(inc, "signals") \
            else None
        fleet = (tmp / "snap" / "fleet.jsonl").read_text()
        got[name] = json.loads(_normalise(json.dumps(
            [col.status(), col.render_metrics(), col.grade(), manifest, bundles,
             mans, sigs, fleet, sorted(os.listdir(tmp / "snap"))]), tmp))
    assert got["port"] == got["jax"]
    status, metrics, grade, manifest = got["port"][:4]
    assert manifest["drained"] and manifest["hosts"]["1"]["clock_offset_s"] == 120.0
    assert manifest["hosts"]["2"]["state"] == "stale"
    assert got["port"][4] and grade["violations"]
    _prometheus(metrics)
    assert tcol.COLLECTOR_HOST_ID == jcol.COLLECTOR_HOST_ID


def test_push_sink_feeds_either_collector_over_loopback():
    """The port's push sink delivers to the port's collector and to the
    JAX package's (one wire format), and survives a collector that is
    not there."""
    for mod in COL.values():
        col = mod.FleetCollector(poll_interval_s=3600.0).start()
        try:
            sink = tcol.CollectorPushSink(f"127.0.0.1:{col.port}/", flush_interval_s=0.02)
            assert sink.url == f"http://127.0.0.1:{col.port}"
            tel = PKGS["port"].Telemetry([sink], host_id=5)
            for i in range(20):
                tel.emit("heartbeat", seq=i)
            tel.close()
            assert sink.pushed_events == 20 and sink.dropped == 0
            assert col.status()["hosts"]["5"]["events"] == 20
            code, text, _ = _get(col.port, "/metrics")
            assert code == 200 and 'can_tpu_collector_events_total{host="5"} 20.0' in text
        finally:
            col.close()
    down = tcol.CollectorPushSink("127.0.0.1:9", timeout_s=0.2, flush_interval_s=0.02)
    tel = PKGS["port"].Telemetry([down])
    tel.emit("heartbeat", seq=0)
    tel.close()
    assert down.pushed_events == 0 and down.push_failures >= 1


def test_collect_cli_refusals_equal(tmp_path, capsys):
    from can_tpu.cli.collect import main as jmain
    from can_tpu_torch.cli.collect import main as tmain

    bad = tmp_path / "spec.json"
    bad.write_text("{")
    for argv in ([str(tmp_path), "--spec", str(bad)],
                 [str(tmp_path), "--snapshot-dir", str(tmp_path)]):
        codes = [jmain(argv), tmain(argv)]
        err = capsys.readouterr().err.splitlines()
        assert codes == [2, 2] and err[0] == err[1], err


def test_collect_cli_sigterm_drains_to_the_references_snapshot(tmp_path):
    """Both CLIs tail one run dir and are stopped with SIGTERM: each exits
    143 after draining, and their snapshots agree (the manifest minus its
    wall-clock stamps, the archived host files, the final status)."""
    run = tmp_path / "run"
    _write_hosts(run)
    procs = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for name, pkg in (("jax", "can_tpu"), ("port", "can_tpu_torch")):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli.collect", str(run), "--spec", SPEC,
             "--snapshot-dir", str(tmp_path / f"snap-{name}"), "--interval-s", "0.05",
             "--stale-after-s", "1e12", "--json"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    got = {}
    try:
        for name, p in procs.items():
            snap = tmp_path / f"snap-{name}"
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                m = JOIN[name].load_collector_manifest(str(snap))
                if m and all(m["hosts"].get(str(h), {}).get("events") for h in range(3)):
                    break
                time.sleep(0.05)
            else:
                pytest.fail(f"{name} collector never snapshotted the hosts")
            p.send_signal(signal.SIGTERM)
            out, _ = p.communicate(timeout=60)
            assert p.returncode == 143, out
            assert out.splitlines()[0].startswith("[collect] /metrics + /fleet/status")
            status = json.loads(out.strip().splitlines()[-1])
            m = JOIN[name].load_collector_manifest(str(snap))
            assert m["drained"] is True
            for doc in (m, status):
                for k in list(doc):
                    if k == "ts" or k.endswith("_ts") or k in ("uptime_s", "now"):
                        doc.pop(k)
                # each host's age and provisional clock offset are read
                # against the collector's wall clock
                for h in doc.get("hosts", {}).values():
                    for k in ("staleness_s", "clock_offset_s", "offset_frozen",
                              "skew_samples"):
                        h.pop(k, None)
            archived = {f: (snap / f).read_text() for f in sorted(os.listdir(snap))
                        if f.startswith("telemetry.host")}
            got[name] = json.loads(_normalise(json.dumps([m, archived]), tmp_path))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert got["port"] == got["jax"]
