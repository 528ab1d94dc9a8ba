"""The port's incident layer (``can_tpu_torch/obs/incidents.py``) and the
CLI wiring that arms it (``can_tpu_torch/cli/train.py``
``validate_incident_args`` / ``build_telemetry``) against the JAX
package's on the CPU.

Both stacks (flight recorder + gauge sink + SLO engine + incident
manager, as ``build_telemetry`` arms them) watch the shared event script
(``test_torch_obs.event_script``: replica quarantines, slo burns) on one
fake clock, with an injected nan alert, an exception and a signal.  The
bundles are compared exactly — directory names, file lists, rings,
gauges, manifests — minus the process id, the bundle path, the memory
snapshot (a device read) and the thread stacks; ``incident.bundle``
events minus their path.  Rate limiting, retention, the signal hook and
the bundle readers behave as the reference's.  ``build_telemetry`` arms
the same collaborators from the same flags (the cost ledger and the span
tracer together, under the same rule), and ``validate_incident_args``
refuses bad flags with the reference's messages.  ``tools/trace_export.py``
reads the port's bundle ring.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from test_torch_obs import PKGS, ROOT, T0, FakeClock, drive, event_script

from can_tpu.obs import incidents as jinc
from can_tpu_torch.obs import incidents as tinc

INC = {"jax": jinc, "port": tinc}
SPEC = str(ROOT / "slo_spec.json")


def _stack(pkg, tmp, clock, **kw):
    """The collaborators ``build_telemetry`` arms for --incident-dir and
    --slo-spec, on ``clock``."""
    rec = pkg.FlightRecorder()
    gauges = pkg.GaugeSink()
    tel = pkg.Telemetry([rec, gauges, pkg.JsonlSink(str(tmp / "t.jsonl"))],
                        clock=clock)
    mgr = pkg.IncidentManager(tel, rec, incident_dir=str(tmp / "inc"),
                              gauges=gauges, run_config={"seed": 0},
                              clock=clock, **kw)
    tel.watchers.append(pkg.SloEngine(pkg.load_slo_spec(SPEC), tel))
    tel.watchers.append(mgr)
    tel.incidents = mgr
    return tel, mgr


def _bundles(inc_dir, mod):
    """Each bundle's comparable content, in name order."""
    out = []
    for name in sorted(os.listdir(inc_dir)):
        path = os.path.join(inc_dir, name)
        man = mod.read_manifest(path)
        assert man is not None and mod.is_bundle_dir(path)
        assert man.pop("pid") == os.getpid()
        assert "memory.json" in man["files"] and "stacks.txt" in man["files"]
        mem = json.load(open(os.path.join(path, "memory.json")))
        assert set(mem) == {"devices", "host_rss_mb"}
        with open(mod.bundle_ring_path(path)) as f:
            ring = f.read().replace(str(inc_dir), "<incident-dir>")
        gauges = json.load(open(os.path.join(path, "gauges.json")))
        out.append((name, man, ring, gauges))
    return out


def _script_events(tel, clock, script):
    for ts, kind, step, payload in script:
        clock.t = ts
        tel.emit(kind, step=step, **payload)


def test_bundles_equal_on_one_script(tmp_path):
    script = event_script(21)
    got = {}
    for name, pkg in PKGS.items():
        tmp = tmp_path / name
        clock = FakeClock()
        tel, mgr = _stack(pkg, tmp, clock, rate_limit_s=90.0, max_bundles=6)
        _script_events(tel, clock, script[:300])
        clock.t += 1
        tel.emit("health.alert", signal="loss", alert="nan", value=float("nan"),
                 epoch=3)
        _script_events(tel, clock, script[300:])
        clock.t += 1
        try:
            raise RuntimeError("injected loop failure")
        except RuntimeError as e:
            mgr.on_exception(e, epoch=9, step=1234)
        clock.t += 1
        mgr.on_signal(signal.SIGTERM)
        tel.close()
        events = [json.loads(x) for x in open(tmp / "t.jsonl")]
        incidents = [e for e in events if e["kind"] == "incident.bundle"]
        for e in incidents:  # retention has deleted the oldest
            path = e["payload"].pop("path")
            assert os.path.dirname(path) == str(tmp / "inc")
        got[name] = (_bundles(tmp / "inc", INC[name]), incidents,
                     mgr.bundles_written, mgr._suppressed)
    assert got["port"] == got["jax"]
    bundles, incidents, written, suppressed = got["port"]
    assert {b[1]["reason"] for b in bundles} >= {"exception", "signal_sigterm"}
    assert {e["payload"]["reason"] for e in incidents} >= {
        "health_nan", "fleet_quarantine", "slo_serve_p99_deadline"}
    assert written > len(bundles)  # retention deleted the oldest
    assert len(bundles) == 6 and suppressed


def test_trigger_reasons_and_rate_limit_equal(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        clock = FakeClock()
        tel, mgr = _stack(pkg, tmp_path / name, clock, rate_limit_s=60.0)
        seq = [("fleet.replica", {"replica": 0, "state": "quarantined"}),
               ("fleet.replica", {"replica": 1, "state": "quarantined"}),
               ("fleet.replica", {"replica": 1, "state": "active"}),
               ("fleet.host", {"host": 2, "state": "stale"}),
               ("health.alert", {"alert": "spike"}),
               ("health.alert", {"alert": "stall_budget"}),
               ("slo.burn", {"objective": "x", "alerting": True}),
               ("incident.bundle", {"reason": "loop"})]
        paths = []
        for i, (kind, payload) in enumerate(seq * 2):
            clock.t = T0 + 40 * i
            tel.emit(kind, **payload)
        paths.append(mgr.trigger("fleet_probe_failed", detail={"replica": 0}))
        paths.append(mgr.trigger("fleet_probe_failed", detail={"replica": 0}))
        tel.close()
        names = sorted(os.listdir(tmp_path / name / "inc"))
        got[name] = (names, dict(mgr._suppressed), [p is None for p in paths])
    assert got["port"] == got["jax"]
    assert got["port"][2] == [False, True]


def test_signal_hook_chains_and_restores():
    """On the main thread the hook dumps a bundle, then chains to the
    previous handler; ``restore`` puts the table back.  Off the main
    thread it installs nothing and returns None."""
    import tempfile

    got = {}
    for name, pkg in PKGS.items():
        calls = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: calls.append(s))
        try:
            with tempfile.TemporaryDirectory() as d:
                tel = pkg.Telemetry([], clock=FakeClock())
                mgr = pkg.IncidentManager(tel, incident_dir=d, clock=FakeClock())
                restore = pkg.install_sigterm_handler(mgr, signums=(signal.SIGUSR1,))
                signal.raise_signal(signal.SIGUSR1)
                names = [n.split("-", 3)[-1] for n in sorted(os.listdir(d))]
                restore()
                after = signal.getsignal(signal.SIGUSR1)
                off = []
                t = threading.Thread(target=lambda: off.append(
                    pkg.install_sigterm_handler(mgr, signums=(signal.SIGUSR1,))))
                t.start()
                t.join(timeout=5)
                got[name] = (names, calls, off)
                assert after is not None and after != signal.SIG_DFL
        finally:
            signal.signal(signal.SIGUSR1, prev)
    assert got["port"] == got["jax"]
    assert got["port"] == (["signal-sigusr1"], [signal.SIGUSR1], [None])


def test_bundle_readers_equal(tmp_path):
    torn = tmp_path / "incident-0000000000001-h0-torn"
    torn.mkdir()
    bare = tmp_path / "incident-0000000000002-h0-bare"
    bare.mkdir()
    (bare / "incident.json").write_text(json.dumps({"schema": jinc.BUNDLE_SCHEMA}))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "incident.json").write_text("[1, 2")
    for mod in INC.values():
        assert mod.read_manifest(str(torn)) is None and not mod.is_bundle_dir(str(torn))
        assert mod.read_manifest(str(tmp_path / "bad")) is None
        assert mod.read_manifest(str(bare)) == {"schema": jinc.BUNDLE_SCHEMA}
        with pytest.raises(ValueError, match="has no ring.jsonl"):
            mod.bundle_ring_path(str(bare))
    assert (tinc.BUNDLE_SCHEMA, tinc.MANIFEST_NAME, tinc.RING_NAME,
            tinc.TRIGGER_ALERTS) == (jinc.BUNDLE_SCHEMA, jinc.MANIFEST_NAME,
                                     jinc.RING_NAME, jinc.TRIGGER_ALERTS)


def test_trace_export_reads_the_ports_bundle(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        clock = FakeClock()
        tel, mgr = _stack(pkg, tmp_path / name, clock)
        spans = pkg.SpanTracer(tel, prefix="p")
        root = spans.new_span_id()
        spans.emit(trace_id="t1", name="device", start=1.2, end=1.5, parent_id=root)
        spans.emit(trace_id="t1", name="request", start=1.0, end=2.0, span_id=root)
        path = mgr.trigger("manual")
        tel.close()
        r = subprocess.run([sys.executable, "tools/trace_export.py", path,
                            "--out", str(tmp_path / f"{name}.json")], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        out[name] = json.load(open(tmp_path / f"{name}.json"))
    assert out["port"] == out["jax"]


# -- the CLI wiring ---------------------------------------------------------------
def _args(tmp_path, **over):
    ns = argparse.Namespace(
        telemetry_dir="", telemetry_heartbeat_s=0.05, collector_push="",
        metrics_port=None, metrics_host="127.0.0.1", bf16=False,
        incident_dir="", slo_spec="")
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _build(pkg_name, args, **kw):
    if pkg_name == "jax":
        from can_tpu.cli.train import build_telemetry
        return build_telemetry(args, host_id=0, trace_window=None, **kw)
    from can_tpu_torch.cli.train import build_telemetry
    return build_telemetry(args, host_id=0, trace_window=None, device="cpu", **kw)


def _shape(tel, hb, exporter):
    return {"sinks": sorted(type(s).__name__ for s in tel._sinks),
            "watchers": sorted(type(w).__name__ for w in tel.watchers),
            "incidents": tel.incidents is not None, "spans": tel.spans is not None,
            "gauges": tel._gauge_sink is not None, "heartbeat": hb is not None,
            "exporter": exporter is not None}


@pytest.mark.parametrize("flags", [
    {}, {"telemetry_dir": "tel"}, {"incident_dir": "inc"},
    {"slo_spec": SPEC}, {"metrics_port": 0},
    {"telemetry_dir": "tel", "incident_dir": "inc", "slo_spec": SPEC,
     "metrics_port": 0}])
def test_build_telemetry_arms_the_references_stack(tmp_path, flags, monkeypatch):
    monkeypatch.delenv("CAN_TPU_HOST_ID", raising=False)
    got = {}
    for name, pkg in PKGS.items():
        over = {k: (str(tmp_path / name / v) if k.endswith("_dir") else v)
                for k, v in flags.items()}
        args = _args(tmp_path, **over)
        prev = signal.getsignal(signal.SIGTERM)
        tel, hb, exporter = _build(name, args, install_signals=False)
        try:
            assert signal.getsignal(signal.SIGTERM) == prev
            shape = _shape(tel, hb, exporter)
            assert (tel.ledger is not None) == shape["spans"]
        finally:
            pkg.shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
        run = None
        if flags.get("telemetry_dir"):
            (run,) = [json.loads(x) for x in open(
                tmp_path / name / "tel" / "telemetry.host0.jsonl")
                if '"kind": "run"' in x]
            cfg = run["payload"]["config"]
            cfg.update({k: "<dir>" for k in cfg if k.endswith("_dir") and cfg[k]})
            run = (run["kind"], run["host_id"], cfg)
        got[name] = (shape, run)
    assert got["port"] == got["jax"]


def test_build_telemetry_installs_the_sigterm_hook_and_host_id(tmp_path, monkeypatch):
    monkeypatch.setenv("CAN_TPU_HOST_ID", "5")
    prev = signal.getsignal(signal.SIGTERM)
    args = _args(tmp_path, incident_dir=str(tmp_path / "inc"),
                 telemetry_dir=str(tmp_path / "tel"))
    from can_tpu_torch.obs import shutdown_telemetry

    tel, hb, exporter = _build("port", args)
    try:
        assert tel.host_id == 5 and tel.incidents.host_id == 5
        assert signal.getsignal(signal.SIGTERM) != prev
    finally:
        shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert os.listdir(tmp_path / "tel") == ["telemetry.host5.jsonl"]
    monkeypatch.setenv("CAN_TPU_HOST_ID", "x")
    with pytest.raises(SystemExit, match="CAN_TPU_HOST_ID: not an int"):
        _build("port", args)


def test_validate_incident_args_messages_equal(tmp_path):
    from can_tpu.cli.train import validate_incident_args as jval
    from can_tpu_torch.cli.train import validate_incident_args as tval

    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 1, "objectives": []}')
    torn = tmp_path / "torn.json"
    torn.write_text('{"version": ')
    blocker = tmp_path / "file"
    blocker.write_text("x")
    cases = [{"slo_spec": str(tmp_path / "missing.json")}, {"slo_spec": str(bad)},
             {"slo_spec": str(torn)}, {"incident_dir": str(blocker / "inc")}]
    for over in cases:
        msgs = []
        for val in (jval, tval):
            with pytest.raises(SystemExit) as e:
                val(_args(tmp_path, **over))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    ok = _args(tmp_path, slo_spec=SPEC, incident_dir=str(tmp_path / "new" / "inc"))
    tval(ok)
    assert ok._slo_spec_parsed.objectives and (tmp_path / "new" / "inc").is_dir()
