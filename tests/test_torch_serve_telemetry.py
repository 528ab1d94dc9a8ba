"""Telemetry on the port's serving path (the serve CLI's seven obs flags,
``build_telemetry``, request and rollout spans, incident bundles, the SLO
gauges that feed the autoscaler) against the JAX package's on the CPU.

The port's ``CountService`` built by its serve CLI (``parse_args`` ->
``validate_incident_args`` -> ``build_telemetry`` -> ``build_service``)
and the JAX package's, built the same way from the same flags, serve one
He-scaled weight set at one 64x64 bucket to one seeded request script,
each request alone (so both cut the same batches).  Compared: the event
kinds and their counts and payload keys (heartbeats, whose count follows
the wall clock, by presence), the request span trees (a ``request`` root
per request with its four children, inside the root's window), the
metric names and label sets of ``/metrics`` (the bus gauges and the
``/stats`` source) and the counts — f32, rel 1e-4 (the serve tolerance:
both engines sum the same f32 density map in different orders).
``tools/telemetry_report.py`` and ``tools/slo_report.py`` read the port's
JSONL.  The cost ledger rides the same flags: ``perf.summary`` at the JAX
service's points, each ``compile`` event with its flops and bytes, the
``can_tpu_mfu_*`` gauges on ``/metrics``; ``perf_summary_every`` sets the
period between them.

The port alone, on a two-replica fleet of CPU slots: a seeded
``replica_crash`` writes exactly one ``fleet_quarantine`` bundle (the
ring holds the quarantine, ``serve_stats`` shows it) and loses no
request; a rollout emits the reference's spans (``rollout.staging``, one
``rollout.flip_r{i}`` per replica, ``rollout``); a spec whose p99 bound
lies under the measured latency fires ``slo.burn``, whose
``can_tpu_slo_alerting`` gauge makes the autoscaler add a replica with
reason ``autoscale:slo_burn``.  The CLI: its flags are the JAX CLI's but
``--compile-cache``, with the same defaults; a malformed spec or an
unbindable ``--metrics-port`` fails before any weight loads.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

import jax

from test_torch_obs import ROOT

from can_tpu_torch.obs import shutdown_telemetry
from can_tpu_torch.serve import CountService, FleetEngine, prepare_image
from can_tpu_torch.testing import faults
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from tests.test_torch_model import jax_params

SPEC = str(ROOT / "slo_spec.json")
N_REQ = 8
COUNT_RTOL = 1e-4  # f32 serve tolerance
OBS_FLAGS = ("--telemetry-dir", "--telemetry-heartbeat-s", "--metrics-port",
             "--metrics-host", "--collector-push", "--incident-dir", "--slo-spec")


@pytest.fixture(scope="module")
def he_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "he.pth"
    sd = state_dict_from_jax_params(jax_params("he"))
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    return str(path)


def _images():
    rng = np.random.default_rng(51)
    sizes = [(64, 64), (56, 48), (64, 40), (48, 64)]
    return [rng.integers(0, 256, (*sizes[i % 4], 3), dtype=np.uint8)
            for i in range(N_REQ)]


def _argv(pth, tmp, extra=()):
    return ["--torch-pth", pth, "--platform", "cpu", "--bucket-shapes", "64x64",
            "--max-batch", "2", "--telemetry-dir", str(tmp / "tel"),
            "--metrics-port", "0", "--slo-spec", SPEC,
            "--incident-dir", str(tmp / "inc"), "--telemetry-heartbeat-s", "0.05",
            *extra]


def _serve(pkg, pth, tmp):
    """Build ``pkg``'s CLI stack, serve the script; returns counts, the
    JSONL events, the /metrics text and /stats."""
    if pkg == "jax":
        from can_tpu.cli import serve as cli
        from can_tpu.cli.train import build_telemetry, validate_incident_args
        from can_tpu.obs import shutdown_telemetry as shutdown
        from can_tpu.serve import prepare_image as prep
    else:
        from can_tpu_torch.cli import serve as cli
        from can_tpu_torch.cli.train import build_telemetry, validate_incident_args
        shutdown, prep = shutdown_telemetry, prepare_image
    args = cli.parse_args(_argv(pth, tmp))
    validate_incident_args(args)
    tel, hb, exporter = build_telemetry(args, host_id=0, install_signals=False,
                                        trace_window=None)
    try:
        service = cli.build_service(args, telemetry=tel)
        exporter.add_stats_source("serve", service.stats)
        with service:
            counts = [service.predict(prep(img), timeout=120).count
                      for img in _images()]
            time.sleep(0.12)  # a heartbeat past the traffic
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/metrics", timeout=10) as r:
                metrics = r.read().decode()
            stats = service.stats()
        # after the close: its perf.summary carries the traffic's timings
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics", timeout=10) as r:
            closed_metrics = r.read().decode()
    finally:
        shutdown(tel, heartbeat=hb, exporter=exporter)
    with open(tmp / "tel" / "telemetry.host0.jsonl") as f:
        events = [json.loads(x) for x in f]
    return {"counts": np.array(counts), "events": events, "metrics": metrics,
            "closed_metrics": closed_metrics, "stats": stats, "tel": tmp / "tel"}


@pytest.fixture(scope="module")
def served(he_pth, tmp_path_factory):
    return {pkg: _serve(pkg, he_pth, tmp_path_factory.mktemp(pkg))
            for pkg in ("jax", "port")}


# kinds whose count follows the wall clock (heartbeats; slo.burn, one per
# eval interval of the bus clock)
CLOCKED = ("heartbeat", "slo.burn")


def _kinds(events):
    c = Counter(e["kind"] for e in events)
    for k in CLOCKED:
        c[k] = min(c[k], 1)
    return c


def _keys(events):
    out = {}
    for e in events:
        k = e["kind"] if e["kind"] != "trace.span" else f"span:{e['payload']['name']}"
        out.setdefault(k, set()).update(set(e["payload"]))
    return {k: sorted(v) for k, v in out.items()}


def _span_trees(events):
    spans = [e["payload"] for e in events if e["kind"] == "trace.span"]
    roots = {s["span_id"]: s for s in spans if s["name"] == "request"}
    trees = []
    for sid, root in roots.items():
        kids = [s for s in spans if s["parent_id"] == sid]
        for k in kids:  # inside the root's window (the 6-digit rounding aside)
            assert k["start_s"] >= root["start_s"] - 2e-6, (k, root)
            assert (k["start_s"] + k["duration_s"]
                    <= root["start_s"] + root["duration_s"] + 2e-6), (k, root)
            assert k["trace_id"] == root["trace_id"]
        trees.append(sorted(k["name"] for k in kids))
    return sorted(trees)


def test_counts_match_the_jax_service(served):
    got, want = served["port"]["counts"], served["jax"]["counts"]
    assert np.abs(want).max() > 1.0  # He-scaled weights: real counts
    np.testing.assert_allclose(got, want, rtol=COUNT_RTOL)


def test_event_kinds_counts_and_payload_keys_equal(served):
    port, ref = served["port"]["events"], served["jax"]["events"]
    assert _kinds(port) == _kinds(ref)
    assert _keys(port) == _keys(ref)
    kinds = _kinds(port)
    assert kinds["run"] == 1 and kinds["serve.request"] == N_REQ
    assert kinds["serve.batch"] == served["port"]["stats"]["batches"]
    assert kinds["trace.span"] == 5 * N_REQ
    assert all(e["payload"]["ok"] for e in port if e["kind"] == "serve.request")
    assert kinds["heartbeat"] == 1 and kinds["slo.burn"] == 1
    # every signature was warmed: traffic adds none
    warm = max(i for i, e in enumerate(port) if e["kind"] == "serve.warmup")
    assert not [e for e in port[warm:] if e["kind"] == "compile"]


def test_perf_summary_points_and_compile_costs(served):
    """The cost ledger on the serving path: ``perf.summary`` at the JAX
    service's points (warmup, close; the script's 8 batches stay under
    the 32-batch period), ``serve_predict`` rows, and every ``compile``
    event carrying the first call's flops and bytes."""
    got = {}
    for pkg in ("jax", "port"):
        events = served[pkg]["events"]
        perf = [e["payload"] for e in events if e["kind"] == "perf.summary"]
        got[pkg] = [p["phase"] for p in perf]
        compiles = [e["payload"] for e in events if e["kind"] == "compile"]
        assert compiles and all(c["flops"] > 0 and c["bytes_accessed"] > 0
                                for c in compiles)
        assert {r["name"] for r in perf[-1]["detail"]} == {"serve_predict"}
        assert perf[-1]["perf_programs"] == len(compiles)
        assert perf[-1]["mfu_weighted"] is not None
    assert got["port"] == got["jax"] == ["serve_warmup", "serve_close"]


def test_perf_summary_period(he_sd, tmp_path):
    """``perf_summary_every=3``: one summary per 3 completed batches
    between the warmup's and the close's; steady-state batches feed the
    ledger's fenced timings (first calls do not)."""
    from can_tpu_torch.cli.common import local_device_peaks
    from can_tpu_torch.obs import ProgramCostLedger, Telemetry
    from can_tpu_torch.serve import ServeEngine

    events = []

    class Sink:
        def emit(self, e):
            events.append(e)

        def close(self):
            pass

    tel = Telemetry([Sink()])
    tel.ledger = ProgramCostLedger(peaks=local_device_peaks("cpu"))
    engine = ServeEngine(he_sd, device="cpu", telemetry=tel)
    svc = CountService(engine, max_batch=2, max_wait_ms=1.0,
                       bucket_ladder=((64,), (64,)), perf_summary_every=3,
                       telemetry=tel)
    svc.warmup([(64, 64)])
    img = prepare_image(_images()[0])
    with svc:
        for _ in range(7):
            svc.predict(img, timeout=120)
    phases = [e["payload"]["phase"] for e in events if e["kind"] == "perf.summary"]
    assert phases == ["serve_warmup", "serve", "serve", "serve_close"]
    rows = {tuple(r["shape"]): r for r in tel.ledger.rows()}
    assert rows[(1, 64, 64, 3)]["launches"] == 7
    assert rows[(1, 64, 64, 3)]["timing_reliable"]


def test_span_trees_equal(served):
    trees = _span_trees(served["port"]["events"])
    assert trees == _span_trees(served["jax"]["events"])
    assert trees == [["batch_assembly", "device", "queue_wait", "respond"]] * N_REQ


def _metric_shapes(text):
    """{metric name: sorted label-name sets} of a Prometheus text."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? ", line)
        assert m, line
        labels = tuple(sorted(kv.split("=")[0] for kv in m.group(3).split(","))
                       ) if m.group(3) else ()
        out.setdefault(m.group(1), set()).add(labels)
    return {k: sorted(v) for k, v in out.items()}


def test_metrics_names_and_labels_equal(served):
    """The scrape's metric names and label sets are the reference's, the
    cost ledger's (``can_tpu_mfu*``, ``can_tpu_roofline*``,
    ``can_tpu_peak_*``, ...) included."""
    port = _metric_shapes(served["port"]["metrics"])
    assert port == _metric_shapes(served["jax"]["metrics"])
    assert "can_tpu_serve_completed_total" in port
    # scraped mid-traffic: the warmup's summary (rows, roofline, peaks);
    # MFU joins at the close's, once traffic has timed the programs
    assert {"can_tpu_roofline_compute_bound", "can_tpu_perf_programs",
            "can_tpu_peak_flops"} <= set(port)
    closed = _metric_shapes(served["port"]["closed_metrics"])
    assert closed == _metric_shapes(served["jax"]["closed_metrics"])
    assert {"can_tpu_mfu_weighted", "can_tpu_mfu_best"} <= set(closed)
    line = [x for x in served["port"]["metrics"].splitlines()
            if x.startswith("can_tpu_serve_completed_total ")]
    assert line == [f"can_tpu_serve_completed_total {N_REQ}"]


def test_report_tools_read_the_ports_jsonl(served, tmp_path_factory):
    out = {}
    for pkg in ("jax", "port"):
        runs = {}
        for tool, extra in (("telemetry_report", ["--json"]),
                            ("slo_report", ["--spec", SPEC, "--json"])):
            tel_dir = served[pkg]["tel"]
            r = subprocess.run([sys.executable, f"tools/{tool}.py", str(tel_dir),
                                *extra], cwd=ROOT, capture_output=True, text=True,
                               timeout=120)
            runs[tool] = (r.returncode, json.loads(r.stdout))
        out[pkg] = runs
    rep = out["port"]["telemetry_report"]
    assert rep[0] == 0 and rep[1]["serve_requests"] == N_REQ
    assert rep[1]["serve_requests"] == out["jax"]["telemetry_report"][1]["serve_requests"]
    slo = out["port"]["slo_report"]
    assert slo[0] == 0 == out["jax"]["slo_report"][0]  # a short clean run passes
    assert slo[1]["violations"] == []


# -- the CLI ---------------------------------------------------------------------
def _options(parse_args):
    """The option strings of a CLI's parser (captured at parse time)."""
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["p"] = self
        return orig(self, *a, **k)

    argparse.ArgumentParser.parse_args = grab
    try:
        ns = parse_args(["--platform", "cpu"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {o for a in captured["p"]._actions for o in a.option_strings}, ns


def test_serve_flags_are_the_jax_clis_but_compile_cache():
    from can_tpu.cli import serve as jcli
    from can_tpu_torch.cli import serve as tcli

    (jopts, jns), (topts, tns) = _options(jcli.parse_args), _options(tcli.parse_args)
    # --compile-cache too, since the cold-start slice
    assert jopts - topts == set()
    assert topts - jopts == set()
    for flag in OBS_FLAGS:
        dest = flag[2:].replace("-", "_")
        assert getattr(tns, dest) == getattr(jns, dest), flag


def test_bad_spec_and_busy_metrics_port_fail_before_the_weights(he_pth, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 1, "objectives": [{"name": "x"}]}')
    r = subprocess.run([sys.executable, "-m", "can_tpu_torch.cli.serve",
                        "--torch-pth", he_pth, "--platform", "cpu", "--port", "0",
                        "--slo-spec", str(bad)], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "--slo-spec" in r.stderr
    assert "[load]" not in r.stdout and "listening" not in r.stdout
    from can_tpu_torch.cli import serve as tcli
    from can_tpu_torch.obs import MetricsExporter, GaugeSink

    busy = MetricsExporter(GaugeSink(), port=0).start()
    try:
        with pytest.raises(OSError):
            tcli.main(["--torch-pth", he_pth, "--platform", "cpu", "--port", "0",
                       "--metrics-port", str(busy.port)])
    finally:
        busy.close()


@pytest.mark.parametrize("flags, compute", [
    ((), "f32"), (("--serve-dtype", "bf16"), "bf16"),
    (("--serve-dtype", "int8"), "f32"), (("--bf16",), "bf16")])
def test_serve_cli_prices_mfu_at_its_compute_dtype(he_pth, tmp_path, monkeypatch,
                                                    flags, compute):
    """The serve CLI's ledger is armed at the forward's compute dtype: a
    bf16 service priced at the f32 peak would read MFU 15x high on the
    H100 (989 against 67 TFLOP/s)."""
    from can_tpu_torch.cli import serve as tcli

    seen = {}

    class Armed(Exception):
        pass

    def capture(args, telemetry=None):
        seen["ledger"] = telemetry.ledger
        raise Armed

    monkeypatch.setattr(tcli, "build_service", capture)
    with pytest.raises(Armed):
        tcli.main(["--torch-pth", he_pth, "--platform", "cpu", "--port", "0",
                   "--telemetry-dir", str(tmp_path / "tel"), *flags])
    assert seen["ledger"].compute == compute


# -- the fleet (port only) ---------------------------------------------------------
def _tel_args(tmp, **over):
    ns = argparse.Namespace(telemetry_dir=str(tmp / "tel"), telemetry_heartbeat_s=0.05,
                            collector_push="", metrics_port=None,
                            metrics_host="127.0.0.1", bf16=False,
                            incident_dir=str(tmp / "inc"), slo_spec="",
                            platform="cpu")
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _fleet(tmp, telemetry, sd, **kw):
    fleet = FleetEngine(sd, replicas=2, devices=["cpu"] * 3, telemetry=telemetry,
                        self_heal=False, **kw)
    svc = CountService(fleet, max_batch=2, max_wait_ms=1.0, queue_capacity=64,
                       bucket_ladder=((64,), (64,)))
    svc.warmup([(64, 64)])
    return fleet, svc


@pytest.fixture(scope="module")
def he_sd():
    return state_dict_from_jax_params(jax_params("he"))


def test_fleet_crash_writes_one_quarantine_bundle(he_sd, tmp_path, monkeypatch):
    from can_tpu_torch.cli.train import build_telemetry
    from can_tpu_torch.obs.incidents import read_manifest

    monkeypatch.setenv(faults.FAULTS_ENV, json.dumps(
        {"faults": [{"kind": "replica_crash", "replica": 0, "batch": 2}]}))
    monkeypatch.setattr(faults, "_CACHED", None)
    monkeypatch.setattr(faults, "_CACHED_SPEC", None)
    tel, hb, exporter = build_telemetry(_tel_args(tmp_path), host_id=0,
                                        install_signals=False, trace_window=None)
    try:
        fleet, svc = _fleet(tmp_path, tel, he_sd)
        img = prepare_image(_images()[0])
        with svc:
            tickets = [svc.submit(img, deadline_ms=120_000) for _ in range(12)]
            counts = [t.result(timeout=120).count for t in tickets]
        stats = svc.stats()
    finally:
        shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    assert len(counts) == 12 and stats["rejected"] == 0
    bundles = os.listdir(tmp_path / "inc")
    assert len(bundles) == 1 and bundles[0].endswith("-fleet-quarantine")
    path = tmp_path / "inc" / bundles[0]
    man = read_manifest(str(path))
    assert man["reason"] == "fleet_quarantine" and man["files"][-1] != "incident.json"
    assert man["info"]["serve_stats"]["replicas"]["0"]["quarantined"] == 1
    ring = [json.loads(x) for x in open(path / "ring.jsonl")]
    assert any(e["kind"] == "fleet.replica" and e["payload"]["state"] == "quarantined"
               and e["payload"]["replica"] == 0 for e in ring)
    assert json.load(open(path / "memory.json"))["devices"] == []  # CPU slots


def test_fleet_rollout_spans_and_request_trees(he_sd, tmp_path):
    from can_tpu_torch.cli.train import build_telemetry

    tel, hb, exporter = build_telemetry(_tel_args(tmp_path, incident_dir=""),
                                        host_id=0, install_signals=False,
                                        trace_window=None)
    try:
        fleet, svc = _fleet(tmp_path, tel, he_sd)
        img = prepare_image(_images()[1])
        with svc:
            for _ in range(4):
                svc.predict(img, timeout=120)
            report = fleet.rollout(he_sd)
    finally:
        shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    events = [json.loads(x) for x in open(tmp_path / "tel" / "telemetry.host0.jsonl")]
    spans = [e["payload"] for e in events if e["kind"] == "trace.span"]
    roll = [s for s in spans if s["trace_id"].startswith(f"rollout-g{report['generation']}")]
    assert [s["name"] for s in roll] == (
        ["rollout.staging"] + [f"rollout.flip_r{i}" for i in report["flipped"]]
        + ["rollout"])
    assert roll[-1]["generation"] == report["generation"]
    assert _span_trees(events) == [["batch_assembly", "device", "queue_wait",
                                    "respond"]] * 4


def test_slo_burn_reaches_the_gauges_and_scales_the_fleet(he_sd, tmp_path):
    """A spec whose p99 bound lies under any real latency burns; the
    burn's ``can_tpu_slo_alerting`` gauge is the autoscaler's signal."""
    from can_tpu_torch.cli.train import build_telemetry, validate_incident_args
    from can_tpu_torch.serve import Autoscaler, AutoscalePolicy

    spec = tmp_path / "tight.json"
    spec.write_text(json.dumps({"version": 1, "eval_interval_s": 0.01, "objectives": [{
        "name": "serve_p99_tight", "event": "serve.request", "field": "latency_s",
        "op": "<=", "threshold": 1e-6, "target": 0.99, "windows_s": [60, 300],
        "burn_alert": 2.0, "min_samples": 2}]}))
    args = _tel_args(tmp_path, slo_spec=str(spec))
    validate_incident_args(args)
    tel, hb, exporter = build_telemetry(args, host_id=0, install_signals=False,
                                        trace_window=None)
    try:
        fleet, svc = _fleet(tmp_path, tel, he_sd)
        img = prepare_image(_images()[2])
        with svc:
            for _ in range(4):
                svc.predict(img, timeout=120)
            gauges = tel._gauge_sink
            alerting = [g for g in gauges.snapshot()["labelled_gauges"]
                        if g["name"].endswith("_slo_alerting")]
            assert alerting and alerting[0]["value"] == 1
            auto = Autoscaler(svc, AutoscalePolicy(min_replicas=2, max_replicas=3,
                                                   cooldown_s=0.0), gauges=gauges)
            actions = [auto.tick(now=float(i)) for i in range(2)]
            assert fleet.live_replicas() == 3
    finally:
        shutdown_telemetry(tel, heartbeat=hb, exporter=exporter)
    assert actions == [None, "up"]
    events = [json.loads(x) for x in open(tmp_path / "tel" / "telemetry.host0.jsonl")]
    assert any(e["kind"] == "slo.burn" and e["payload"]["alerting"] for e in events)
    scale = [e["payload"] for e in events if e["kind"] == "fleet.scale"]
    assert scale[-1]["reason"] == "autoscale:slo_burn"
    # the burn also dumped a (warning) bundle
    assert [b.split("-", 3)[-1] for b in os.listdir(tmp_path / "inc")] == [
        "slo-serve-p99-tight"]
