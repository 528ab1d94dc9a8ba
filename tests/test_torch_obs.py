"""The port's obs core (``can_tpu_torch/obs``: bus, spans, flight recorder,
signals, sources, report) against the JAX package's ``can_tpu/obs`` on the
CPU.

Both packages are driven with ONE seeded event script (``event_script``:
numpy-seeded kinds, steps and payloads covering every kind the report and
the exporter read) on one fake clock.  Comparisons are exact: the JSONL
lines (``ts`` normalised only where a real clock stamps them), the span
events, the flight recorder's rings and dumps, the signal files, the
summaries and the rendered report, and ``tools/telemetry_report.py`` run
on the port's file against the JAX package's.  The sources that read
clocks or devices (RecompileTracker, Heartbeat, the memory snapshot) are
compared by payload keys, and the port's memory snapshot never
initialises CUDA.

``event_script``, ``FakeClock`` and ``drive`` are shared with the other
``test_torch_*`` obs files.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import can_tpu.obs as jobs
import can_tpu_torch.obs as tobs

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": jobs, "port": tobs}
T0 = 1_765_000_000.0


class FakeClock:
    """A settable clock: ``clock()`` reads, ``clock.t`` is set by the
    driver before each emit."""

    def __init__(self, t: float = T0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def _r(x, nd=6):
    return round(float(x), nd)


def event_script(seed: int = 0, n: int = 600, *, burn_at=(0.4, 0.8)):
    """``[(ts, kind, step, payload)]``: a seeded mixed train/serve/fleet
    run of ``n`` events over ~10 minutes.  Requests between the
    ``burn_at`` fractions of the run take 2.5-4 s (over the spec's 2 s
    threshold), so the serve p99 objective burns there."""
    rng = np.random.default_rng(seed)
    out = []
    t = T0
    out.append((t, "run", None, {"config": {"seed": seed, "replicas": 2,
                                            "serve_dtype": "f32"}}))
    gen = 1
    req = 0
    for i in range(n):
        t += float(rng.uniform(0.2, 1.8))
        frac = i / n
        u = float(rng.uniform())
        if u < 0.45:
            slow = burn_at[0] <= frac < burn_at[1]
            lat = (rng.uniform(2.5, 4.0) if slow
                   else float(rng.lognormal(np.log(0.05), 0.4)))
            p = {"request_id": req, "latency_s": _r(lat), "bucket": [64, 96],
                 "ok": True, "trace_id": f"req-{req}",
                 "queue_wait_s": _r(lat * 0.2), "assembly_s": _r(lat * 0.05),
                 "device_s": _r(lat * 0.6)}
            if rng.uniform() < 0.1:
                p.update(degraded=True, stream="cam1",
                         staleness_s=_r(rng.uniform(0, 12)))
            req += 1
            out.append((t, "serve.request", None, p))
        elif u < 0.55:
            size = int(rng.choice([1, 2, 4]))
            valid = int(rng.integers(1, size + 1))
            out.append((t, "serve.batch", None, {
                "bucket": [64, 96], "size": size, "valid": valid,
                "fill": _r(valid / size, 4), "fill_pct": _r(100 * valid / size, 2),
                "padded_slots": size - valid,
                "predicted_cost_px": float(6144 * size),
                "realized_cost_px": float(6144 * size),
                "execute_s": _r(rng.uniform(0.01, 0.03)), "compiled": False,
                "queue_depth": int(rng.integers(0, 6)),
                "replica": int(rng.integers(0, 2))}))
        elif u < 0.58:
            out.append((t, "serve.reject", None, {
                "reason": str(rng.choice(["deadline", "backpressure"])),
                "count": int(rng.integers(1, 3))}))
        elif u < 0.68:
            samples = [_r(x) for x in rng.uniform(0.05, 0.07, 8)]
            out.append((t, "step_window", 8 * i, {
                "phase": "train", "epoch": i // 60, "steps": 8,
                "seconds": _r(sum(samples) + 0.1), "images": 64.0,
                "samples_s": samples, "loss": _r(rng.uniform(0.2, 0.4))}))
        elif u < 0.71:
            out.append((t, "stall", None, {
                "seconds": _r(rng.uniform(0, 3)), "count": 4,
                "frac_of_epoch": _r(rng.uniform(0, 0.3)), "epoch": i // 60,
                "phase": "train"}))
        elif u < 0.73:
            out.append((t, "compile", None, {
                "name": "train_step",
                "signature": [["image", [2, 64, 96, 3], "float32"]],
                "seconds": _r(rng.uniform(0.1, 2)), "n_signatures": 1 + i % 3}))
        elif u < 0.75:
            out.append((t, "memory", None, {
                "where": "epoch", "host_rss_mb": _r(rng.uniform(500, 900), 1),
                "devices": [{"id": 0, "platform": "cuda",
                             "bytes_in_use": int(rng.integers(1, 9)) << 28,
                             "peak_bytes_in_use": 9 << 28,
                             "bytes_limit": 80 << 30,
                             "largest_alloc_size": 1 << 26}]}))
        elif u < 0.78:
            out.append((t, "epoch", i // 60, {
                "train_loss": _r(rng.uniform(0.2, 0.4)),
                "mae": _r(rng.uniform(10, 30)), "mse": _r(rng.uniform(20, 60)),
                "img_per_s": _r(rng.uniform(100, 200))}))
        elif u < 0.84:
            tid = f"req-{max(req - 1, 0)}"
            start = _r(rng.uniform(0, 600))
            out.append((t, "trace.span", None, {
                "trace_id": tid, "span_id": f"s-{i}", "parent_id": None,
                "name": str(rng.choice(["request", "device", "respond"])),
                "start_s": start, "duration_s": _r(rng.uniform(0, 0.1))}))
        elif u < 0.86:
            state = str(rng.choice(["active", "quarantined", "wedged"]))
            out.append((t, "fleet.replica", None, {
                "replica": int(rng.integers(0, 2)), "device": "cuda:0",
                "state": state, "batches": int(rng.integers(0, 50)),
                "failures": int(state != "active"),
                "error": None if state == "active" else "injected",
                "generation": gen, "probe_failures": 0}))
        elif u < 0.87:
            ok = bool(rng.uniform() < 0.6)
            out.append((t, "fleet.probe", None, {
                "replica": 0, "ok": ok, "probe_failures": int(not ok)}))
        elif u < 0.88:
            out.append((t, "fleet.resurrect", None, {
                "replica": 0, "generation": gen, "live": 2, "seconds": 0.3,
                "warmup_compiles": 4, "aot_hits": 0,
                "probe_failures_before": 1}))
        elif u < 0.89:
            up = bool(rng.uniform() < 0.5)
            p = {"direction": "up" if up else "down", "replica": 2,
                 "reason": "manual", "live": 3 if up else 2,
                 "generation": gen}
            if up:
                p.update(time_to_first_ready_s=_r(rng.uniform(0.2, 0.3)),
                         warmup_compiles=4, aot_hits=0)
            out.append((t, "fleet.scale", None, p))
        elif u < 0.895:
            gen += 1
            out.append((t, "fleet.rollout", None, {
                "generation": gen, "flipped": [0, 1], "skipped": [],
                "staging_compiles": 4, "staging_seconds": 0.4,
                "config_drift": [], "seconds": 0.5}))
        elif u < 0.92:
            out.append((t, "health.alert", None, {
                "signal": "loss", "alert": str(rng.choice(["spike", "plateau"])),
                "value": _r(rng.uniform(0, 1)), "baseline": 0.3,
                "epoch": i // 60}))
        elif u < 0.94:
            out.append((t, "stream.session", None, {
                "state": "snapshot", "active": int(rng.integers(1, 4)),
                "staleness_s": 0.0, "stream": "cam1"}))
        elif u < 0.95:
            out.append((t, "stream.degrade", None, {
                "stream": "cam1", "rung": "frame_skip", "from_rung": "full",
                "load": 1.5, "outstanding": 3}))
        elif u < 0.96:
            out.append((t, "data.cache", i // 60, {
                "hits": i, "misses": 10, "hit_rate": _r(i / (i + 10)),
                "inserts": 10, "evictions": 0, "oversize_skips": 0,
                "items": 10, "bytes": 123456, "capacity_bytes": 10 ** 9}))
        else:
            out.append((t, "heartbeat", None, {
                "uptime_s": _r(t - T0, 3), "seq": i, "start_ts": T0}))
    return out


def drive(pkg, sinks, script, *, host_id=0, watchers=(), clock=None):
    """Replay ``script`` through ``pkg``'s bus on a fake clock; returns
    the bus (closed)."""
    clock = clock or FakeClock()
    tel = pkg.Telemetry(list(sinks), host_id=host_id, clock=clock)
    for w in watchers:
        tel.watchers.append(w(tel) if callable(w) and not hasattr(w, "on_event")
                            else w)
    for ts, kind, step, payload in script:
        clock.t = ts
        tel.emit(kind, step=step, **payload)
    tel.close()
    return tel


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _write_both(tmp_path, script, **kw):
    paths = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        path = d / "telemetry.host0.jsonl"
        drive(pkg, [pkg.JsonlSink(str(path))], script, **kw)
        paths[name] = path
    return paths


# -- bus ---------------------------------------------------------------------
def test_event_kinds_are_the_references():
    assert tobs.EVENT_KINDS == jobs.EVENT_KINDS


def test_jsonl_lines_equal_on_one_script(tmp_path):
    script = event_script(0)
    paths = _write_both(tmp_path, script)
    port, ref = _lines(paths["port"]), _lines(paths["jax"])
    assert len(port) == len(script) and port == ref
    ev = json.loads(port[1])
    assert set(ev) == {"ts", "kind", "step", "host_id", "payload"}


def test_open_host_telemetry_names_the_references_file(tmp_path):
    names = {}
    for name, pkg in PKGS.items():
        tel = pkg.open_host_telemetry(str(tmp_path / name), host_id=3)
        tel.emit("run", config={"a": 1})
        tel.close()
        names[name] = sorted(os.listdir(tmp_path / name))
        (ev,) = [json.loads(x) for x in _lines(tmp_path / name / names[name][0])]
        ev.pop("ts")  # the real clock
        names[name].append(ev)
    assert names["port"] == names["jax"]
    assert names["port"][0] == "telemetry.host3.jsonl"


def test_numpy_and_torch_payloads_are_jsonable(tmp_path):
    """numpy scalars and arrays serialise as in the reference; a 0-d
    torch tensor becomes its ``.item()`` and an n-d one a list, so a
    payload of tensors writes the line the reference writes for the same
    values as numpy."""
    clock = FakeClock()
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(2, 3)).astype(np.float32)
    scalar = np.float32(rng.normal())
    lines = {}
    for name, pkg in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        tel = pkg.Telemetry([pkg.JsonlSink(str(path))], clock=clock)
        tel.emit("bench", a=arr, s=scalar, i=np.int64(7),
                 nested={"x": [np.float64(0.5)]})
        if name == "port":
            tel.emit("bench", a=torch.from_numpy(arr), s=torch.tensor(scalar),
                     i=torch.tensor(7), nested={"x": [torch.tensor(0.5, dtype=torch.float64)]})
        tel.close()
        lines[name] = _lines(path)
    assert lines["port"][0] == lines["jax"][0]
    assert lines["port"][1] == lines["jax"][0]


def test_stdout_and_metric_logger_sinks_equal(capsys):
    script = event_script(2, n=80)
    logs = {}
    for name, pkg in PKGS.items():
        calls = []

        class Logger:
            def log(self, scalars, step=None):
                calls.append((scalars, step))

        drive(pkg, [pkg.StdoutSink(), pkg.MetricLoggerSink(Logger())], script)
        logs[name] = (capsys.readouterr().out, calls)
    assert logs["port"] == logs["jax"]
    assert logs["port"][1], "the script has epoch events"


def test_a_failing_sink_or_watcher_is_kept_with_one_warning(capsys):
    outs = {}
    for name, pkg in PKGS.items():
        class Flaky:
            n = 0

            def emit(self, event):
                Flaky.n += 1
                if Flaky.n in (2, 3):
                    raise OSError("disk full")

            def close(self):
                pass

        class BadWatcher:
            def on_event(self, event):
                raise RuntimeError("boom")

            def close(self):
                pass

        got = []

        class Keep:
            def emit(self, event):
                got.append(event["kind"])

            def close(self):
                pass

        drive(pkg, [Flaky(), Keep()], event_script(3, n=10),
              watchers=[BadWatcher()])
        outs[name] = (capsys.readouterr().out, got)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].count("failed") == 2  # one per streak: sink, watcher


# -- spans -------------------------------------------------------------------
def test_span_tracer_events_equal(tmp_path):
    clock = FakeClock()
    lines = {}
    for name, pkg in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        tel = pkg.Telemetry([pkg.JsonlSink(str(path))], clock=clock)
        spans = pkg.SpanTracer(tel, prefix="p0")
        tid = spans.new_trace_id("request")
        root_id = spans.new_span_id()
        kid = spans.emit(trace_id=tid, name="device", start=1.25, end=1.5,
                         parent_id=root_id, compiled=False)
        spans.emit(trace_id=tid, name="request", start=1.0, end=2.0,
                   span_id=root_id, bucket=[64, 96], ok=True)
        spans.emit(trace_id=tid, name="negative", start=3.0, end=2.0)
        tel.close()
        lines[name] = (tid, root_id, kid, _lines(path))
    assert lines["port"] == lines["jax"]


# -- flight recorder -----------------------------------------------------------
def test_flight_recorder_rings_and_dump_equal(tmp_path):
    script = event_script(4)
    out = {}
    for name, pkg in PKGS.items():
        rec = pkg.FlightRecorder(capacity=16, kind_capacity={"heartbeat": 4}, retain_s=120.0)
        drive(pkg, [rec], script)
        n = rec.dump(str(tmp_path / f"{name}.ring.jsonl"), now=script[-1][0] + 1)
        out[name] = (rec.snapshot(), rec.stats(), n,
                     _lines(tmp_path / f"{name}.ring.jsonl"),
                     rec.snapshot(now=script[-1][0] + 1))
    assert out["port"] == out["jax"]
    assert out["port"][2] > 0


# -- signals -----------------------------------------------------------------
def test_signal_files_equal(tmp_path):
    from can_tpu.obs import signals as js
    from can_tpu_torch.obs import signals as ts

    out = {}
    for name, mod in (("jax", js), ("port", ts)):
        d = tmp_path / name
        mod.write_signal(str(d), kind="dead", host_id=1, reason="stale 200s",
                         detail={"age_s": 200.0}, ts=T0)
        mod.write_signal(str(d), kind="leave", host_id=2, reason="sigterm", ts=T0 + 1)
        (d / "junk.json").write_text("{not json")
        sigs = mod.read_signals(str(d))
        files = {p.name: json.loads(p.read_text()) for p in sorted(d.iterdir())
                 if p.name != "junk.json"}
        out[name] = (sigs, files, sorted(mod.leaver_hosts(sigs)),
                     os.path.basename(mod.signal_path(str(d), "dead", 1)))
    assert out["port"] == out["jax"]
    assert ts.SIGNAL_SCHEMA == js.SIGNAL_SCHEMA


# -- sources -----------------------------------------------------------------
def test_batch_signature_of_tensors_is_the_references_of_arrays():
    from can_tpu.train.steps import batch_signature as jsig
    from can_tpu_torch.train.steps import batch_signature as tsig

    rng = np.random.default_rng(5)
    batch = {"image": rng.normal(size=(2, 64, 96, 3)).astype(np.float32),
             "raw": rng.integers(0, 255, (2, 64, 96, 3), dtype=np.uint8),
             "sample_mask": np.ones(2, bool), "note": "no shape"}
    tensors = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in batch.items()}
    assert tsig(tensors) == jsig(batch) == tsig(batch)


def test_recompile_tracker_events_match_but_for_their_times(tmp_path):
    rng = np.random.default_rng(6)
    batches = [{"image": np.zeros(s, dtype=dt)} for s, dt in
               [((2, 64, 64, 3), np.float32), ((2, 64, 64, 3), np.float32),
                ((2, 64, 96, 3), np.float32), ((2, 64, 64, 3), np.uint8)]]
    rng.shuffle(batches)
    out = {}
    for name, pkg in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        tel = pkg.Telemetry([pkg.JsonlSink(str(path))], clock=FakeClock())
        flags = []
        for _ in range(2):  # a re-wrapped step does not re-attribute
            tracker = pkg.RecompileTracker(lambda state, b: b["image"].shape, tel,
                                           name="train_step")
            for b in batches:
                tracker(None, b)
                flags.append(tracker.last_first_call)
        tel.close()
        events = [json.loads(x) for x in _lines(path)]
        for e in events:
            assert e["payload"].pop("seconds") >= 0
        out[name] = (events, flags, {k: sorted(v) for k, v in
                                     tel.signature_registry.items()})
    assert out["port"] == out["jax"]
    assert sum(out["port"][1]) == 3


def test_stall_clock_and_heartbeat_payloads(tmp_path):
    for pkg in PKGS.values():
        clock = pkg.StallClock()
        clock.add(0.25)
        clock.add(0.5)
        assert (clock.seconds, clock.count) == (0.75, 2)
    keys = {}
    for name, pkg in PKGS.items():
        got = []

        class Sink:
            def emit(self, event):
                got.append(event)

            def close(self):
                pass

        tel = pkg.Telemetry([Sink()])
        hb = pkg.Heartbeat(tel, interval_s=0.02)
        deadline = time.monotonic() + 2.0
        while len(got) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        hb.close()
        off = pkg.Heartbeat(tel, interval_s=0)
        off.close()
        tel.close()
        assert len(got) >= 3
        assert [e["payload"]["seq"] for e in got[:3]] == [0, 1, 2]
        keys[name] = sorted(got[0]["payload"]), got[0]["kind"]
    assert keys["port"] == keys["jax"]


def test_memory_snapshot_has_the_references_keys_and_no_cuda_init(tmp_path):
    """On the CPU the port lists no device (it reads only cards this
    process has put memory on) and never initialises CUDA; the snapshot
    and the ``memory`` event carry the reference's keys."""
    snap = tobs.device_memory_snapshot()
    assert set(snap) == set(jobs.device_memory_snapshot()) == {"devices", "host_rss_mb"}
    assert snap["devices"] == [] and snap["host_rss_mb"] > 0
    assert not torch.cuda.is_initialized()
    evs = {}
    for name, pkg in PKGS.items():
        got = []

        class Sink:
            def emit(self, event):
                got.append(event)

            def close(self):
                pass

        tel = pkg.Telemetry([Sink()])
        pkg.emit_memory(tel, step=3, where="epoch")
        evs[name] = (got[0]["kind"], got[0]["step"], sorted(got[0]["payload"]))
    assert evs["port"] == evs["jax"]
    assert not torch.cuda.is_initialized()


def test_memory_snapshot_rows_from_a_fake_allocator(monkeypatch):
    """With CUDA initialised, only devices whose allocator has held memory
    are read, with the reference's row keys."""
    stats = {0: {"allocated_bytes.all.current": 5 << 20,
                 "allocated_bytes.all.peak": 9 << 20,
                 "reserved_bytes.all.peak": 16 << 20},
             1: {}}
    read = []

    class Props:
        total_memory = 80 << 30

    def memory_stats(d):
        read.append(d)
        return stats[d]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props())
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [
        {"device": 0, "blocks": [{"size": 4 << 20, "state": "active_allocated"},
                                 {"size": 8 << 20, "state": "inactive"},
                                 {"size": 1 << 20, "state": "active_allocated"}]},
        {"device": 1, "blocks": [{"size": 64 << 20, "state": "active_allocated"}]}])
    snap = tobs.device_memory_snapshot()
    assert read == [0, 1]
    assert snap["devices"] == [{
        "id": 0, "platform": "cuda", "bytes_in_use": 5 << 20,
        "peak_bytes_in_use": 9 << 20, "bytes_limit": 80 << 30,
        "largest_alloc_size": 4 << 20}]


# -- report --------------------------------------------------------------------
def test_report_summary_and_table_equal(tmp_path):
    paths = _write_both(tmp_path, event_script(7))
    with open(paths["port"], "a") as f:
        f.write('{"ts": 1, "kind": "memo')  # a torn tail line
    with open(paths["jax"], "a") as f:
        f.write('{"ts": 1, "kind": "memo')
    out = {}
    for name, pkg in PKGS.items():
        events, torn = pkg.read_events_counted(str(paths[name]))
        assert pkg.read_events(str(paths[name])) == events
        summary = pkg.summarize(events)
        out[name] = (events, torn, summary, pkg.format_report(summary, title="t"))
    assert out["port"] == out["jax"]
    assert out["port"][1] == 1
    s = out["port"][2]
    assert s["serve_requests"] > 100 and s["steps"] > 0


def test_telemetry_report_tool_reads_the_ports_file(tmp_path):
    """``tools/telemetry_report.py`` (which imports the JAX package's jax-free
    obs) gives the port's file the reference's table and JSON."""
    paths = _write_both(tmp_path, event_script(8, n=300))
    out = {}
    for name, path in paths.items():
        runs = [subprocess.run([sys.executable, "tools/telemetry_report.py", *args,
                                str(path.parent)], cwd=ROOT, capture_output=True,
                               text=True, timeout=120) for args in ([], ["--json"])]
        for r in runs:
            assert r.returncode == 0, r.stderr
        doc = json.loads(runs[1].stdout)
        assert doc.pop("path") == str(path)
        out[name] = (runs[0].stdout.replace(str(path.parent), "<dir>"), doc)
    assert out["port"] == out["jax"]
    assert "serve requests" in out["port"][0]
