"""The port's run-health detectors (``can_tpu_torch/obs/health.py``) and
SLO engine (``can_tpu_torch/obs/slo.py``) against the JAX package's on the
CPU, on one seeded input each.

Compared exactly: each detector's verdicts over a seeded series with
injected spikes, a plateau and a slowdown; the ``health.alert`` /
``health.summary`` events a ``HealthMonitor`` emits for one seeded run;
the parsed ``slo_spec.json`` and the spec parser's messages; the
``slo.burn`` events an ``SloEngine`` watching the shared event script
emits on its fake clock (``test_torch_obs.event_script``, whose requests
burn the p99 objective for a stretch); ``grade_events``,
``replay_evals``, ``aggregate_grade`` and ``tail_evaluate``; and
``tools/slo_report.py``'s output and exit code on the port's JSONL
against the JAX package's.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

from test_torch_obs import PKGS, ROOT, FakeClock, drive, event_script

from can_tpu.obs import health as jhealth
from can_tpu.obs import slo as jslo
from can_tpu_torch.obs import health as thealth
from can_tpu_torch.obs import slo as tslo

HEALTH = {"jax": jhealth, "port": thealth}
SLO = {"jax": jslo, "port": tslo}
SPEC = str(ROOT / "slo_spec.json")


def _series(seed, n=600):
    rng = np.random.default_rng(seed)
    x = 0.5 * np.exp(-np.arange(n) / 150) + rng.normal(0, 0.01, n)
    x[[120, 250, 251]] *= [8.0, 30.0, 6.0]  # spikes, one far out
    x[300:] = x[300]  # a plateau
    return [float(v) for v in x]


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


# -- health ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_detectors_give_the_references_verdicts(seed):
    xs = _series(seed)
    rates = [0.05] * 30 + [0.08] * 10 + [0.05] * 10
    out = {}
    for name, mod in HEALTH.items():
        ewma = mod.EwmaMadDetector(k=6.0, warmup=8)
        plateau = mod.PlateauDetector(patience=50, tol=1e-3)
        rate = mod.ThroughputDetector(frac=0.25, consec=3)
        out[name] = ([ewma.update(x) for x in xs], [plateau.update(x) for x in xs],
                     [(rate.update(r), rate.baseline()) for r in rates])
    assert out["port"] == out["jax"]
    ewma, plateau, rate = out["port"]
    assert any(ewma) and any(plateau) and any(v for v, _ in rate)


def test_health_monitor_events_equal():
    rng = np.random.default_rng(3)
    xs = _series(3)
    got = {}
    for name, pkg in PKGS.items():
        sink = _Events()
        tel = pkg.Telemetry([sink], clock=FakeClock())
        mon = pkg.HealthMonitor(tel, warmup=8, plateau_patience=60, cooldown=20)
        for i, x in enumerate(xs):
            epoch = i // 100
            grad = float("inf") if i == 333 else float(1.0 + rng.normal(0, 0.05)
                                                        + (20 if i == 180 else 0))
            mon.on_step_metrics(loss_per_img=x, grad_norm=grad,
                                update_norm=0.01, epoch=epoch, step=i)
            if i % 10 == 9:
                mon.on_window([0.05 if i < 250 else 0.09] * 8, epoch=epoch)
            if i % 100 == 99:
                mon.on_stall(seconds=3.0, frac=0.1 if epoch % 2 else 0.3,
                             epoch=epoch)
                mon.epoch_summary(epoch)
        mon.on_nonfinite(float("nan"), epoch=6, step=600)
        rng = np.random.default_rng(3)  # the same gradient draws for both
        got[name] = ([(e["kind"], e["step"], json.dumps(e["payload"], sort_keys=True))
                      for e in sink.events],
                     mon.alerts_total, mon.suppressed_total)
    assert got["port"] == got["jax"]
    kinds = {json.loads(p)["alert"] for k, _, p in got["port"][0] if k == "health.alert"}
    assert {"spike", "nan_precursor", "plateau", "throughput_regression",
            "stall_budget", "nan"} <= kinds


# -- SLO spec --------------------------------------------------------------------
def test_slo_spec_parses_as_the_reference():
    specs = {n: dataclasses.asdict(m.load_slo_spec(SPEC)) for n, m in SLO.items()}
    assert specs["port"] == specs["jax"]
    assert len(specs["port"]["objectives"]) >= 5


@pytest.mark.parametrize("doc", [
    [], {"version": 9, "objectives": []}, {"version": 1, "objectives": []},
    {"version": 1, "objectives": [{"name": "a"}]},
    {"version": 1, "objectives": [{"name": "a", "event": "serve.request",
                                   "target": 2.0}]},
    {"version": 1, "objectives": [{"name": "a", "event": "serve.request",
                                   "field": "latency_s", "op": "~",
                                   "threshold": 1, "target": 0.9}]},
])
def test_slo_spec_errors_carry_the_references_messages(doc):
    msgs = {}
    for name, mod in SLO.items():
        with pytest.raises(ValueError) as e:
            mod.parse_slo_spec(doc)
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["jax"]


# -- SLO engine ------------------------------------------------------------------
def test_slo_engine_burn_events_equal_on_the_script():
    script = event_script(11)
    got = {}
    for name, pkg in PKGS.items():
        sink = _Events()
        spec = pkg.load_slo_spec(SPEC)
        engines = []

        def arm(tel, pkg=pkg, spec=spec):
            engines.append(pkg.SloEngine(spec, tel))
            return engines[-1]

        drive(pkg, [sink], script, watchers=[arm])
        burns = [e for e in sink.events if e["kind"] == "slo.burn"]
        got[name] = (burns, engines[0].alerts_total, engines[0].run_totals())
    assert got["port"] == got["jax"]
    burns, alerts, _ = got["port"]
    assert alerts > 0 and any(b["payload"]["alerting"] for b in burns)
    assert {b["payload"]["objective"] for b in burns} >= {"serve_p99_deadline",
                                                         "serve_reject_rate"}


def test_slo_grade_replay_and_tail_equal():
    script = event_script(12)
    events = [{"ts": ts, "kind": k, "step": s, "host_id": 0, "payload": p}
              for ts, k, s, p in script]
    got = {}
    for name, mod in SLO.items():
        spec = mod.load_slo_spec(SPEC)
        grade = mod.grade_events(events[::-1], spec)  # any order
        engine, evals = mod.replay_evals(events, spec)
        agg = mod.aggregate_grade(spec, evals, engine.run_totals(),
                                  n_events=len(events))
        live = mod.SloEngine(spec)
        for e in events[:200]:
            live.on_event(e)
        tail = mod.tail_evaluate(live, events[199]["ts"] + 5.0)
        again = mod.tail_evaluate(live, events[199]["ts"] + 5.0)
        got[name] = (grade, evals, agg, tail, again)
    assert got["port"] == got["jax"]
    grade = got["port"][0]
    assert grade["violations"] and grade["events"] == len(events)
    assert got["port"][4] == []


def test_slo_report_tool_reads_the_ports_file(tmp_path):
    """``tools/slo_report.py`` grades the port's JSONL as the reference's:
    the same table, the same JSON, the same exit code (1: the script's
    burn is a violation)."""
    script = event_script(13)
    out = {}
    for name, pkg in PKGS.items():
        path = tmp_path / name / "telemetry.host0.jsonl"
        drive(pkg, [pkg.JsonlSink(str(path))], script)
        runs = [subprocess.run([sys.executable, "tools/slo_report.py", str(path.parent),
                                "--spec", SPEC, *args], cwd=ROOT, capture_output=True,
                               text=True, timeout=120) for args in ([], ["--json"])]
        out[name] = [(r.returncode, r.stdout.replace(str(path.parent), "<dir>"))
                     for r in runs]
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == 1 and "serve_p99_deadline" in out["port"][0][1]
