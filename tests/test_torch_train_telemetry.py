"""Telemetry in the port's train and eval loops and CLIs against the JAX
package's on the CPU (the models are tests/test_cli.py's telemetry run and
tests/test_perf.py's loop tests).

* The CLIs: both packages' train CLI and then eval CLI run one epoch of
  the BN model on one synthetic set (64x64 / 64x96, batch 2,
  ``--telemetry-dir --metrics-port 0``; the JAX runs once per module).
  Their JSONL files hold the same event kinds with the same counts and
  payload keys, and the same span trees; timings are not compared.  The
  port's ``perf.summary`` names ``train_step`` / ``eval_step`` rows with
  flops, a roofline class and the CPU's nominal peaks.
* Telemetry on against off (the port's train CLI, the trace window and
  the cost ledger armed): the weights, momentum and running statistics
  after the epoch are bitwise equal, and the trace file is written.
* The loops (tests/test_perf.py's TestLoopPerfTelemetry on both
  packages): a two-shape epoch with a ledger and a span tracer gives the
  same kinds and counts, a ``perf.summary`` with both programs and the
  launch-cost fit, and the ``train_epoch`` span tree; with no ledger no
  new kind appears.
* The flags: the nine telemetry flags of both CLIs with JAX's defaults.
"""

import argparse
import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from can_tpu import obs as jobs
from can_tpu_torch import obs as tobs
from can_tpu_torch.cli import test as tcli_test
from can_tpu_torch.cli import train as tcli_train
from can_tpu_torch.data import make_synthetic_dataset

SIZES = ((64, 64), (64, 96))
TEL_FLAGS = ("--profile-dir", "--trace-steps", "--telemetry-dir",
             "--telemetry-heartbeat-s", "--metrics-port", "--metrics-host",
             "--collector-push", "--incident-dir", "--slo-spec")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("tsynth")
    make_synthetic_dataset(str(root / "train_data"), 4, sizes=SIZES, seed=0)
    make_synthetic_dataset(str(root / "test_data"), 2, sizes=SIZES, seed=4)
    return root


def _train_argv(synth, out: Path, *extra):
    return ["--data_root", str(synth), "--platform", "cpu", "--syncBN",
            "--batch-size", "2", "--epochs", "1", "--lr", "1e-6", "--seed", "0",
            "--pad-multiple", "32", "--launch-cost-mpx", "0.001",
            "--checkpoint-dir", str(out / "ck"), *extra]


def _tel_flags(out: Path):
    return ["--telemetry-dir", str(out / "tel"), "--metrics-port", "0"]


def _eval_argv(synth, out: Path, *extra):
    return ["--data_root", str(synth), "--platform", "cpu", "--syncBN",
            "--batch-size", "2", "--checkpoint-dir", str(out / "ck"), *extra]


def _events(path: Path):
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """Train then eval, each package, telemetry on; the port's telemetry
    also arms the trace window.  Returns {pkg: {"train", "eval": events}}."""
    from can_tpu.cli.test import main as jeval
    from can_tpu.cli.train import main as jtrain

    out = {}
    j = tmp_path_factory.mktemp("jax")
    assert jtrain(_train_argv(synth, j, *_tel_flags(j / "t"),
                              "--compile-cache", "off")) == 0
    assert jeval(_eval_argv(synth, j, *_tel_flags(j / "e"),
                            "--compile-cache", "off")) == 0
    out["jax"] = {"train": _events(j / "t" / "tel" / "telemetry.host0.jsonl"),
                  "eval": _events(j / "e" / "tel" / "telemetry.host0.jsonl")}
    p = tmp_path_factory.mktemp("port")
    summary = tcli_train.train(tcli_train.parse_args(_train_argv(
        synth, p, *_tel_flags(p / "t"), "--trace-steps", "0:1",
        "--profile-dir", str(p / "prof"))))
    ev = tcli_test.evaluate_checkpoint(tcli_test.parse_args(
        _eval_argv(synth, p, *_tel_flags(p / "e"))))
    out["port"] = {"train": _events(p / "t" / "tel" / "telemetry.host0.jsonl"),
                   "eval": _events(p / "e" / "tel" / "telemetry.host0.jsonl"),
                   "summary": summary, "eval_metrics": ev, "dir": p}
    return out


def _kinds(events):
    c = Counter(e["kind"] for e in events)
    c["heartbeat"] = min(c["heartbeat"], 1)  # its count follows the clock
    return c


def _keys(events):
    out = {}
    for e in events:
        k = e["kind"] if e["kind"] != "trace.span" else f"span:{e['payload']['name']}"
        out.setdefault(k, set()).update(e["payload"])
    return {k: sorted(v) for k, v in out.items()}


def _span_tree(events):
    spans = [e["payload"] for e in events if e["kind"] == "trace.span"]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"])) for s in spans)


@pytest.mark.parametrize("phase", ["train", "eval"])
def test_cli_events_equal_the_references(runs, phase):
    port, ref = runs["port"][phase], runs["jax"][phase]
    assert _kinds(port) == _kinds(ref)
    assert _keys(port) == _keys(ref)
    assert _span_tree(port) == _span_tree(ref)
    kinds = _kinds(port)
    assert kinds["compile"] >= 1 and kinds["perf.summary"] >= 1
    assert kinds["epoch"] == 1 and kinds["heartbeat"] == 1


def test_cli_perf_summary_rows(runs):
    """The port's ledger: every first call's signature is a row with
    counted flops and bytes and a roofline class, on the CPU's nominal
    peaks; the eval summary carries the train rows too (one ledger per
    run, cumulative)."""
    train = [e["payload"] for e in runs["port"]["train"]
             if e["kind"] == "perf.summary"]
    compiles = [e["payload"] for e in runs["port"]["train"]
                if e["kind"] == "compile"]
    rows = {r["name"] for r in train[-1]["detail"]}
    assert rows == {"train_step", "eval_step"}
    assert train[-1]["perf_programs"] == len(compiles)
    for c in compiles:
        assert c["flops"] > 1e9 and c["bytes_accessed"] > 0
    for r in train[-1]["detail"]:
        assert r["roofline"] in ("compute", "memory") and r["flops"] > 1e9
    assert train[-1]["peak_source"] == "nominal:cpu"
    assert train[-1]["peak_nominal"] == 1
    # the port's trace window wrote one Chrome trace
    (trace,) = (runs["port"]["dir"] / "prof").iterdir()
    assert trace.suffix == ".json" and trace.stat().st_size > 0


def test_training_with_telemetry_is_bitwise_training_without(synth, runs, tmp_path):
    on = runs["port"]["dir"] / "ck" / "0" / "state.pt"
    summary = tcli_train.train(tcli_train.parse_args(_train_argv(synth, tmp_path)))
    assert summary["steps"] == runs["port"]["summary"]["steps"] > 0
    a = torch.load(on, weights_only=True)
    b = torch.load(tmp_path / "ck" / "0" / "state.pt", weights_only=True)
    for part in ("model", "optimizer"):
        flat_a = _flat(a[part])
        flat_b = _flat(b[part])
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert torch.equal(flat_a[k], flat_b[k]), (part, k)
    assert np.isfinite(runs["port"]["eval_metrics"]["mae"])


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    return out


# -- the loops ----------------------------------------------------------------
class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


def _fake_step(as_tensor):
    def step(state, batch):
        b, h, w = batch["image"].shape[:3]
        time.sleep(b * h * w * 2e-4)  # a positive pixels -> seconds slope
        n = float(batch["image"].shape[0])
        if as_tensor:
            return state, {"loss": torch.tensor(1.0), "num_valid": torch.tensor(n)}
        return state, {"loss": 1.0, "num_valid": n}
    return step


def _run_epoch(name, tel):
    """12 steps over two shapes: 1 first call + 5 timed launches each."""
    batches = [{"image": np.ones((2, 8 if i < 6 else 16, 8, 3), np.float32),
                "sample_mask": np.ones((2,), np.float32)} for i in range(12)]
    if name == "jax":
        from can_tpu.train import train_one_epoch

        return train_one_epoch(_fake_step(False), None, batches,
                               put_fn=lambda b: b, show_progress=False,
                               check_every=2, telemetry=tel, epoch=0)
    from can_tpu_torch.train import train_one_epoch

    return train_one_epoch(_fake_step(True), None, batches,
                           put_fn=lambda b: {k: torch.from_numpy(v)
                                             for k, v in b.items()},
                           check_every=2, telemetry=tel, epoch=0, prefetch=0)


def _ledger(pkg_name):
    if pkg_name == "jax":
        from can_tpu.cli.common import DevicePeaks
    else:
        from can_tpu_torch.cli.common import DevicePeaks
    pkg = jobs if pkg_name == "jax" else tobs
    peaks = DevicePeaks(flops_bf16=2e12, flops_f32=1e12, hbm_bytes_s=1e11,
                        source="spec:test")
    return pkg.ProgramCostLedger(peaks=peaks, plan_launch_cost_px=0.05e6)


@pytest.mark.parametrize("armed", [True, False], ids=["ledger", "no_ledger"])
def test_loop_events_equal_the_references(armed):
    got = {}
    for name, pkg in (("jax", jobs), ("port", tobs)):
        sink = ListSink()
        tel = pkg.Telemetry([sink])
        if armed:
            tel.ledger = _ledger(name)
            tel.spans = pkg.SpanTracer(tel, prefix="t")
        _, stats = _run_epoch(name, tel)
        assert stats.steps == 12 and stats.programs == 2
        got[name] = sink.events
    assert _kinds(got["port"]) == _kinds(got["jax"])
    assert _keys(got["port"]) == _keys(got["jax"])
    kinds = {e["kind"] for e in got["port"]}
    if not armed:
        assert "perf.summary" not in kinds and "trace.span" not in kinds
        return
    (perf,) = [e["payload"] for e in got["port"] if e["kind"] == "perf.summary"]
    assert perf["phase"] == "train" and perf["perf_programs"] == 2
    assert "launch_cost_mpx_empirical" in perf and "launch_cost_drift" in perf
    assert [r["name"] for r in perf["detail"]] == ["train_step", "train_step"]
    assert _span_tree(got["port"]) == _span_tree(got["jax"])
    spans = [e["payload"] for e in got["port"] if e["kind"] == "trace.span"]
    assert {s["name"] for s in spans} == {"steps", "metric_flush",
                                          "fetch_stall", "train_epoch"}
    assert len({s["trace_id"] for s in spans}) == 1


def test_the_loops_without_telemetry_tick_nothing(monkeypatch):
    """telemetry=None: no tracker, no timer, no stall clock."""
    from can_tpu_torch.train import loop

    assert loop._arm_telemetry(None, len, name="x") == (len, None, None)
    _, stats = _run_epoch("port", None)
    assert stats.steps == 12


# -- the flags ------------------------------------------------------------------
def _options(parse_args, argv):
    captured = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["p"] = self
        return orig(self, *a, **k)

    argparse.ArgumentParser.parse_args = grab
    try:
        ns = parse_args(argv)
    finally:
        argparse.ArgumentParser.parse_args = orig
    return {o for a in captured["p"]._actions for o in a.option_strings}, ns


@pytest.mark.parametrize("cli", ["train", "test"])
def test_the_nine_flags_with_the_references_defaults(cli, synth):
    import importlib

    jmod = importlib.import_module(f"can_tpu.cli.{cli}")
    tmod = importlib.import_module(f"can_tpu_torch.cli.{cli}")
    jopts, jns = _options(jmod.parse_args, [])
    topts, tns = _options(tmod.parse_args, [])
    for flag in TEL_FLAGS:
        assert flag in topts and flag in jopts, flag
        dest = flag[2:].replace("-", "_")
        assert getattr(tns, dest) == getattr(jns, dest), flag
    with pytest.raises(SystemExit, match="profile-dir"):
        (tcli_train.train if cli == "train" else tcli_test.evaluate_checkpoint)(
            tmod.parse_args(["--data_root", str(synth), "--trace-steps", "0:2",
                             "--platform", "cpu"]))
