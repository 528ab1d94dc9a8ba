"""can_tpu_torch.testing.faults against can_tpu.testing.faults: the same
spec through both injectors gives the same ``fired`` lists, the same
exception types and messages, the same sleeps and stream directives, and
the same kill schedules; the same ``CAN_TPU_FAULTS`` trigger (inline JSON
or a path) and the same refusals of malformed schedules; then
tests/test_autoscale.py's TestServeFaults, by name.
"""

import json
import os
import signal
import time

import pytest

import can_tpu.testing.faults as jfaults
from can_tpu_torch.testing import faults

SPEC = {"faults": [
    {"kind": "kill", "rank": 1, "step": 3, "epoch": 0, "signal": "SIGUSR1"},
    {"kind": "ckpt_io", "op": "save", "fails": 2, "rank": 0},
    {"kind": "ckpt_io", "op": "restore", "fails": 1},
    {"kind": "rendezvous_timeout", "barrier": "elastic", "rank": 1,
     "delay_s": 0.01},
    {"kind": "replica_crash", "replica": 0, "batch": 3},
    {"kind": "replica_hang", "replica": 1, "batch": 2, "delay_s": 0.01},
    {"kind": "stream_burst", "stream": "cam0", "frame": 5, "burst": 8},
    {"kind": "frame_gap", "stream": "cam1", "frame": 4, "mode": "reorder"},
    {"kind": "frame_gap", "stream": "cam1", "frame": 6},
]}


def drive(module, spec, kills):
    """One script of hook calls; every outcome recorded in order."""
    inj = module.FaultInjector(json.loads(json.dumps(spec)))
    out = []

    def call(tag, fn, **kw):
        try:
            out.append((tag, kw, "ok", fn(**kw)))
        except Exception as e:  # noqa: BLE001 — the outcome is the data
            out.append((tag, kw, type(e).__name__, str(e)))

    for epoch in (0, 1):
        for step in range(1, 5):
            for rank in (0, 1):
                call("step", lambda **k: inj.on_step(
                    k["step"], epoch=k["epoch"], rank=k["rank"]),
                    step=step, epoch=epoch, rank=rank)
    for op in ("save", "restore", "save", "save", "restore"):
        for rank in (0, 1):
            call("ckpt", lambda **k: inj.on_ckpt_io(k["op"], rank=k["rank"]),
                 op=op, rank=rank)
    for name in ("elastic-join", "other", "elastic-join"):
        for rank in (0, 1):
            call("barrier", lambda **k: inj.on_barrier(k["name"],
                                                       rank=k["rank"]),
                 name=name, rank=rank)
    for batch in (1, 2, 3, 3, 4):
        for replica in (0, 1):
            call("serve", inj.on_serve_batch, replica=replica,
                 batch_index=batch)
    for frame in range(1, 8):
        for stream in ("cam0", "cam1"):
            call("stream", inj.on_stream_frame, stream=stream, frame=frame)
    return out, [dict(f) for f in inj.fired], kills[:]


def test_injector_decisions_equal_jax(monkeypatch):
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    got = drive(faults, SPEC, kills)
    kills.clear()
    want = drive(jfaults, SPEC, kills)
    assert got == want
    out, fired, sent = got
    assert sent == [signal.SIGUSR1]
    kinds = [f["kind"] for f in fired]
    assert kinds.count("ckpt_io") == 3 and "replica_crash" in kinds
    assert ("serve", {"replica": 0, "batch_index": 3}, "InjectedFault",
            "injected replica 0 crash at batch 3") in out


@pytest.mark.parametrize("seed", range(12))
def test_kill_schedule_equals_jax(seed):
    for rank, max_step, epoch, min_step in ((0, 10, 0, 1), (3, 97, 2, 5)):
        kw = dict(rank=rank, max_step=max_step, epoch=epoch,
                  min_step=min_step, sig="SIGKILL")
        assert faults.make_kill_schedule(seed, **kw) == \
            jfaults.make_kill_schedule(seed, **kw)
    with pytest.raises(ValueError, match="max_step"):
        faults.make_kill_schedule(seed, rank=0, max_step=0, min_step=1)


@pytest.mark.parametrize("spec", [
    {}, {"faults": {}}, {"faults": [{"rank": 0}]}, {"faults": [3]},
    {"faults": [{"kind": "replica_oops"}]},
    {"faults": [{"kind": "frame_gap", "mode": "sideways"}]},
])
def test_malformed_schedules_refused_as_jax(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultInjector(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultInjector(spec)
    assert str(got.value) == str(want.value)


def test_env_trigger_inline_and_path(monkeypatch, tmp_path):
    spec = {"faults": [{"kind": "replica_crash", "replica": 1,
                        "batch": 1}]}
    monkeypatch.setattr(faults, "_CACHED", None)
    monkeypatch.setattr(faults, "_CACHED_SPEC", None)
    monkeypatch.setenv(faults.FAULTS_ENV, json.dumps(spec))
    inj = faults.active_injector()
    assert inj is faults.active_injector()  # cached per spec value
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(spec))
    monkeypatch.setenv(faults.FAULTS_ENV, str(path))
    inj2 = faults.active_injector()
    assert inj2 is not inj and inj2.faults == inj.faults
    with pytest.raises(faults.InjectedFault):
        inj2.on_serve_batch(replica=1, batch_index=1)
    assert faults.FAULTS_ENV == jfaults.FAULTS_ENV == "CAN_TPU_FAULTS"
    assert issubclass(faults.InjectedFault, OSError)


# --- tests/test_autoscale.py::TestServeFaults ----------------------------
class TestServeFaults:
    def test_on_serve_batch_crash_and_hang(self):
        inj = faults.FaultInjector({"faults": [
            {"kind": "replica_crash", "replica": 0, "batch": 2},
            {"kind": "replica_hang", "replica": 1, "batch": 1,
             "delay_s": 0.05}]})
        inj.on_serve_batch(replica=0, batch_index=1)  # no match
        with pytest.raises(faults.InjectedFault):
            inj.on_serve_batch(replica=0, batch_index=2)
        inj.on_serve_batch(replica=0, batch_index=2)  # fires ONCE
        t0 = time.perf_counter()
        inj.on_serve_batch(replica=1, batch_index=1)  # sleeps
        assert time.perf_counter() - t0 >= 0.05
        assert len(inj.fired) == 2

    def test_unknown_kind_rejected_known_kinds_accepted(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultInjector({"faults": [{"kind": "replica_oops"}]})
        faults.FaultInjector({"faults": [{"kind": "replica_crash"},
                                         {"kind": "replica_hang"}]})

    def test_trigger_grammar_documented(self):
        doc = faults.__doc__
        assert "replica_crash" in doc and "replica_hang" in doc

    def test_env_gated_zero_cost(self, monkeypatch):
        monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
        assert faults.active_injector() is None
