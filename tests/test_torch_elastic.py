"""The port's elastic layer against the JAX package's, one process (the
two-process choreography is tests/test_torch_elastic_chaos.py).

The same inputs go through ``can_tpu.parallel.elastic`` /
``can_tpu.data.ShardedBatcher`` and their counterparts in the port; host
values are compared exactly:

* the manifest (written by either package, read by the other), the
  liveness rule, ``consumed_items`` / ``remaining_items`` on seeded
  schedules;
* ``plan_reformation``, ``reform_coordinator`` and the drift guard's
  elastic allowance on the tables of tests/test_elastic.py;
* ``global_schedule(include=)`` over seeded size lists, include sets and
  quanta 1-4, memoised; ``epoch(include=)`` yields the subset;
* the supervisor's step hook, SIGTERM hook, stale signals, the shrink's
  sweep, the bounded agreement, the transition event's payload;
* the barrier and ``ckpt_io`` fault hooks (typed errors, retries);
* the runtime's generations (2 -> 1 -> 2 processes) and
  ``env_rendezvous=False``;
* the train CLI: ``--elastic-check-every 0`` and ``--sp`` refused, the
  drift guard over a manifest-only checkpoint, an armed run at world 1;
* ``tools/run_monitor.py --emit-signal`` driving the port's supervisor.
"""

import json
import os
import shutil
import signal
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules below need it)

from can_tpu.data.batching import ShardedBatcher as JaxShardedBatcher
from can_tpu.parallel import elastic as jel
from can_tpu.utils import checkpoint as jck
from can_tpu_torch.cli import train as train_cli
from can_tpu_torch.data import ShardedBatcher, make_synthetic_dataset
from can_tpu_torch.data.batching import Batch
from can_tpu_torch.data.planner import schedule_coverage
from can_tpu_torch.obs import signals as sig
from can_tpu_torch.parallel import elastic as el
from can_tpu_torch.parallel import runtime as rt
from can_tpu_torch.testing import faults as flt
from can_tpu_torch.utils import checkpoint as ck

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from test_torch_parallel import spawn  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_runtime():
    rt.shutdown_runtime()
    yield
    rt.shutdown_runtime()


def _manifest(epoch=0, steps=1, consumed=(0, 1), generation=1):
    return {"schema": el.MANIFEST_SCHEMA, "ts": 123.0,
            "generation": generation, "transition_id": generation,
            "epoch": epoch, "steps_done": steps,
            "consumed": list(consumed), "reason": "preemption",
            "leavers": [1], "survivors": [0],
            "world_old": {"processes": 2, "dp": 2, "sp": 1, "devices": 2,
                          "batch_size": 4},
            "world_new": {"processes": 1, "dp": 1, "sp": 1, "devices": 1},
            "lr_scale": 0.5}


# -- the manifest ---------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [(el, jel), (jel, el), (el, el)])
def test_manifest_round_trip_across_packages(tmp_path, writer, reader):
    m = _manifest(epoch=3, consumed=(5, 0, 2))
    writer.save_manifest(str(tmp_path), m)
    assert reader.load_manifest(str(tmp_path)) == m
    assert (tmp_path / el.MANIFEST_NAME).read_text() == \
        json.dumps(m, indent=1, sort_keys=True)
    assert el.MANIFEST_NAME == jel.MANIFEST_NAME
    assert el.ELASTIC_SUBDIR == jel.ELASTIC_SUBDIR
    assert el.LEAVE_EXIT_CODE == jel.LEAVE_EXIT_CODE == 143


@pytest.mark.parametrize("content", [None, "{torn", '{"schema": "v0"}', "[1, 2]"])
def test_absent_torn_and_foreign_manifests_read_as_none(tmp_path, content):
    if content is not None:
        (tmp_path / el.MANIFEST_NAME).write_text(content)
    assert el.load_manifest(str(tmp_path)) is None
    assert jel.load_manifest(str(tmp_path)) is None


@pytest.mark.parametrize("epoch,latest", [(3, None), (3, 2), (3, 3), (3, 7),
                                          (0, None), (0, 0), (None, None)])
def test_liveness_rule(epoch, latest):
    m = None if epoch is None else _manifest(epoch=epoch)
    assert el.manifest_is_live(m, latest) == jel.manifest_is_live(m, latest)
    assert el.manifest_is_live(m, latest) == (m is not None and (latest is None
                                                                  or latest < epoch))


def _seeded_schedule(seed, n=24):
    rng = np.random.default_rng(seed)
    order = rng.permutation(n).tolist()
    sched = []
    while order:
        size = int(rng.integers(1, 5))
        group = [(i, True) for i in order[:size]]
        order = order[size:]
        pad = int(rng.integers(0, 3))
        sched.append(((64, 64), group + [(group[0][0], False)] * pad))
    return sched


@pytest.mark.parametrize("seed", range(4))
def test_consumed_and_remaining_items_match_jax(seed):
    sched = _seeded_schedule(seed)
    for steps in range(len(sched) + 2):
        got = el.consumed_items(sched, steps)
        assert got == jel.consumed_items(sched, steps)
        m = _manifest(consumed=got)
        rem = el.remaining_items(m, 24)
        assert rem == jel.remaining_items(m, 24)
        assert sorted(set(got) | set(rem)) == list(range(24)) and not set(got) & set(rem)
    with pytest.raises(ValueError, match="outside the dataset"):
        el.remaining_items(_manifest(consumed=(0, 30)), 24)


# -- re-formation planning and the drift guard ----------------------------------
def _outcome(fn, **kw):
    try:
        return ("ok", fn(**kw))
    except (ValueError, RuntimeError) as e:
        return ("raises", type(e).__name__, str(e))


@pytest.mark.parametrize("n,leavers,index", [(4, {1, 3}, 2), (2, {1}, 1), (2, {1}, 0),
                                             (4, {0}, 3), (2, {5}, 0), (2, set(), 0),
                                             (3, {0, 1, 2}, 1)])
def test_plan_reformation_matches_jax(n, leavers, index):
    kw = dict(n_processes=n, leavers=leavers, process_index=index)
    assert _outcome(el.plan_reformation, **kw) == _outcome(jel.plan_reformation, **kw)


@pytest.mark.parametrize("survivors", [[0], [1, 2], [0, 1], [2, 3]])
def test_reform_coordinator_matches_jax(tmp_path, survivors):
    d = str(tmp_path)
    sig.write_signal(d, kind="stay", host_id=1, reason="reform",
                     detail={"address": "hostb:8577"})
    sig.write_signal(d, kind="stay", host_id=2, reason="reform",
                     detail={"address": "hostc:8577"})
    kw = dict(signal_dir=d, survivors=survivors, generation=1)
    got = _outcome(el.reform_coordinator, **kw)
    assert got == _outcome(jel.reform_coordinator, **kw)
    assert got[0] == ("raises" if survivors == [0, 1] else "ok")


def test_reform_address_is_a_free_port_on_this_host():
    host, port = el.reform_address().rsplit(":", 1)
    assert host and 0 < int(port) < 65536
    import socket

    with socket.socket() as s:  # free now: a re-rendezvous can bind it
        s.bind(("", int(port)))


SAVED = {"lr": 1e-7, "epochs": 10, "world_size": 8}


@pytest.mark.parametrize("current,allow,allow_elastic", [
    ({"lr": 1e-7, "epochs": 10, "world_size": 4}, False, True),
    ({"lr": 1e-7, "epochs": 10, "world_size": 4}, False, False),
    ({"lr": 5e-7, "epochs": 10, "world_size": 4}, False, True),
    ({"lr": 5e-7, "epochs": 10, "world_size": 4}, True, False),
    ({"lr": 1e-7, "epochs": 10, "world_size": 8}, False, True)])
def test_drift_guard_elastic_allowance_matches_jax(current, allow, allow_elastic):
    kw = dict(saved=SAVED, current=current, allow=allow, allow_elastic=allow_elastic)

    def run(mod):
        try:
            return ("ok", mod.check_resume_config(**kw))
        except ValueError as e:  # ConfigDriftError in each package
            return ("raises", str(e))

    assert run(ck) == run(jck)
    assert ck.ELASTIC_DRIFT_KEYS == jck.ELASTIC_DRIFT_KEYS


# -- the remainder's schedule --------------------------------------------------
class _ItemDs:
    """Shapes, and items whose pixels name their index."""

    def __init__(self, shapes):
        self.shapes = list(shapes)

    def __len__(self):
        return len(self.shapes)

    def snapped_shape(self, i):
        return self.shapes[i]

    def __getitem__(self, i, rng=None):
        h, w = self.shapes[i]
        return (np.full((h, w, 3), i, np.float32),
                np.full((h // 8, w // 8, 1), i, np.float32))


def _shapes(n, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(3, 9)) * 8, int(rng.integers(3, 9)) * 8) for _ in range(n)]


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["exact", "auto-remnant"])
def test_subset_schedule_matches_jax(dp, mode):
    shapes = _shapes(30, dp)
    kw = {"exact": dict(pad_multiple=None),
          "auto-remnant": dict(pad_multiple="auto", max_buckets=4, remnant_sizes=True,
                               batch_quantum=dp, launch_cost_px=300.0)}[mode]
    common = dict(shuffle=True, seed=3, process_index=0, process_count=dp, **kw)
    port = ShardedBatcher(_ItemDs(shapes), 2, **common)
    ref = JaxShardedBatcher(_ItemDs(shapes), 2, plan_mode="cost", **common)
    rng = np.random.default_rng(dp)
    for epoch in (0, 1):
        assert port.global_schedule(epoch, None) == port.global_schedule(epoch)
        for _ in range(3):
            include = set(rng.choice(30, size=int(rng.integers(1, 30)), replace=False).tolist())
            got = port.global_schedule(epoch, include)
            assert got == ref.global_schedule(epoch, include)
            assert schedule_coverage(got) == {i: 1 for i in sorted(include)}
            # memoised: the same subset (any iterable of it) is not rebuilt
            assert port.global_schedule(epoch, frozenset(include)) is got
            assert port.global_schedule(epoch, sorted(include)) is got


def test_epoch_yields_only_the_subset():
    shapes = _shapes(20, 7)
    b = ShardedBatcher(_ItemDs(shapes), 2, shuffle=True, seed=3, pad_multiple=None)
    include = {1, 4, 5, 9, 13, 17, 18}
    seen = []
    for batch in b.epoch(0, include):
        valid = batch.sample_mask > 0
        seen += [int(batch.image[i, 0, 0, 0]) for i in np.flatnonzero(valid)]
    assert sorted(seen) == sorted(include)
    assert b.global_schedule(1, include) is not b.global_schedule(0, include)


# -- the supervisor -------------------------------------------------------------
def _two_rank_world(monkeypatch, rank=0):
    """A world of 2 seen from one process: the agreement returns this
    process's own mask (what a peer with nothing to report leaves)."""
    monkeypatch.setattr(rt, "process_count", lambda: 2)
    monkeypatch.setattr(rt, "process_index", lambda: rank)
    monkeypatch.setattr(rt, "agree_max_value", lambda mask: mask)


@pytest.mark.parametrize("pkg", [el, jel])
def test_leave_file_interrupts_at_poll_boundary(tmp_path, pkg):
    sup = pkg.ElasticSupervisor(str(tmp_path / "sig"), check_every=2)
    hook = sup.step_hook(0)
    hook(1)  # the first step polls: nothing yet
    sig.write_signal(str(tmp_path / "sig"), kind="leave", host_id=0, reason="sigterm")
    hook(3)  # off the cadence
    with pytest.raises(pkg.ElasticInterrupt) as ei:
        hook(4)
    assert (ei.value.steps_done, ei.value.leavers) == (4, {0})


@pytest.mark.parametrize("pkg", [el, jel])
def test_first_step_polls_on_short_epochs(tmp_path, pkg):
    sup = pkg.ElasticSupervisor(str(tmp_path / "sig"), check_every=4)
    sig.write_signal(str(tmp_path / "sig"), kind="leave", host_id=0, reason="sigterm")
    with pytest.raises(pkg.ElasticInterrupt):
        sup.step_hook(0)(1)


@pytest.mark.parametrize("pkg", [el, jel])
def test_stale_signal_cannot_cascade(tmp_path, pkg):
    d = str(tmp_path / "sig")
    sup = pkg.ElasticSupervisor(d, check_every=1)
    sup.adopt_manifest({"survivor_hosts": [0], "leaver_hosts": [1]})
    sig.write_signal(d, kind="leave", host_id=1, reason="sigterm")
    sup.step_hook(0)(1)  # a handled host's stale file: no interrupt
    sig.write_signal(d, kind="dead", host_id=1, reason="heartbeat_stale")
    sup.step_hook(0)(2)
    sig.write_signal(d, kind="dead", host_id=0, reason="heartbeat_stale")
    with pytest.raises(pkg.ElasticInterrupt) as ei:
        sup.step_hook(0)(3)  # a current member's new signal still shrinks
    assert ei.value.leavers == {0}


def test_renumbered_survivor_maps_signals_to_original_hosts(tmp_path, monkeypatch):
    """After 4 -> 3 (host 0 left), current rank 0 is host 1: a dead file
    for host 2 names current rank 1, and a kill fault for launch rank 2
    reaches the process of current rank 1."""
    _two_rank_world(monkeypatch)
    monkeypatch.setattr(rt, "process_count", lambda: 3)
    d = str(tmp_path / "sig")
    sup = el.ElasticSupervisor(d, check_every=1)
    sup.adopt_manifest({"survivor_hosts": [1, 2, 3], "leaver_hosts": [0]})
    sig.write_signal(d, kind="dead", host_id=2, reason="heartbeat_stale")
    with pytest.raises(el.ElasticInterrupt) as ei:
        sup.step_hook(0)(1)
    assert ei.value.leavers == {1}


@pytest.mark.parametrize("pkg", [el, jel])
def test_sigterm_hook_sets_flag_and_writes_leave_file(tmp_path, pkg):
    if pkg is jel:
        from can_tpu.parallel import runtime as jrt

        jrt.init_runtime()
    sup = pkg.ElasticSupervisor(str(tmp_path / "sig"), check_every=1)
    assert sup.install_signal_hook() is not None
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if sup._leaving:
                break
            time.sleep(0.01)
        assert sup._leaving
    finally:
        sup.close()
    docs = sig.read_signals(str(tmp_path / "sig"))
    assert [(d["kind"], d["host_id"], d["reason"]) for d in docs] == [("leave", 0, "sigterm")]
    with pytest.raises(pkg.ElasticInterrupt) as ei:
        sup.step_hook(0)(1)
    assert ei.value.reason == "sigterm"


def _tiny_state():
    from can_tpu_torch.train import create_train_state, make_lr_schedule

    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    state = create_train_state(model, make_lr_schedule(1e-2))
    model(torch.randn(5, 4)).sum().backward()
    state.apply_update()
    return state


def test_shrink_writes_checkpoint_manifest_and_sweeps(tmp_path):
    rt.init_runtime(platform="cpu")
    d = str(tmp_path / "sig")
    sup = el.ElasticSupervisor(d, check_every=1)
    sig.write_signal(d, kind="leave", host_id=0, reason="sigterm")
    state = _tiny_state()
    sched = [((64, 64), [(0, True), (1, True)]), ((64, 64), [(2, True), (2, False)])]
    m = sup.shrink(el.ElasticInterrupt(steps_done=2, leavers={0}), state=state, epoch=0,
                   checkpoint_dir=str(tmp_path / "ck"), schedule=sched, dp=1,
                   batch_size=2, prior_consumed=(7,))
    assert m == el.load_manifest(str(tmp_path / "ck")) == jel.load_manifest(str(tmp_path / "ck"))
    assert (m["consumed"], m["leaver_hosts"], m["steps_done"]) == ([0, 1, 2, 7], [0], 2)
    assert m["transition_id"] == m["generation"] == rt.generation()
    assert 0 in sup._handled and sig.read_signals(d) == []
    assert {"shrink_saved", "shrink_barrier"} <= set(sup.timeline)
    fresh = _tiny_state()
    ck.CheckpointManager(str(tmp_path / "ck" / el.ELASTIC_SUBDIR)).restore(
        fresh, epoch=m["transition_id"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, fresh.model.state_dict()[k])
    assert fresh.step == state.step
    assert sup.leave() == 143 and not rt.runtime_active()


def test_agreement_is_bounded(monkeypatch):
    monkeypatch.setattr(rt, "process_count", lambda: 2)
    monkeypatch.setattr(rt, "agree_max_value", lambda mask: time.sleep(30))
    t0 = time.monotonic()
    with pytest.raises(rt.RendezvousTimeoutError) as ei:
        el._bounded_agree(np.zeros((2,), np.float32), generation=1, timeout_s=0.2)
    assert time.monotonic() - t0 < 5
    assert ei.value.barrier == "elastic-agreement" and "hard death" in str(ei.value)


class _Recorder:
    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))


@pytest.mark.parametrize("resumed_from", ["in_process", "cold_restart"])
def test_transition_event_matches_jax(resumed_from):
    m = _manifest(consumed=(0, 1, 2))
    got, want = _Recorder(), _Recorder()
    kw = dict(new_dp=1, remaining=5, global_batch_new=4, resumed_from=resumed_from)
    el.emit_transition(got, m, {"generation": 2, "process_count": 1}, **kw)
    jel.emit_transition(want, m, {"generation": 2, "process_count": 1}, **kw)
    assert got.events == want.events and got.events[0][0] == "elastic.transition"
    el.emit_transition(None, m, {}, **kw)  # no telemetry: nothing


def test_loop_attaches_live_state_and_skips_incident(tmp_path):
    from can_tpu_torch import obs
    from can_tpu_torch.train import train_one_epoch

    recorder = obs.FlightRecorder()
    tel = obs.Telemetry([recorder])
    mgr = obs.IncidentManager(tel, recorder, incident_dir=str(tmp_path / "inc"))
    tel.watchers.append(mgr)
    tel.incidents = mgr
    batch = Batch(image=np.zeros((1, 8, 8, 3), np.float32),
                  dmap=np.zeros((1, 1, 1, 1), np.float32),
                  pixel_mask=np.ones((1, 1, 1, 1), np.float32),
                  sample_mask=np.ones((1,), np.float32))
    put = lambda b: {"image": torch.from_numpy(b.image)}  # noqa: E731

    def step(state, dev):
        return state + 1, {"loss": torch.tensor(1.0), "num_valid": torch.tensor(1.0)}

    def on_step(s):
        if s == 2:
            raise el.ElasticInterrupt(steps_done=s, leavers={1})

    with pytest.raises(el.ElasticInterrupt) as ei:
        train_one_epoch(step, 0, [batch] * 5, put_fn=put, prefetch=2, telemetry=tel,
                        on_step=on_step)
    assert (ei.value.state, ei.value.steps_done) == (2, 2)  # the post-step state
    assert mgr.bundles_written == 0  # control flow, not an incident

    def boom(s):
        raise RuntimeError("loader exploded")

    with pytest.raises(RuntimeError):
        train_one_epoch(step, 0, [batch] * 3, put_fn=put, prefetch=0, telemetry=tel,
                        on_step=boom)
    assert mgr.bundles_written == 1
    tel.close()


# -- fault hooks ------------------------------------------------------------------
def test_barrier_fault_holds_its_rank_then_the_typed_timeout(monkeypatch):
    monkeypatch.setenv(flt.FAULTS_ENV, json.dumps({"faults": [
        {"kind": "rendezvous_timeout", "barrier": "elastic-shrink", "rank": 0,
         "delay_s": 0.2}]}))
    monkeypatch.setattr(rt, "process_count", lambda: 2)
    monkeypatch.setattr(rt, "process_index", lambda: 0)
    monkeypatch.setattr(rt, "_host_group", lambda: None)

    def missing(**kw):
        raise RuntimeError("Rank 1 failed to pass monitoredBarrier in 100 ms")

    monkeypatch.setattr(rt.dist, "monitored_barrier", missing)
    t0 = time.monotonic()
    with pytest.raises(rt.RendezvousTimeoutError) as ei:
        rt.barrier("elastic-shrink-g3", timeout_s=0.1)
    assert time.monotonic() - t0 >= 0.2  # held by the fault first
    assert (ei.value.barrier, ei.value.missing) == ("elastic-shrink-g3", [1])
    t0 = time.monotonic()
    with pytest.raises(rt.RendezvousTimeoutError):
        rt.barrier("elastic-shrink-g4", timeout_s=0.1)  # the fault fires once
    assert time.monotonic() - t0 < 0.2


@pytest.mark.parametrize("fails,retries,rank,outcome", [
    (2, 3, None, "ok"), (99, 2, None, "give-up"), (2, 3, 1, "untouched"),
    (1, 2, 0, "ok")])
def test_ckpt_io_faults_ride_the_retry_loop(tmp_path, monkeypatch, fails, retries, rank,
                                            outcome):
    fault = {"kind": "ckpt_io", "op": "save", "fails": fails}
    if rank is not None:
        fault["rank"] = rank
    monkeypatch.setenv(flt.FAULTS_ENV, json.dumps({"faults": [fault]}))
    mgr = ck.CheckpointManager(str(tmp_path / "ck"), retries=retries, backoff_s=0.001)
    state = _tiny_state()
    if outcome == "give-up":
        with pytest.raises(ck.CheckpointIOError) as ei:
            mgr.save(0, state, mae=1.0)
        assert (ei.value.op, ei.value.attempts) == ("save", retries)
        assert isinstance(ei.value.__cause__, flt.InjectedFault)
        return
    assert mgr.save(0, state, mae=1.0) and mgr.latest_epoch() == 0
    inj = flt.active_injector()
    assert len(inj.fired) == (0 if outcome == "untouched" else fails)
    # restore is another op: untouched by a save fault
    mgr.restore(_tiny_state(), epoch=0)


# -- the runtime's generations --------------------------------------------------
def test_env_rendezvous_false_ignores_the_launchers_world(monkeypatch):
    for k, v in dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1", LOCAL_RANK="3").items():
        monkeypatch.setenv(k, v)
    g0 = rt.generation()
    topo = rt.init_runtime(platform="cpu", env_rendezvous=False)
    assert (topo["process_count"], topo["source"], topo["local_rank"]) == (
        1, "single process", 0)
    assert topo["generation"] == g0 + 1 and rt.topology() == topo
    rt.shutdown_runtime(reset=True)
    assert rt.topology() is None
    with pytest.raises(ValueError, match="device="):
        rt.init_runtime(env_rendezvous=False)  # the card from a stale LOCAL_RANK
    topo = rt.init_runtime(device=torch.device("cpu"), env_rendezvous=False)
    assert topo["generation"] == g0 + 2 and topo["device"] == "cpu"


def test_three_generations_at_worlds_2_1_2(tmp_path):
    outs = spawn(tmp_path, "cycles", 2, script=Path(__file__))
    for rank, out in enumerate(outs):
        worlds = [(t["process_count"], t["process_index"], t["backend"])
                  for t in out["topologies"]]
        assert worlds == ([(2, rank, "gloo"), (1, 0, None), (2, rank, "gloo")] if rank == 0
                          else [(2, rank, "gloo"), (2, rank, "gloo")])
        gens = [t["generation"] for t in out["topologies"]]
        assert gens == sorted(gens) and len(set(gens)) == len(gens)
        assert out["sums"] == [3.0, 3.0]


def _cycles_worker(rdv, nproc, rank):
    topos, sums = [], []

    def world(tag):
        topo = rt.init_runtime(platform="cpu", coordinator_address=f"{rdv}-{tag}",
                               num_processes=nproc, process_id=rank, env_rendezvous=False)
        topos.append(topo)
        sums.append(float(rt.reduce_value(np.float64(rank + 1), average=False)))
        rt.barrier(f"cycle-{tag}", timeout_s=60)
        rt.shutdown_runtime(reset=True)

    world("a")
    if rank == 0:  # a world of one while rank 1 waits at the next rendezvous
        topos.append(rt.init_runtime(device=torch.device("cpu"), env_rendezvous=False))
        rt.shutdown_runtime(reset=True)
    world("b")
    return {"topologies": topos, "sums": sums}


# -- the train CLI ---------------------------------------------------------------
@pytest.mark.parametrize("argv,match", [
    (["--elastic-check-every", "0"], "elastic-check-every"),
    (["--elastic-dir", "/tmp/x", "--sp", "2"], "item 6b")])
def test_cli_refuses_before_any_work(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_cli.train(train_cli.parse_args(["--data_root", "/nonexistent"] + argv))


def test_drift_guard_covers_manifest_only_checkpoints(tmp_path):
    ckpt = tmp_path / "ck"
    ck.save_run_config(str(ckpt), {"lr": 1e-7, "lrf": 1.0, "epochs": 500,
                                   "batch_size": 1, "seed": 0, "syncBN": False,
                                   "bf16": False, "world_size": 8})
    el.save_manifest(str(ckpt), _manifest(epoch=0))
    for split in ("train", "test"):
        for leaf in ("images", "ground_truth"):
            os.makedirs(tmp_path / "d" / f"{split}_data" / leaf)
    with pytest.raises(SystemExit, match="config drift"):
        train_cli.train(train_cli.parse_args(
            ["--data_root", str(tmp_path / "d"), "--init_checkpoint", str(ckpt),
             "--epochs", "4", "--platform", "cpu"]))


def test_armed_run_at_world_1_trains_and_records_its_world(tmp_path):
    root = tmp_path / "data"
    make_synthetic_dataset(str(root / "train_data"), 4, sizes=((64, 64),), seed=3)
    make_synthetic_dataset(str(root / "test_data"), 2, sizes=((64, 64),), seed=4)
    before = signal.getsignal(signal.SIGTERM)
    out = train_cli.train(train_cli.parse_args(
        ["--data_root", str(root), "--epochs", "1", "--batch-size", "1",
         "--checkpoint-dir", str(tmp_path / "ck"), "--platform", "cpu",
         "--num-workers", "0", "--prepared-root", "off",
         "--elastic-dir", str(tmp_path / "sig"), "--elastic-check-every", "1",
         "--telemetry-dir", str(tmp_path / "tel")]))
    assert (out["exit_code"], out["generations"], out["steps"], out["world_size"]) == (0, 1, 4, 1)
    assert ck.load_run_config(str(tmp_path / "ck"))["world_size"] == 1
    kinds = [json.loads(line)["kind"] for line in
             (tmp_path / "tel" / "telemetry.host0.jsonl").read_text().splitlines()]
    assert "elastic.transition" not in kinds and "epoch" in kinds
    assert el.load_manifest(str(tmp_path / "ck")) is None
    assert signal.getsignal(signal.SIGTERM) is before  # the hook restored
    shutil.rmtree(tmp_path / "ck")  # ~70 MB of state


# -- the monitor drives the supervisor -------------------------------------------
def test_run_monitor_dead_signal_drives_the_port_supervisor(tmp_path, monkeypatch):
    from test_health import write_host_file

    from tools.run_monitor import main as monitor_main

    d = str(tmp_path / "run")
    os.makedirs(d)
    write_host_file(d, 0, step_s=0.1, t_end=1100.0)
    write_host_file(d, 1, step_s=0.1, t_end=1000.0)  # silent: dead
    sigdir = str(tmp_path / "sig")
    assert monitor_main([d, "--stale-after-s", "30", "--emit-signal", sigdir]) == 1
    _two_rank_world(monkeypatch)
    sup = el.ElasticSupervisor(sigdir, check_every=4)
    with pytest.raises(el.ElasticInterrupt) as ei:
        sup.step_hook(0)(1)
    assert (ei.value.leavers, ei.value.reason) == ({1}, "peer_signal")


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, rdv, nproc, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    assert mode == "cycles", mode
    print(json.dumps(_cycles_worker(rdv, nproc, rank)))
