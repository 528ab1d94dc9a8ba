"""Elastic shrink-and-continue under spatial parallelism (``--sp``): the
port's world against the JAX package's.

JAX keeps each sp group inside one host, so a leaving host takes its
whole group and the survivors re-form at ``dp' = devices' // sp`` with sp
unchanged.  The port runs one process per GPU (``rank = d * sp + s``), so
its counterpart is a whole replica leaving: ``replica_leavers`` widens
the agreed set, and the survivors re-form at ``(dp - replicas lost,
sp)``.  Held here:

* for a JAX world of H hosts x sp devices and the port's world of H * sp
  ranks with the same leavers (by replica), both packages' ``shrink``
  (runtime and checkpoint writer stubbed) write manifests with equal
  ``world_new`` (dp, sp, devices; the port's processes are JAX's hosts
  times sp), ``lr_scale``, consumed and remaining items, and the leavers
  and survivors map host ``h`` to ranks ``h * sp .. h * sp + sp - 1``; the
  per-rank re-formation plans agree the same way; the remainder's
  ``global_schedule(include=)`` at dp' with the sp padding
  (``resolve_sp_padding``: ``min_bucket_h``, the 8*sp H multiple) is
  JAX's.  Leavers at s != 0, at rank 0, and every replica.
* the train CLI at 4 gloo processes, dp=2 x sp=2, with a seeded SIGTERM
  on rank 1: ranks 0 and 1 exit 143, ranks 2 and 3 re-form at (1, 2), and
  equal a cold restart at 2 processes from the directory as the shrink
  left it, bitwise (every tensor, the step, the loss, MAE and MSE).
* a cold restart at another ``--sp`` than the live manifest's is refused.
"""

import json
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's modules below need it)

import can_tpu.parallel.runtime as jrt
import can_tpu.utils.checkpoint as jck
from can_tpu.cli.common import resolve_sp_padding as jax_sp_padding
from can_tpu.data import CrowdDataset as JaxCrowdDataset
from can_tpu.data import ShardedBatcher as JaxShardedBatcher
from can_tpu.parallel import elastic as jel
from can_tpu_torch.cli import train as train_cli
from can_tpu_torch.cli.common import resolve_sp_padding
from can_tpu_torch.data import CrowdDataset, ShardedBatcher, make_synthetic_dataset
from can_tpu_torch.parallel import elastic as el
from can_tpu_torch.parallel import runtime as rt
from can_tpu_torch.testing.faults import make_kill_schedule
from can_tpu_torch.utils import checkpoint as ck

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests")]
from test_torch_elastic_chaos import (  # noqa: E402
    _assert_state_equal,
    _env,
    _events,
    _run,
    _state,
    shrink_point_copy,
)

N_TRAIN, N_TEST = 8, 4
SIZES = ((64, 64), (64, 96))


# -- the plan and the manifest against JAX's -------------------------------------
class _ItemDs:
    """Items of given (H, W): the batcher reads only the shapes."""

    def __init__(self, shapes):
        self.shapes = shapes

    def __len__(self):
        return len(self.shapes)

    def snapped_shape(self, i):
        return self.shapes[i]


class _NoSave:
    """The shrink's checkpoint writer, stubbed: the plan is under test."""

    def __init__(self, *a, **kw):
        pass

    def save(self, *a, **kw):
        pass

    def wait(self):
        pass

    def close(self):
        pass


def _world(monkeypatch, mod, n, rank=0):
    monkeypatch.setattr(mod, "process_count", lambda: n)
    monkeypatch.setattr(mod, "process_index", lambda: rank)
    monkeypatch.setattr(mod, "is_main_process", lambda: rank == 0)
    monkeypatch.setattr(mod, "generation", lambda: 1)
    monkeypatch.setattr(mod, "barrier", lambda *a, **kw: None)


def _batcher(cls, dp, sp, **extra):
    shapes = [(int(h) * 8, int(w) * 8) for h, w in
              np.random.default_rng(sp * 10 + dp).integers(4, 12, size=(40, 2))]
    pad, min_pad, min_h = (resolve_sp_padding if cls is ShardedBatcher
                           else jax_sp_padding)("auto", sp)
    return cls(_ItemDs(shapes), 1, shuffle=True, seed=5, pad_multiple=pad,
               min_pad_multiple=min_pad, min_bucket_h=min_h, max_buckets=6,
               remnant_sizes=True, process_count=dp, batch_quantum=dp,
               launch_cost_px=300.0, **extra)


@pytest.mark.parametrize("hosts,sp,leavers", [
    (2, 2, {1}),        # s != 0 of replica 0
    (2, 2, {0}),        # rank 0, the checkpoint writer
    (3, 2, {3}),        # replica 1, s = 1
    (4, 2, {0, 7}),     # two replicas, first and last rank
    (2, 4, {2, 5}),     # every replica: the job ends
    (2, 2, {0, 3}),     # every replica at sp = 2
    (3, 1, {1}),        # sp = 1: the widening is the identity
])
def test_widened_plan_and_manifest_match_jax(tmp_path, monkeypatch, hosts, sp, leavers):
    n, dp = hosts * sp, hosts
    widened = el.replica_leavers(leavers, n_processes=n, sp=sp)
    jax_hosts = {r // sp for r in leavers}
    assert widened == {h * sp + s for h in jax_hosts for s in range(sp)}
    # every rank derives its fate as the JAX host holding it does
    for r in range(n):
        got = el.plan_reformation(n_processes=n, leavers=widened, process_index=r)
        want = jel.plan_reformation(n_processes=hosts, leavers=jax_hosts,
                                    process_index=r // sp)
        assert got["leaving"] == want["leaving"]
        assert got["new_num_processes"] == want["new_num_processes"] * sp
        assert got["survivors"] == [h * sp + s for h in want["survivors"] for s in range(sp)]
        assert got["new_process_id"] == (None if want["leaving"]
                                         else want["new_process_id"] * sp + r % sp)

    # both packages' shrink on the same interrupted epoch
    port_b, jax_b = _batcher(ShardedBatcher, dp, sp), _batcher(JaxShardedBatcher, dp, sp,
                                                               plan_mode="cost")
    sched = port_b.global_schedule(0)
    assert sched == jax_b.global_schedule(0)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    _world(monkeypatch, rt, n)
    monkeypatch.setattr(ck, "CheckpointManager", _NoSave)
    got = el.ElasticSupervisor(str(tmp_path / "sig")).shrink(
        el.ElasticInterrupt(steps_done=2, leavers=leavers), state=None, epoch=0,
        checkpoint_dir=str(tmp_path / "port"), schedule=sched, dp=dp, sp=sp,
        batch_size=1)
    _world(monkeypatch, jrt, hosts)
    monkeypatch.setattr(jck, "CheckpointManager", _NoSave)
    monkeypatch.setattr(jel, "_local_device_count", lambda: sp)
    want = jel.ElasticSupervisor(str(tmp_path / "jsig")).shrink(
        jel.ElasticInterrupt(steps_done=2, leavers=jax_hosts), state=None, epoch=0,
        checkpoint_dir=str(tmp_path / "jax"), schedule=jax_b.global_schedule(0),
        dp=dp, sp=sp, batch_size=1)
    assert got == el.load_manifest(str(tmp_path / "port"))
    ranks = lambda hs: sorted(h * sp + s for h in hs for s in range(sp))  # noqa: E731
    assert got["leavers"] == got["leaver_hosts"] == ranks(want["leavers"])
    assert got["survivors"] == got["survivor_hosts"] == ranks(want["survivors"])
    for world in ("world_old", "world_new"):
        g, w = dict(got[world]), dict(want[world])
        assert g.pop("processes") == w.pop("processes") * sp
        assert g == w
    assert got["world_new"]["sp"] == sp
    for k in ("lr_scale", "consumed", "epoch", "steps_done"):
        assert got[k] == want[k], k
    rem = el.remaining_items(got, 40)
    assert rem == jel.remaining_items(want, 40)
    # the remainder replanned at dp' with the sp padding, as JAX plans it
    new_dp = got["world_new"]["dp"]
    if got["survivors"]:
        assert new_dp == dp - len(jax_hosts)
        assert (_batcher(ShardedBatcher, new_dp, sp).global_schedule(0, set(rem))
                == _batcher(JaxShardedBatcher, new_dp, sp, plan_mode="cost")
                .global_schedule(0, set(rem)))


def test_widening_refuses_a_world_sp_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        el.replica_leavers({1}, n_processes=5, sp=2)


# -- the train CLI at dp=2 x sp=2 over gloo ----------------------------------------
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_sp_data")
    make_synthetic_dataset(str(root / "train_data"), N_TRAIN, sizes=SIZES, seed=0)
    make_synthetic_dataset(str(root / "test_data"), N_TEST, sizes=SIZES, seed=1)
    return root


def _argv(data, ckpt, tel, sig):
    return ["--platform", "cpu", "--data_root", str(data), "--syncBN",
            "--bn-impl", "kernel", "--batch-size", "1", "--epochs", "1", "--sp", "2",
            "--lr", "1e-6", "--seed", "0", "--num-workers", "0",
            "--prepared-root", "off", "--checkpoint-dir", str(ckpt),
            "--telemetry-dir", str(tel), "--elastic-dir", str(sig),
            "--elastic-check-every", "1"]


def _world_env(rdv, n, r, **extra):
    return _env(COORDINATOR_ADDRESS=rdv, NUM_PROCESSES=str(n), PROCESS_ID=str(r), **extra)


def test_sp_shrink_equals_cold_restart(synth, tmp_path):
    ckpt, tel, sig = tmp_path / "ck", tmp_path / "tel", tmp_path / "sig"
    faults = make_kill_schedule(13, rank=1, max_step=2, min_step=1)
    fault_file = tmp_path / "faults.json"
    fault_file.write_text(json.dumps(faults))
    rdv = f"file://{tmp_path}/rdv"
    outs = _run([(_argv(synth, ckpt, tel, sig),
                  _world_env(rdv, 4, r, CAN_TPU_FAULTS=str(fault_file)))
                 for r in range(4)])
    report = "\n".join(f"rank {r} rc {rc}\n{out[-3000:]}\n{err[-3000:]}"
                       for r, (rc, out, err) in enumerate(outs))
    # rank 1 was preempted; rank 0, its replica's partner, leaves with it
    assert [rc for rc, _, _ in outs] == [143, 143, 0, 0], report
    assert "[elastic] leaving after the shrink checkpoint" in outs[0][1], report
    assert "dp2 -> 2proc/dp1 (sp 2)" in outs[2][1] and "(in_process)" in outs[2][1], report

    # one transition per survivor, both the same record
    events = _events(tel, "elastic.transition")
    assert sorted(e["host_id"] for e in events) == [2, 3], events
    t = events[0]["payload"]
    assert events[1]["payload"] == t
    assert (t["processes_old"], t["processes_new"]) == (4, 2)
    assert (t["dp_old"], t["dp_new"], t["lr_scale"]) == (2, 1, 0.5)
    assert (t["global_batch_old"], t["global_batch_new"]) == (4, 1)
    assert t["leavers"] == [0, 1] and t["resumed_from"] == "in_process"
    assert t["remaining_items"] > 0 and t["steps_done"] >= faults["faults"][0]["step"]

    m = el.load_manifest(str(ckpt))
    assert (m["leavers"], m["survivors"]) == ([0, 1], [2, 3])
    assert m["world_old"] == {"processes": 4, "dp": 2, "sp": 2, "devices": 4, "batch_size": 1}
    assert m["world_new"] == {"processes": 2, "dp": 1, "sp": 2, "devices": 2}
    rem = el.remaining_items(m, N_TRAIN)
    consumed = set(m["consumed"])
    assert consumed | set(rem) == set(range(N_TRAIN)) and not consumed & set(rem)
    assert len(consumed) == 2 * t["steps_done"]  # batch 1 x 2 replicas, no fill

    # JAX's plan of the remainder at dp' = 1 with the sp padding is what the
    # survivors trained
    jm = jel.load_manifest(str(ckpt))
    assert jm == m and jel.remaining_items(jm, N_TRAIN) == rem
    roots = (str(synth / "train_data" / "images"), str(synth / "train_data" / "ground_truth"))
    pad, min_pad, min_h = jax_sp_padding("auto", 2)
    kw = dict(shuffle=True, seed=0, pad_multiple=pad, min_pad_multiple=min_pad,
              min_bucket_h=min_h, max_buckets=24, remnant_sizes=True, batch_quantum=1,
              launch_cost_px=860.0)
    want = JaxShardedBatcher(JaxCrowdDataset(*roots, prepared="off"), 1, plan_mode="cost",
                             **kw).global_schedule(0, set(rem))
    assert resolve_sp_padding("auto", 2) == (pad, min_pad, min_h)
    got = ShardedBatcher(CrowdDataset(*roots, prepared="off"), 1, **kw).global_schedule(
        0, set(rem))
    assert got == want
    steps_after = int(re.search(r"\[metrics\] step 0 .*\bsteps=(\d+)", outs[2][1])[1])
    assert steps_after == len(want)

    # the cold restart at 2 processes (1, 2) from the directory as the
    # shrink left it
    snap, ck_cold, tel_cold = tmp_path / "snap", tmp_path / "ck_cold", tmp_path / "tel_cold"
    shrink_point_copy(ckpt, snap, m)
    argv = _argv(synth, ck_cold, tel_cold, tmp_path / "sig_cold") + [
        "--init_checkpoint", str(snap)]
    cold = _run([(argv, _world_env(f"file://{tmp_path}/rdv_cold", 2, r)) for r in range(2)])
    assert [rc for rc, _, _ in cold] == [0, 0], "\n".join(o + e for _, o, e in cold)
    assert "world_size 2 -> 1" in cold[0][1] and "(cold_restart)" in cold[0][1]
    cold_t = _events(tel_cold, "elastic.transition")
    assert len(cold_t) == 2 and cold_t[0]["payload"]["resumed_from"] == "cold_restart"
    same = lambda p: {k: v for k, v in p.items()  # noqa: E731
                      if k not in ("resumed_from", "generation_new")}
    assert same(cold_t[0]["payload"]) == same(t)
    _assert_state_equal(_state(ckpt, 0), _state(ck_cold, 0))
    assert (ckpt / "0" / "metrics.json").read_text() == \
        (ck_cold / "0" / "metrics.json").read_text()
    (ep,) = [e for e in _events(tel, "epoch") if e["host_id"] == 2]
    (ep_cold,) = [e for e in _events(tel_cold, "epoch") if e["host_id"] == 0]
    for k in ("train_loss", "mae", "mse", "lr"):
        assert ep["payload"][k] == ep_cold["payload"][k], k

    # a cold restart at another sp than the live manifest's is refused
    # before any work
    with pytest.raises(SystemExit, match="re-forms at --sp 2, not 1"):
        train_cli.validate(train_cli.parse_args(
            _argv(synth, tmp_path / "x", tel_cold, sig)[:-2]
            + ["--sp", "1", "--init_checkpoint", str(snap)]))
    for d in (ckpt, snap, ck_cold):  # ~150 MB a state; a failure keeps them
        shutil.rmtree(d)
    assert not os.path.exists(ckpt)
