"""The port's elastic chaos test (counterpart of
``tests/test_multiprocess.py::test_elastic_shrink_and_continue``): the
train CLI at two gloo processes, a seeded SIGTERM on one of them.

``python -m can_tpu_torch.cli.train --elastic-dir --elastic-check-every 1``
runs as two processes joined by a ``file://`` rendezvous, batch 1 each, on
a tiny synthetic set (64x64 and 64x96 items).  ``CAN_TPU_FAULTS`` SIGTERMs
the leaver (rank 1, and in a second case rank 0, the checkpoint writer)
at a step drawn from a seed.  Held to:

* the leaver exits 143 and the survivor 0;
* exactly one ``elastic.transition`` event (2 processes -> 1), a live
  manifest naming the leaver, consumed and remaining items partitioning
  the epoch;
* a cold restart at world 1 from the checkpoint directory as the shrink
  left it ends bitwise equal to the survivor: every parameter, momentum
  buffer and running statistic, the step, the epoch's loss, MAE and MSE;
* the JAX package's ``remaining_items`` and ``global_schedule(include=)``
  on the port's manifest plan the remainder the survivor trained.

Every process has a timeout; OMP_NUM_THREADS=1 everywhere, so the
survivor and the cold restart compute with the same thread count.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules below need it)

from can_tpu.data import CrowdDataset as JaxCrowdDataset
from can_tpu.data import ShardedBatcher as JaxShardedBatcher
from can_tpu.parallel import elastic as jel
from can_tpu_torch.data import CrowdDataset, ShardedBatcher, make_synthetic_dataset
from can_tpu_torch.parallel import elastic as el
from can_tpu_torch.testing.faults import make_kill_schedule
from can_tpu_torch.utils.checkpoint import RUN_CONFIG_NAME

ROOT = Path(__file__).resolve().parents[1]
PROC_TIMEOUT_S = 120
N_TRAIN, N_TEST = 8, 4
SIZES = ((64, 64), (64, 96))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic_data")
    make_synthetic_dataset(str(root / "train_data"), N_TRAIN, sizes=SIZES, seed=0)
    make_synthetic_dataset(str(root / "test_data"), N_TEST, sizes=SIZES, seed=1)
    return root


def _argv(data, ckpt, tel, sig):
    return ["--platform", "cpu", "--data_root", str(data), "--syncBN",
            "--bn-impl", "kernel", "--batch-size", "1", "--epochs", "1",
            "--lr", "1e-6", "--seed", "0", "--num-workers", "0",
            "--prepared-root", "off", "--checkpoint-dir", str(ckpt),
            "--telemetry-dir", str(tel), "--elastic-dir", str(sig),
            "--elastic-check-every", "1"]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "CAN_TPU_FAULTS"):
        env.pop(var, None)
    env.update(extra)
    return env


def _run(cmds):
    """Start every (argv, env) at once; returns [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen([sys.executable, "-m", "can_tpu_torch.cli.train", *argv],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=PROC_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _events(tel_dir, kind):
    out = []
    for path in sorted(Path(tel_dir).glob("telemetry.host*.jsonl")):
        for line in path.read_text().splitlines():
            ev = json.loads(line)
            if ev.get("kind") == kind:
                out.append(ev)
    return out


def shrink_point_copy(ckpt: Path, dst: Path, manifest: dict) -> None:
    """The checkpoint directory as the shrink left it, before any survivor
    re-formed: the shrink checkpoints, the manifest, and the run config
    of the old world (the survivor rewrote it at its own)."""
    dst.mkdir()
    shutil.copytree(ckpt / el.ELASTIC_SUBDIR, dst / el.ELASTIC_SUBDIR)
    shutil.copy(ckpt / el.MANIFEST_NAME, dst / el.MANIFEST_NAME)
    cfg = json.loads((ckpt / RUN_CONFIG_NAME).read_text())
    cfg["world_size"] = manifest["world_old"]["dp"]
    (dst / RUN_CONFIG_NAME).write_text(json.dumps(cfg))


def _state(ckpt: Path, epoch: int) -> dict:
    return torch.load(ckpt / str(epoch) / "state.pt", map_location="cpu",
                      weights_only=True)


def _assert_state_equal(a: dict, b: dict) -> None:
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]), k


@pytest.mark.parametrize("leaver", [1, 0])
def test_shrink_and_continue_equals_cold_restart(synth, tmp_path, leaver):
    ckpt, tel, sig = tmp_path / "ck", tmp_path / "tel", tmp_path / "sig"
    faults = make_kill_schedule(11 + leaver, rank=leaver, max_step=2, min_step=1)
    fault_file = tmp_path / "faults.json"
    fault_file.write_text(json.dumps(faults))
    rdv = f"file://{tmp_path}/rdv"
    outs = _run([(_argv(synth, ckpt, tel, sig),
                  _env(COORDINATOR_ADDRESS=rdv, NUM_PROCESSES="2", PROCESS_ID=str(r),
                       CAN_TPU_FAULTS=str(fault_file)))
                 for r in range(2)])
    survivor = 1 - leaver
    report = "\n".join(f"rank {r} rc {rc}\n{out[-3000:]}\n{err[-3000:]}"
                       for r, (rc, out, err) in enumerate(outs))
    assert outs[leaver][0] == el.LEAVE_EXIT_CODE, report
    assert outs[survivor][0] == 0, report
    if leaver == 0:  # the main process prints
        assert "[elastic] leaving after the shrink checkpoint" in outs[0][1], report
    assert "(in_process)" in outs[survivor][1], report

    # one transition, recorded by the survivor at 2 processes -> 1
    events = _events(tel, "elastic.transition")
    assert len(events) == 1, events
    t = events[0]["payload"]
    assert events[0]["host_id"] == survivor
    assert (t["processes_old"], t["processes_new"]) == (2, 1)
    assert (t["dp_old"], t["dp_new"], t["lr_scale"]) == (2, 1, 0.5)
    assert (t["global_batch_old"], t["global_batch_new"]) == (2, 1)
    assert t["resumed_from"] == "in_process" and t["leavers"] == [leaver]
    assert t["consumed_items"] + t["remaining_items"] == N_TRAIN
    assert t["remaining_items"] > 0  # the shrink was mid-epoch
    assert t["steps_done"] >= faults["faults"][0]["step"]

    # the manifest: live until the survivor's epoch checkpoint, consistent
    m = el.load_manifest(str(ckpt))
    assert m is not None and m["leavers"] == [leaver] and m["survivors"] == [survivor]
    assert (m["leaver_hosts"], m["survivor_hosts"]) == ([leaver], [survivor])
    assert el.manifest_is_live(m, None) and not el.manifest_is_live(m, 0)
    rem = el.remaining_items(m, N_TRAIN)
    consumed = set(m["consumed"])
    assert consumed | set(rem) == set(range(N_TRAIN)) and not consumed & set(rem)
    assert len(consumed) == 2 * t["steps_done"]  # batch 1 x 2 ranks, no fill

    # the JAX package plans the remainder the survivor trained
    jm = jel.load_manifest(str(ckpt))
    assert jm == m and jel.remaining_items(jm, N_TRAIN) == rem
    roots = (str(synth / "train_data" / "images"), str(synth / "train_data" / "ground_truth"))
    kw = dict(shuffle=True, seed=0, pad_multiple="auto", max_buckets=24,
              remnant_sizes=True, batch_quantum=1, launch_cost_px=860.0)
    want = JaxShardedBatcher(JaxCrowdDataset(*roots, prepared="off"), 1, plan_mode="cost",
                             **kw).global_schedule(0, set(rem))
    got = ShardedBatcher(CrowdDataset(*roots, prepared="off"), 1, **kw).global_schedule(
        0, set(rem))
    assert got == want
    steps_after = int(re.search(r"\[metrics\] step 0 .*\bsteps=(\d+)", outs[survivor][1])[1])
    assert steps_after == len(want)

    # the cold restart at world 1 from the directory as the shrink left it
    snap, ck_cold, tel_cold = tmp_path / "snap", tmp_path / "ck_cold", tmp_path / "tel_cold"
    shrink_point_copy(ckpt, snap, m)
    (cold,) = _run([(_argv(synth, ck_cold, tel_cold, sig) + ["--init_checkpoint", str(snap)],
                     _env())])
    assert cold[0] == 0, cold[1][-3000:] + cold[2][-3000:]
    assert "world drift permitted by the live transition manifest: world_size 2 -> 1" \
        in cold[1]
    assert "(cold_restart)" in cold[1]
    (cold_t,) = _events(tel_cold, "elastic.transition")
    assert cold_t["payload"]["resumed_from"] == "cold_restart"
    # the same record but the runtime generation (the survivor's second,
    # the cold process's first)
    assert cold_t["payload"]["generation_new"] == 1 and t["generation_new"] == 2
    same = lambda p: {k: v for k, v in p.items()  # noqa: E731
                      if k not in ("resumed_from", "generation_new")}
    assert same(cold_t["payload"]) == same(t)
    _assert_state_equal(_state(ckpt, 0), _state(ck_cold, 0))
    assert (ckpt / "0" / "metrics.json").read_text() == \
        (ck_cold / "0" / "metrics.json").read_text()
    (ep,) = [e for e in _events(tel, "epoch") if e["host_id"] == survivor]
    (ep_cold,) = _events(tel_cold, "epoch")
    for k in ("train_loss", "mae", "mse", "lr"):
        assert ep["payload"][k] == ep_cold["payload"][k], k
    for d in (ckpt, snap, ck_cold):  # ~150 MB a state; a failure keeps them
        shutil.rmtree(d)
