"""DDP and SyncBN against the JAX package's data-parallel step, on the CPU
with gloo processes: the plain model in f32 and the BN model's SyncBN in
float64, evaluation across processes, and the train CLI at 2 processes
with a checkpoint and a resume.

The port runs as 2 processes (this file as a script, one per rank,
``file://`` rendezvous under ``tmp_path``), each stepping on its half of
every global batch; JAX runs ``make_dp_train_step`` on a dp=2 mesh of
the CPU devices, in float64 in a subprocess (x64 is process-wide JAX
config, as tests/test_torch_bn.py's x64 test).  Tolerances:

* plain model, f32, 2 steps: the parameters at the model tolerance,
  rtol 1e-3 / atol 1e-4, at an lr whose 2 steps move every parameter
  tensor beyond it, and each step's global loss at rtol 1e-5;
* SyncBN, float64, one step, ``onepass`` and ``kernel`` (its plain
  version on the CPU): each parameter's update within 1e-3 of JAX's in
  relative L2 norm, the bound tests/test_torch_bn.py's single-process
  x64 test holds (the port's context tail and loss stay f32 inside);
  running statistics 1e-4; pre-BN conv biases, whose true gradient is 0,
  bounded in absolute size.  A SyncBN whose all-reduce drops the
  cross-rank gradient term is off by O(1) in the frontend's BN-scale
  updates, so these bounds see it;
* port against port: 2 ranks x 2 images against 1 rank x 4 images in
  float64, each update within ``SPLIT_RTOL`` relative L2 (f64 summation
  order, and the f32 context tail);
* evaluation: 2 processes give 1 process's MAE/MSE within 1e-6.
"""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from can_tpu.data.batching import pad_batch
from can_tpu.models import cannet_apply, init_batch_stats
from can_tpu.models.cannet import LocalOps
from can_tpu.ops import bn_moments as jbm
from can_tpu.ops import pallas_context
from can_tpu.parallel import make_dp_train_step as jax_make_dp_train_step
from can_tpu.parallel import make_global_batch as jax_make_global_batch
from can_tpu.parallel import make_mesh as jax_make_mesh
from can_tpu.train import create_train_state, make_lr_schedule, make_optimizer
from can_tpu_torch.cli import test as eval_cli
from can_tpu_torch.cli import train as train_cli
from can_tpu_torch.data import make_synthetic_dataset
from can_tpu_torch.data.batching import Batch
from can_tpu_torch.models import CANNet, random_state_dict
from can_tpu_torch.ops import bn_moments as bm
from can_tpu_torch.parallel import make_dp_train_step, make_mesh
from can_tpu_torch.parallel import runtime as rt
from can_tpu_torch.train import create_train_state as torch_train_state
from can_tpu_torch.train import make_lr_schedule as torch_lr_schedule
from can_tpu_torch.train.steps import batch_to_device
from can_tpu_torch.utils.checkpoint import CheckpointManager, load_run_config
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from test_torch_bn import _compare_updates, jax_bn_params
from test_torch_model import jax_params
from test_torch_parallel import spawn as _spawn_script

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("image", "dmap", "pixel_mask", "sample_mask")
SPLIT_RTOL = 1e-6
X64_TIMEOUT_S = 600


def spawn(tmp_path, mode, nproc, *args):
    """This file as ``nproc`` rank processes (``test_torch_parallel.spawn``)."""
    return _spawn_script(tmp_path, mode, nproc, *args, script=__file__)


def _global_batch(seed: int, bucket, sizes, valid) -> dict:
    """One global batch: seeded images of ``sizes`` padded into
    ``bucket``, ``valid`` flags per slot (False = a fill slot)."""
    rng = np.random.default_rng(seed)
    items = []
    for h, w in sizes:
        items.append((rng.standard_normal((h, w, 3)).astype(np.float32),
                      rng.uniform(0, 0.1, (h // 8, w // 8, 1)).astype(np.float32)))
    b = pad_batch(items, bucket, len(sizes), valid, 8)
    return {k: getattr(b, k) for k in KEYS}


def _local(batch: dict, rank: int, nproc: int) -> dict:
    n = batch["image"].shape[0] // nproc
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _write_inputs(path, state_dict, batches, **meta) -> str:
    arrays = {f"sd/{k}": np.asarray(v) for k, v in state_dict.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    np.savez(path, **arrays)
    Path(str(path) + ".json").write_text(json.dumps(dict(meta, steps=len(batches))))
    return str(path)


def _read_inputs(path):
    data = np.load(path)
    meta = json.loads(Path(path + ".json").read_text())
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    batches = [{k: data[f"b{i}/{k}"] for k in KEYS} for i in range(meta["steps"])]
    return sd, batches, meta


def port_train(inputs: str, impl: str, rank: int = 0, nproc: int = 1) -> dict:
    """The port's data-parallel training on this rank's slices: returns
    the final state dict and each step's global loss."""
    sd, batches, meta = _read_inputs(inputs)
    dtype = torch.float64 if meta["dtype"] == "f64" else torch.float32
    bn = meta["batch_norm"]
    model = CANNet(seed=None, batch_norm=bn)
    model.load_state_dict(sd)
    model = model.to(dtype)
    state = torch_train_state(model, torch_lr_schedule(meta["lr"], world_size=nproc))
    step = make_dp_train_step(model, make_mesh(),
                              bn_ops=bm.make_bn_ops(impl) if bn else None)
    losses = []
    for b in batches:
        local = Batch(**{k: v.astype(np.float64) if meta["dtype"] == "f64" else v
                         for k, v in _local(b, rank, nproc).items()})
        state, m = step(state, batch_to_device(local, "cpu"))
        losses.append(float(rt.reduce_value(np.float64(m["loss"]), average=False)))
    return {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "losses": losses}


def _jax_dp_train(params, batches, *, lr, impl, batch_norm, dtype):
    """JAX's data-parallel step on a dp=2 mesh of CPU devices."""
    mesh = jax_make_mesh(jax.devices()[:2], dp=2)
    opt = make_optimizer(make_lr_schedule(lr, world_size=2))
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    stats = (jax.tree.map(lambda a: jnp.asarray(a, jdt), init_batch_stats(params))
             if batch_norm else None)
    state = create_train_state(params, opt, stats)
    ops = LocalOps(bn_ops=jbm.make_bn_ops(impl) if batch_norm else None,
                   context_fused=pallas_context.make_fused_context(interpret=True))
    step = jax_make_dp_train_step(partial(cannet_apply, ops=ops), opt, mesh,
                                  donate=False)
    losses = []
    for b in batches:
        from can_tpu.data.batching import Batch as JaxBatch

        jb = JaxBatch(**{k: (v.astype(np.float64) if dtype == "f64" else v)
                         for k, v in b.items()})
        state, m = step(state, jax_make_global_batch(jb, mesh))
        losses.append(float(m["loss"]))
    got = state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params),
        None if stats is None else jax.tree.map(np.asarray, state.batch_stats))
    return {k: v.double() for k, v in got.items()}, losses


# -- (d) the plain model in f32 ---------------------------------------------
def test_plain_dp_step_matches_jax_dp2(tmp_path):
    params = jax_params("he")
    bucket = (64, 96)
    batches = [_global_batch(11, bucket, [(64, 64), (64, 96), (48, 80), (64, 96)],
                             [True, True, True, False]),
               _global_batch(12, bucket, [(64, 96), (56, 96), (64, 64), (64, 88)],
                             [True] * 4)]
    lr = 1e-5
    inputs = _write_inputs(tmp_path / "plain.npz", state_dict_from_jax_params(params),
                           batches, lr=lr, dtype="f32", batch_norm=False)
    want, jlosses = _jax_dp_train(params, batches, lr=lr, impl=None,
                                  batch_norm=False, dtype="f32")
    outs = spawn(tmp_path, "train", 2, inputs, "onepass", tmp_path / "plain-out")
    got = {k: torch.from_numpy(v) for k, v in np.load(outs[0]["state"]).items()}
    rank1 = np.load(outs[1]["state"])
    old = state_dict_from_jax_params(params)
    assert outs[0]["losses"] == outs[1]["losses"]
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=1e-5)
    assert len(want) == 2 * 16 + 2 + 8  # conv w/b, the output conv, context
    for k in want:
        w = want[k].numpy()
        np.testing.assert_array_equal(got[k].numpy(), rank1[k])  # replicas agree
        # the model tolerance on the parameters after 2 steps ...
        np.testing.assert_allclose(got[k].double().numpy(), w, rtol=1e-3,
                                   atol=1e-4, err_msg=k)
        # ... which the training moved every parameter past, so the
        # comparison sees each layer's updates
        assert (np.abs(old[k].double().numpy() - w) > 1e-4 + 1e-3 * np.abs(w)).any(), k


# -- (e) SyncBN in float64 -------------------------------------------------------
def _bn_batch():
    """Global batch of 4 at bucket 48 x 64 (tests/test_torch_bn.py's x64
    bucket): rank 0 gets a padded and a full image, rank 1 a full image
    and a fill slot."""
    return _global_batch(21, (48, 64), [(48, 48), (48, 64), (40, 64), (48, 64)],
                         [True, True, True, False])


def _jax_x64_main(out: str) -> None:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    want, losses = _jax_dp_train(jax_bn_params(), [_bn_batch()], lr=1e-3,
                                 impl="onepass", batch_norm=True, dtype="f64")
    np.savez(out, **{k: v.numpy() for k, v in want.items()})
    print(json.dumps({"losses": losses}))


@pytest.fixture(scope="module")
def syncbn_runs(tmp_path_factory):
    """JAX's x64 dp=2 step (a subprocess), the port at 2 ranks x 2 images
    (onepass and kernel, float64) and at 1 rank x 4 images, all at once."""
    tmp = tmp_path_factory.mktemp("syncbn")
    params = jax_bn_params()
    old = state_dict_from_jax_params(params, init_batch_stats(params))
    inputs = _write_inputs(tmp / "bn.npz", old, [_bn_batch()], lr=1e-3,
                           dtype="f64", batch_norm=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    jproc = subprocess.Popen([sys.executable, __file__, "jax-x64", str(tmp / "jax.npz")],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        two = {impl: spawn(tmp, "train", 2, inputs, impl, tmp / f"two-{impl}")
               for impl in ("onepass", "kernel")}
        one = {impl: port_train(inputs, impl) for impl in ("onepass", "kernel")}
        out, err = jproc.communicate(timeout=X64_TIMEOUT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, out[-3000:] + err[-3000:]
    jax_losses = json.loads(out.strip().splitlines()[-1])["losses"]
    want = {k: torch.from_numpy(v) for k, v in np.load(tmp / "jax.npz").items()}
    two = {impl: ({k: torch.from_numpy(v) for k, v in np.load(o[0]["state"]).items()},
                  o[0]["losses"]) for impl, o in two.items()}
    return {"old": {k: v.double() for k, v in old.items()}, "want": want,
            "jax_losses": jax_losses, "two": two, "one": one}


@pytest.mark.parametrize("impl", ["onepass", "kernel"])
def test_syncbn_dp2_step_matches_jax_in_x64(syncbn_runs, impl):
    got, losses = syncbn_runs["two"][impl]
    res = _compare_updates(syncbn_runs["old"], got, syncbn_runs["want"])
    assert abs(losses[0] - syncbn_runs["jax_losses"][0]) <= 1e-5 * abs(
        syncbn_runs["jax_losses"][0])
    assert res["stats"] <= 1e-4, res
    assert res["update"] <= 1e-3, res
    assert res["pre_bn_bias"] < 1e-6, res
    assert res["checked"] == 16 * 3 + 2 + 8, res  # conv w, BN scale/bias; out; ctx
    # every BN layer's step counter advanced once
    assert all(int(got[k]) == 1 for k in got if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("impl", ["onepass", "kernel"])
def test_syncbn_two_ranks_equal_one_rank_of_the_whole_batch(syncbn_runs, impl):
    got, losses = syncbn_runs["two"][impl]
    whole = syncbn_runs["one"][impl]
    ref = {k: v.double() for k, v in whole["state"].items()}
    res = _compare_updates(syncbn_runs["old"], got, ref)
    assert abs(losses[0] - whole["losses"][0]) <= SPLIT_RTOL * abs(whole["losses"][0])
    assert res["update"] <= SPLIT_RTOL and res["stats"] <= SPLIT_RTOL, res


# -- (f) evaluation across processes ------------------------------------------
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_data")
    make_synthetic_dataset(str(root / "train_data"), 6, sizes=((64, 64), (64, 96)),
                           seed=0)
    make_synthetic_dataset(str(root / "test_data"), 7,
                           sizes=((64, 64), (64, 96), (56, 80)), seed=1)
    return root


def _bn_checkpoint(tmp_path) -> str:
    """A BN-model checkpoint with He weights and seeded running stats."""
    sd = random_state_dict(4, he=True, batch_norm=True)
    rng = np.random.default_rng(4)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.normal(0, 0.1, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    model = CANNet(seed=None, batch_norm=True)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    state = torch_train_state(model, torch_lr_schedule(0.0))
    ckpt = tmp_path / "bn_ckpt"
    CheckpointManager(str(ckpt)).save(0, state, mae=1.0)
    return str(ckpt)


def _eval_argv(data, ckpt, batch: int):
    return ["--data_root", str(data), "--checkpoint-dir", ckpt, "--syncBN",
            "--batch-size", str(batch), "--platform", "cpu", "--pad-multiple",
            "auto", "--num-workers", "0", "--prepared-root", "off"]


@pytest.mark.parametrize("batch", [1, 2])
def test_eval_at_two_processes_equals_one(synth, tmp_path, batch):
    ckpt = _bn_checkpoint(tmp_path)
    one = eval_cli.evaluate_checkpoint(eval_cli.parse_args(_eval_argv(synth, ckpt, batch)))
    outs = spawn(tmp_path, "eval", 2, synth, ckpt, batch)
    assert one["num_images"] == 7 and one["mae"] > 0.1
    for out in outs:
        assert out["num_images"] == 7
        np.testing.assert_allclose([out["mae"], out["mse"]], [one["mae"], one["mse"]],
                                   rtol=1e-6)
    assert outs[0]["batches"] == outs[1]["batches"]  # the lockstep schedule


# -- (g) the train CLI at 2 processes: a checkpoint, then a resume -------------
def _cli(tmp_path, argv, nproc=2, timeout=240):
    """``python -m can_tpu_torch.cli.train`` as ``nproc`` processes that
    find each other through the JAX package's COORDINATOR_ADDRESS
    variables (a ``file://`` URL here)."""
    rdv = f"file://{tmp_path}/rdv-cli-{len(list(tmp_path.glob('*')))}"
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]),
        COORDINATOR_ADDRESS=rdv, NUM_PROCESSES=str(nproc), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", "can_tpu_torch.cli.train", *argv],
                              cwd=ROOT, env=dict(base, PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append((p.returncode, *p.communicate(timeout=timeout)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (_, out, err) in zip(procs, outs)]


def test_train_cli_at_two_processes_checkpoints_and_resumes(synth, tmp_path):
    ck1, ck2 = tmp_path / "ck1", tmp_path / "ck2"
    base = ["--data_root", str(synth), "--syncBN", "--bn-impl", "kernel",
            "--batch-size", "2", "--pad-multiple", "auto", "--lr", "1e-6",
            "--platform", "cpu", "--num-workers", "0", "--prepared-root", "off",
            "--seed", "0"]
    first = _cli(tmp_path, base + ["--epochs", "1", "--checkpoint-dir", str(ck1)])
    assert all(rc == 0 for rc, _, _ in first), first
    (_, out0, _), (_, out1, _) = first
    assert "[best] epoch 0" in out0 and "[metrics]" in out0
    assert "[best]" not in out1 and "[metrics]" not in out1  # rank 0 logs
    assert "dp=2" in out0
    mgr = CheckpointManager(str(ck1))
    assert mgr.latest_epoch() == 0 and load_run_config(str(ck1))["world_size"] == 2
    sd = mgr.model_state_dict(0)
    assert not any(k.startswith("module.") for k in sd)
    second = _cli(tmp_path, base + ["--epochs", "2", "--checkpoint-dir", str(ck2),
                                    "--init_checkpoint", str(ck1),
                                    "--allow-config-change"])
    assert all(rc == 0 for rc, _, _ in second), second
    assert "[resume] epoch 0" in second[0][1]
    mgr2 = CheckpointManager(str(ck2))
    assert mgr2.latest_epoch() == 1
    # the resumed epoch continued the counts: twice epoch 0's steps
    sd2 = mgr2.model_state_dict(1)
    counts = [(int(sd[k]), int(sd2[k])) for k in sd if k.endswith("num_batches_tracked")]
    assert len(counts) == 16 and all(a > 0 and b == 2 * a for a, b in counts)
    # one process resuming the 2-process run: a world-size drift
    with pytest.raises(SystemExit, match="world size"):
        train_cli.train(train_cli.parse_args(
            base + ["--epochs", "1", "--checkpoint-dir", str(tmp_path / "ck3"),
                    "--init_checkpoint", str(ck1)]))


# -- worker entry ------------------------------------------------------------
def _worker_main(argv) -> None:
    mode, rdv, nproc, rank = argv[0], argv[1], int(argv[2]), int(argv[3])
    rt.init_runtime(platform="cpu", coordinator_address=rdv, num_processes=nproc,
                    process_id=rank)
    try:
        if mode == "train":
            inputs, impl, out = argv[4:7]
            res = port_train(inputs, impl, rank, nproc)
            path = f"{out}-rank{rank}.npz"
            np.savez(path, **{k: v.numpy() for k, v in res["state"].items()})
            result = {"state": path, "losses": res["losses"]}
        else:  # eval
            data, ckpt, batch = argv[4], argv[5], int(argv[6])
            args = eval_cli.parse_args(_eval_argv(data, ckpt, batch))
            got = eval_cli.evaluate_checkpoint(args)
            result = {k: got[k] for k in ("mae", "mse", "num_images", "batches")}
    finally:
        rt.shutdown_runtime()
    print(json.dumps(result))


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "jax-x64":
        _jax_x64_main(sys.argv[2])
    else:
        _worker_main(sys.argv[1:])
