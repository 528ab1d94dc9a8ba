"""The training path against the JAX package: the optimizer recipe, the
epoch loops, checkpoints, the train CLI, and two epochs of the whole
slice (BN model, synthetic PNGs, both packages' datasets, batchers,
steps and loops on the same seed).

Tolerances: lr schedule and SGD-momentum parameters rtol 1e-6 (f32
arithmetic of the same recipe); the slice's train loss and MAE per
epoch within 1e-3 relative of JAX's, at an lr whose training moves the
MAE (against the same run at lr 0) by more than 10x that, so the
comparison sees training.
"""

import math
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from can_tpu.data import CrowdDataset as JaxCrowdDataset
from can_tpu.data import ShardedBatcher as JaxShardedBatcher
from can_tpu.models import cannet_apply, init_batch_stats
from can_tpu.models.cannet import LocalOps
from can_tpu.ops import bn_moments as jbm
from can_tpu.ops import pallas_context
from can_tpu.train import create_train_state, make_eval_step, make_lr_schedule
from can_tpu.train import evaluate as jax_evaluate
from can_tpu.train import make_optimizer
from can_tpu.train import make_train_step as jax_make_train_step
from can_tpu.train import train_one_epoch as jax_train_one_epoch
from can_tpu_torch.cli import train as cli
from can_tpu_torch.data import CrowdDataset, ShardedBatcher, make_synthetic_dataset
from can_tpu_torch.models import CANNet
from can_tpu_torch.ops.bn_moments import make_bn_ops
from can_tpu_torch.train import (
    NonFiniteLossError,
    create_train_state as torch_train_state,
    evaluate,
    make_eval_step as torch_make_eval_step,
    make_lr_schedule as torch_lr_schedule,
    make_train_step,
    train_one_epoch,
)
from can_tpu_torch.train.steps import batch_to_device
from can_tpu_torch.utils.checkpoint import (
    CheckpointIOError,
    CheckpointManager,
    ConfigDriftError,
    check_resume_config,
    has_checkpoint,
)
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from test_torch_bn import jax_bn_params

ROOT = Path(__file__).resolve().parents[1]
SIZES = ((64, 64), (64, 96))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """8 train and 4 test synthetic items (the port's PNG writer)."""
    root = tmp_path_factory.mktemp("synth")
    make_synthetic_dataset(str(root / "train_data"), 8, sizes=SIZES, seed=0)
    make_synthetic_dataset(str(root / "test_data"), 4, sizes=SIZES, seed=1)
    return root


# -- optimizer ------------------------------------------------------------
@pytest.mark.parametrize("lrf", [1.0, 0.1])
def test_lr_schedule_and_sgd_momentum_match_optax(lrf):
    """5 steps of the port's SGD (torch.optim.SGD, dampening 0) on fixed
    gradients against optax ``sgd(cosine_decay_schedule, momentum)``; lr x
    world 2, decayed over 4 steps (the 5th is past the end)."""
    sched = make_lr_schedule(1e-2, world_size=2, total_steps=4, lrf=lrf)
    tsched = torch_lr_schedule(1e-2, world_size=2, total_steps=4, lrf=lrf)
    for step in range(6):
        np.testing.assert_allclose(tsched(step), float(sched(step)), rtol=1e-6)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(5)]
    opt = make_optimizer(sched)
    pj = jnp.asarray(p0)
    opt_state = opt.init(pj)
    model = torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    state = torch_train_state(model, tsched)
    for g in grads:
        updates, opt_state = opt.update(jnp.asarray(g), opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        model.weight.grad = torch.from_numpy(g)
        state.apply_update()
        np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-7)
    assert state.step == 5


# -- loops ----------------------------------------------------------------
class _Batch:
    def __init__(self, n):
        self.image = np.zeros((n, 8, 8, 3), np.float32)
        self.sample_mask = np.ones((n,), np.float32)


def test_train_loop_windows_and_nonfinite_abort():
    """Metrics are fetched per window; a NaN loss raises at the flush
    naming the step."""
    losses = iter([1.0, 2.0, float("nan"), 4.0])

    def step(state, dev):
        return state, {"loss": torch.tensor(next(losses)),
                       "num_valid": torch.tensor(2.0)}

    put = lambda b: {"image": torch.from_numpy(b.image)}  # noqa: E731
    _, stats = train_one_epoch(step, None, [_Batch(2), _Batch(2)], put_fn=put,
                               check_every=8)
    assert stats.steps == 2 and stats.images == 4.0 and stats.loss == 0.75
    with pytest.raises(NonFiniteLossError, match="step 1"):
        train_one_epoch(step, None, [_Batch(2), _Batch(2)], put_fn=put,
                        check_every=1)


def test_evaluate_divides_by_the_true_dataset_size():
    def step(model, dev):
        return {"abs_err_sum": torch.tensor(3.0), "sq_err_sum": torch.tensor(5.0),
                "num_valid": torch.tensor(2.0)}

    res = evaluate(step, None, [0, 1], put_fn=lambda b: b, dataset_size=4)
    assert res == {"mae": 1.5, "mse": math.sqrt(2.5), "num_images": 4,
                   "batches": 2}
    with pytest.raises(RuntimeError, match="expected 5"):
        evaluate(step, None, [0, 1], put_fn=lambda b: b, dataset_size=5)


def test_training_after_an_inference_forward_at_the_same_shape():
    """An eval (or serve) forward, which runs under inference mode, may be
    the first to build a shape's cached interpolation matrices; a later
    training forward at that shape must still backpropagate through
    them (an inference tensor cannot be saved for backward)."""
    from can_tpu_torch.ops import resize

    resize._upsample_matrix_on.cache_clear()
    rng = np.random.default_rng(3)
    dev = {"image": torch.from_numpy(rng.standard_normal((1, 64, 64, 3))
                                     .astype(np.float32)),
           "dmap": torch.from_numpy(rng.uniform(0, 0.1, (1, 8, 8, 1))
                                    .astype(np.float32)),
           "pixel_mask": torch.ones((1, 8, 8, 1)),
           "sample_mask": torch.ones((1,))}
    model = CANNet(seed=0, batch_norm=True)
    torch_make_eval_step()(model, dev)
    assert not resize.upsample_matrix(1, 8).is_inference()
    state = torch_train_state(model, torch_lr_schedule(1e-6))
    state, m = make_train_step(bn_ops=make_bn_ops("kernel"))(state, dev)
    assert state.step == 1 and math.isfinite(float(m["loss"]))


# -- the slice ------------------------------------------------------------
def _port_slice(roots, params, *, lr, batch, pad, steps):
    """Two epochs of the port: (per-epoch train stats, per-epoch MAE)."""
    ttrain = ShardedBatcher(CrowdDataset(roots[0], roots[1]), batch, seed=0,
                            pad_multiple=pad)
    ttest = ShardedBatcher(CrowdDataset(roots[2], roots[3], phase="test"), batch,
                           shuffle=False, pad_multiple=pad)
    assert ttrain.batches_per_epoch(0) == steps
    model = CANNet(seed=None, batch_norm=True)
    model.load_state_dict(state_dict_from_jax_params(params))
    state = torch_train_state(model, torch_lr_schedule(lr, total_steps=2 * steps,
                                                      lrf=0.5))
    step = make_train_step(bn_ops=make_bn_ops("kernel"))
    eval_step = torch_make_eval_step()
    put = lambda b: batch_to_device(b, "cpu")  # noqa: E731
    stats, maes = [], []
    for epoch in range(2):
        state, s = train_one_epoch(step, state, ttrain.epoch(epoch), put_fn=put,
                                   epoch=epoch)
        m = evaluate(eval_step, state.model, ttest.epoch(0), put_fn=put,
                     dataset_size=ttest.dataset_size)
        stats.append(s)
        maes.append(m["mae"])
    return stats, maes


def test_two_epochs_of_the_slice_match_jax(synth):
    """BN model, kernel moments (Pallas interpret on the JAX side), fused
    context, batch 4, pad multiple 96 (one bucket: every image padded),
    2 epochs: train loss and MAE per epoch.

    In f32 this model's training is chaotic at this size: two JAX runs
    that differ only in the BN moments' summation order (pallas against
    twopass) drift apart by a good part of the tolerance within 4 steps
    at lr 5e-7, and past it at larger lr or with batch 2 (8 steps).  So
    the slice runs 4 steps at lr 5e-7; the MAE also moves between epochs
    through the running stats alone, so the test shows the training's
    own effect on MAE against the port at lr 0: more than 10x the
    tolerance."""
    lr, pad, batch = 5e-7, 96, 4
    params = jax_bn_params(1)
    roots = [str(synth / s / d) for s in ("train_data", "test_data")
             for d in ("images", "ground_truth")]
    # JAX: its own dataset (PIL reads the port's PNGs), batcher, loop
    jtrain = JaxShardedBatcher(JaxCrowdDataset(roots[0], roots[1], prepared="off"),
                               batch, seed=0, pad_multiple=pad,
                               plan_mode="legacy")
    jtest = JaxShardedBatcher(JaxCrowdDataset(roots[2], roots[3], phase="test",
                                              prepared="off"),
                              batch, shuffle=False, pad_multiple=pad,
                              plan_mode="legacy")
    steps = jtrain.batches_per_epoch(0)
    opt = make_optimizer(make_lr_schedule(lr, total_steps=2 * steps, lrf=0.5))
    ops = LocalOps(bn_ops=jbm.make_bn_ops("pallas", interpret=True),
                   context_fused=pallas_context.make_fused_context(interpret=True))
    apply_fn = partial(cannet_apply, ops=ops)
    jstep = jax.jit(jax_make_train_step(apply_fn, opt))
    jeval = jax.jit(make_eval_step(cannet_apply))
    jput = lambda b: {k: jnp.asarray(getattr(b, k)) for k in  # noqa: E731
                      ("image", "dmap", "pixel_mask", "sample_mask")}
    jstate = create_train_state(jax.tree.map(jnp.asarray, params), opt,
                                init_batch_stats(params))
    jlosses, jmaes = [], []
    for epoch in range(2):
        jstate, jstats = jax_train_one_epoch(jstep, jstate, jtrain.epoch(epoch),
                                             put_fn=jput, epoch=epoch,
                                             show_progress=False)
        assert jstats.steps == steps
        jm = jax_evaluate(jeval, jstate.params, jtest.epoch(0), put_fn=jput,
                          dataset_size=jtest.dataset_size,
                          batch_stats=jstate.batch_stats)
        jlosses.append(jstats.loss)
        jmaes.append(jm["mae"])
    stats, maes = _port_slice(roots, params, lr=lr, batch=batch, pad=pad,
                              steps=steps)
    assert [s.steps for s in stats] == [steps, steps]
    np.testing.assert_allclose([s.loss for s in stats], jlosses, rtol=1e-3)
    np.testing.assert_allclose(maes, jmaes, rtol=1e-3)
    _, still = _port_slice(roots, params, lr=0.0, batch=batch, pad=pad,
                           steps=steps)
    assert abs(maes[1] - still[1]) > 1e-2 * still[1], (maes, still)


# -- checkpoints ----------------------------------------------------------
def _tiny_state():
    model = torch.nn.Linear(3, 2)
    return torch_train_state(model, torch_lr_schedule(0.1))


def test_checkpoint_retention_restore_and_drift(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    maes = [5.0, 1.0, 4.0, 3.0, 6.0]
    for epoch, mae in enumerate(maes):
        state.model.weight.grad = torch.ones_like(state.model.weight)
        state.model.bias.grad = torch.ones_like(state.model.bias)
        state.apply_update()
        mgr.save(epoch, state, mae=mae, extra={"mse": mae * 2})
    # the latest 3 and the best (epoch 1)
    assert sorted(int(p.name) for p in tmp_path.iterdir() if p.name.isdigit()) \
        == [1, 2, 3, 4]
    assert mgr.latest_epoch() == 4 and mgr.best_epoch() == 1
    assert mgr.best_metric() == 1.0 and has_checkpoint(str(tmp_path))
    fresh = _tiny_state()
    mgr.restore(fresh, epoch=1)
    assert fresh.step == 2
    buf = fresh.optimizer.state[fresh.model.weight]["momentum_buffer"]
    assert torch.all(buf > 0)
    mgr.restore(fresh)
    assert fresh.step == 5
    assert torch.equal(fresh.model.weight, state.model.weight)
    with pytest.raises(ConfigDriftError, match="epochs: 2 -> 3"):
        check_resume_config({"epochs": 2, "lr": 1.0}, {"epochs": 3, "lr": 1.0})
    assert check_resume_config({"epochs": 2}, {"epochs": 3}, allow=True) == ["epochs"]


def test_checkpoint_retries_then_raises_typed(tmp_path, monkeypatch):
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), retries=2, backoff_s=0.0)
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        raise OSError("disk hiccup")

    monkeypatch.setattr(torch, "save", flaky)
    with pytest.raises(CheckpointIOError) as e:
        mgr.save(0, state, mae=1.0)
    assert e.value.op == "save" and e.value.attempts == 2 and len(calls) == 2
    assert not has_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)


# -- the CLI --------------------------------------------------------------
def _cli_args(synth, ck, *extra):
    return ["--data_root", str(synth), "--platform", "cpu", "--syncBN",
            "--bn-impl", "kernel", "--batch-size", "2", "--epochs", "2",
            "--lr", "1e-4", "--pad-multiple", "32", "--checkpoint-dir", str(ck),
            *extra]


def test_train_cli_trains_checkpoints_and_resumes(synth, tmp_path):
    """Two epochs with a checkpoint each; resuming from epoch 0's
    checkpoint retrains epoch 1 to the same parameters, bit for bit."""
    ck = tmp_path / "ck"
    summary = cli.train(cli.parse_args(_cli_args(synth, ck)))
    assert summary["steps"] > 0 and summary["eval_batches"] > 0
    assert all(math.isfinite(r["train_loss"]) and math.isfinite(r["mae"])
               for r in summary["epochs"])
    assert CheckpointManager(str(ck)).latest_epoch() == 1
    full = torch.load(ck / "1" / "state.pt", weights_only=True)
    shutil.rmtree(ck / "1")
    resumed = cli.train(cli.parse_args(_cli_args(synth, tmp_path / "ck2",
                                                 "--init_checkpoint", str(ck))))
    assert [r["epoch"] for r in resumed["epochs"]] == [1]
    again = torch.load(tmp_path / "ck2" / "1" / "state.pt", weights_only=True)
    assert again["step"] == full["step"]
    for k, v in full["model"].items():
        assert torch.equal(again["model"][k], v), k
    with pytest.raises(SystemExit, match="epochs: 2 -> 3"):
        cli.train(cli.parse_args(_cli_args(synth, tmp_path / "ck3",
                                           "--init_checkpoint", str(ck),
                                           "--epochs", "3")))


def test_train_cli_refusals(synth, tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli.parse_args(["--data_root", str(synth), "--pad-multiple", "bogus"])
    assert "--pad-multiple takes" in capsys.readouterr().err
    assert cli.parse_args(["--pad-multiple", "none"]).pad_multiple is None
    assert cli.parse_args([]).pad_multiple == "auto"  # the JAX default
    assert cli.parse_args([]).bn_impl == "onepass"
    with pytest.raises(SystemExit, match="item-cache-mb"):
        cli.train(cli.parse_args(_cli_args(synth, tmp_path, "--item-cache-mb", "-1")))
    with pytest.raises(SystemExit, match="eval-interval"):
        cli.train(cli.parse_args(_cli_args(synth, tmp_path, "--eval-interval", "0")))
    with pytest.raises(SystemExit, match="no such dataset"):
        cli.train(cli.parse_args(["--data_root", str(tmp_path / "nope"),
                                  "--platform", "cpu"]))


def test_train_cli_without_a_card_exits_nonzero(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-card refusal needs none")
    proc = subprocess.run(
        [sys.executable, "-m", "can_tpu_torch.cli.train", "--data_root",
         str(synth), "--syncBN", "--checkpoint-dir", str(tmp_path / "ck")],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--platform cpu" in proc.stderr
    assert "[epoch]" not in proc.stdout
