"""Rematerialisation: the step with remat gives the step without it, and
the policy that picks it per launch.

* One BN train step (padding and a fill slot, the kernel impl's plain
  version) with remat on against off, in float64 on the CPU: the loss,
  every gradient and the new running statistics agree within 1e-12 (the
  recompute runs the same ops on the same inputs).
* The running statistics advance once per step, from the first forward's
  moments: ``num_batches_tracked`` counts steps, not forwards.
* ``make_remat_policy`` against footprints computed here by hand from
  ``TRAIN_FOOTPRINT`` at pinned memory sizes; ``max_launch_pixels(remat=)``
  reads the remat constants; ``make_bucketed_train_step`` asks the policy
  per launch.
"""

import numpy as np
import pytest
import torch

from can_tpu_torch.cli import common
from can_tpu_torch.models import CANNet, cannet, random_state_dict
from can_tpu_torch.ops.bn_moments import make_bn_ops
from can_tpu_torch.train import (
    create_train_state,
    make_bucketed_train_step,
    make_lr_schedule,
    make_train_step,
)

GIB = 2 ** 30


def _batch(dtype=torch.float64):
    """Two slots at 64 x 96: a 48 x 80 image (bucket padding) and a fill
    slot."""
    rng = np.random.default_rng(3)
    pm = np.zeros((2, 8, 12, 1))
    pm[0, :6, :10] = 1.0
    img = rng.standard_normal((2, 64, 96, 3)) * np.repeat(np.repeat(pm, 8, 1), 8, 2)
    return {"image": torch.from_numpy(img).to(dtype),
            "dmap": torch.from_numpy(rng.random((2, 8, 12, 1)) * pm).to(dtype),
            "pixel_mask": torch.from_numpy(pm).to(dtype),
            "sample_mask": torch.tensor([1.0, 0.0], dtype=dtype)}


def _state(batch_norm=True, dtype=torch.float64, s2d_stem=False):
    model = CANNet(seed=None, batch_norm=batch_norm, dtype=dtype, s2d_stem=s2d_stem)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(0, he=True, batch_norm=batch_norm).items()})
    return create_train_state(model, make_lr_schedule(1e-4))


def _one_step(remat, batch_norm=True, s2d_stem=False):
    state = _state(batch_norm, s2d_stem=s2d_stem)
    step = make_train_step(bn_ops=make_bn_ops("kernel") if batch_norm else None,
                           remat=remat)
    _, m = step(state, _batch())
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return float(m["loss"]), grads, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("batch_norm,s2d_stem", [(True, False), (False, False),
                                                  (True, True)])
def test_remat_step_equals_the_plain_step_f64(batch_norm, s2d_stem):
    loss0, g0, sd0 = _one_step(False, batch_norm, s2d_stem)
    loss1, g1, sd1 = _one_step(True, batch_norm, s2d_stem)
    assert abs(loss1 - loss0) <= 1e-12 * abs(loss0)
    assert set(g0) == set(g1) and len(g0) == len(list(_state(batch_norm).model.parameters()))
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-12,
                                   atol=1e-12 * float(g0[k].abs().max()), err_msg=k)
    for k in sd0:  # weights after the update, running stats, batch counts
        np.testing.assert_allclose(sd1[k].double().numpy(), sd0[k].double().numpy(),
                                   rtol=1e-12, atol=0, err_msg=k)
    if batch_norm:
        assert any(not torch.equal(sd0[k], _state().model.state_dict()[k])
                   for k in sd0 if k.endswith("running_mean"))


def test_running_stats_advance_once_per_step_with_remat(monkeypatch):
    """Two remat steps: every BN layer counts 2 batches, and the segments
    did run under the checkpoint (the recompute saw the layers again)."""
    calls = []
    real = cannet.checkpoint

    def counting(fn, *args, **kw):
        calls.append(getattr(fn, "__name__", None))
        return real(fn, *args, **kw)

    monkeypatch.setattr(cannet, "checkpoint", counting)
    state = _state()
    step = make_train_step(bn_ops=make_bn_ops("kernel"), remat=True)
    for _ in range(2):
        step(state, _batch())
    tracked = [int(v) for k, v in state.model.state_dict().items()
               if k.endswith("num_batches_tracked")]
    assert len(tracked) == 16 and set(tracked) == {2}
    # per step: four frontend stages, the context block, the backend
    assert len(calls) == 2 * 6 and calls.count("_context") == 2


def test_remat_is_skipped_without_gradients():
    model = _state().model
    with torch.no_grad():
        a = model(_batch()["image"], remat=True)
    with torch.no_grad():
        b = model(_batch()["image"])
    assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch_norm", [True, False])
def test_auto_policy_against_hand_computed_footprints(bf16, batch_norm):
    key = ("bn" if batch_norm else "plain", False)
    fixed, per_px = common.TRAIN_FOOTPRINT[key]["bf16" if bf16 else "f32"]
    mem = 80 * GIB
    policy = common.make_remat_policy("auto", global_batch=8, bf16=bf16,
                                      batch_norm=batch_norm, hbm_bytes=mem)
    budget = 0.80 * mem
    for hw in ((576, 768), (1024, 1024), (2048, 1536), (4096, 2048)):
        for b in (1, 4, 8):
            want = fixed + per_px * b * hw[0] * hw[1] > budget
            assert policy(hw, batch=b) == want, (hw, b)
        assert policy(hw) == policy(hw, batch=8)  # the global batch
    # a launch just under and just over the budget
    px = (budget - fixed) / per_px
    h = int(px // 1000)
    assert not policy((h, 1000), batch=1)
    assert policy((h + 1, 1000), batch=1)
    # a smaller card turns it on earlier; budget_frac moves the line
    small = common.make_remat_policy("auto", global_batch=8, bf16=bf16,
                                     batch_norm=batch_norm, hbm_bytes=8 * GIB)
    assert small((576, 768)) == (fixed + per_px * 8 * 576 * 768 > 0.8 * 8 * GIB)
    half = common.make_remat_policy("auto", global_batch=8, bf16=bf16,
                                    batch_norm=batch_norm, hbm_bytes=mem,
                                    budget_frac=0.4)
    assert half((h, 1000), batch=1)


def test_on_off_and_the_cpu():
    on = common.make_remat_policy("on", global_batch=4, bf16=False)
    off = common.make_remat_policy("off", global_batch=4, bf16=False)
    assert on((64, 64)) and on((4096, 4096), batch=1)
    assert not off((64, 64)) and not off((8192, 8192), batch=64)
    cpu = common.make_remat_policy("auto", global_batch=4, bf16=False, device="cpu")
    assert not cpu((8192, 8192), batch=64)  # no ceiling on the CPU
    with pytest.raises(ValueError, match="auto"):
        common.make_remat_policy("maybe", global_batch=4, bf16=False)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch_norm", [True, False])
def test_max_launch_pixels_uses_the_remat_constants(bf16, batch_norm):
    mem = 80 * GIB
    tag = "bf16" if bf16 else "f32"
    model = "bn" if batch_norm else "plain"
    for remat in (False, True):
        fixed, per_px = common.TRAIN_FOOTPRINT[(model, remat)][tag]
        got = common.max_launch_pixels(bf16=bf16, hbm_bytes=mem, remat=remat,
                                       batch_norm=batch_norm)
        assert got == (0.92 * mem - fixed) / per_px
    if batch_norm:  # remat frees the BN chain's saved tensors
        assert common.max_launch_pixels(bf16=bf16, hbm_bytes=mem, remat=True) > \
            1.5 * common.max_launch_pixels(bf16=bf16, hbm_bytes=mem, remat=False)
    assert common.max_launch_pixels(bf16=bf16, device="cpu", remat=True) is None


def test_bucketed_step_asks_the_policy_per_launch(monkeypatch):
    asked, remat_runs = [], []
    real = cannet.checkpoint
    monkeypatch.setattr(cannet, "checkpoint",
                        lambda *a, **k: remat_runs.append(1) or real(*a, **k))

    def policy(hw, batch=None):
        asked.append((hw, batch))
        return hw[0] > 40

    step = make_bucketed_train_step(policy=policy, bn_ops=make_bn_ops("kernel"))
    state = _state()
    b = _batch()
    step(state, b)
    assert asked == [((64, 96), 2)] and len(remat_runs) == 6
    small = {k: (v[:, :32, :48] if v.dim() == 4 and v.shape[1] == 64 else
                 v[:, :4, :6] if v.dim() == 4 else v) for k, v in b.items()}
    step(state, small)
    assert asked[-1] == ((32, 48), 2) and len(remat_runs) == 6
