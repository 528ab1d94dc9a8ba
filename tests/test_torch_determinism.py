"""Deterministic training settings and the matrix adaptive pool.

``device.use_deterministic`` sets cuDNN's deterministic algorithms, the
deterministic-algorithms mode, the cuBLAS workspace and
``fill_uninitialized_memory``; the process-wide flags are put back after
each test here.  The adaptive pool is a contraction against averaging
matrices (ATen's CUDA backward has no deterministic form): its forward
equals ATen's and JAX's, its backward ATen's, at sizes that divide the
bins and sizes that do not — f32 within 1e-6.  In bf16 the port's result
is the f32 result rounded once.  ATen's forward lies within one bf16 step
(unit in the last place) of it; ATen's CPU backward rounds each bin's
term and each partial sum, so where a pixel's bins cancel it lies up to
tens of steps from the correctly rounded gradient: against it the port is
held within 2^-6 of the pixel's summed |terms|.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from can_tpu.ops import pooling as jpool
from can_tpu_torch import device as dev
from can_tpu_torch.ops import pooling

SIZES = [(12, 18), (13, 7), (6, 6), (72, 96), (47, 61)]
SCALES = [1, 2, 3, 6]
F32 = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def restore_settings(monkeypatch):
    """Put the process-wide settings back after the test."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.utils.deterministic.fill_uninitialized_memory)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:3]
    torch.utils.deterministic.fill_uninitialized_memory = saved[3]


def test_use_deterministic_sets_what_it_says(restore_settings, monkeypatch):
    import os

    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    dev.use_deterministic()
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    assert torch.utils.deterministic.fill_uninitialized_memory is False
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    # the other deterministic workspace setting is kept, any other replaced
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    dev.use_deterministic()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:2")
    dev.use_deterministic()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_the_train_step_runs_under_deterministic_mode(restore_settings):
    """A BN step with the matrix pool raises nothing under the mode (on
    the CPU, where every op of the step has a deterministic form)."""
    from can_tpu_torch.models import CANNet
    from can_tpu_torch.ops.bn_moments import make_bn_ops
    from can_tpu_torch.train import create_train_state, make_lr_schedule, make_train_step

    dev.use_deterministic()
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 48, 3)).astype(np.float32)),
             "dmap": torch.from_numpy(rng.random((2, 4, 6, 1)).astype(np.float32)),
             "pixel_mask": torch.ones((2, 4, 6, 1)), "sample_mask": torch.ones(2)}
    state = create_train_state(CANNet(seed=0, batch_norm=True), make_lr_schedule(1e-6))
    _, m = make_train_step(bn_ops=make_bn_ops("kernel"))(state, batch)
    assert torch.isfinite(m["loss"])


def _aten(x, s):
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("s", SCALES)
def test_matrix_pool_f32_forward_and_backward_equal_aten_and_jax(hw, s):
    x = np.random.default_rng(hw[0] * 7 + s).standard_normal((2, *hw, 5)).astype(np.float32)
    g = np.random.default_rng(s).standard_normal((2, s, s, 5)).astype(np.float32)
    xm = torch.from_numpy(x).requires_grad_(True)
    xa = torch.from_numpy(x).requires_grad_(True)
    ym, ya = pooling.adaptive_avg_pool2d(xm, s), _aten(xa, s)
    np.testing.assert_allclose(ym.detach().numpy(), ya.detach().numpy(), **F32)
    np.testing.assert_allclose(ym.detach().numpy(),
                               np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), s)),
                               **F32)
    ym.backward(torch.from_numpy(g))
    ya.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xm.grad.numpy(), xa.grad.numpy(), **F32)


def _within_one_bf16_step(got, want):
    """|got - want| is at most one bf16 step (2^(e - 7) for a value in
    [2^e, 2^(e+1)))."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -120)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got - want).abs() <= step).all()), float((got - want).abs().max())


@pytest.mark.parametrize("hw", [(13, 7), (47, 61), (72, 96)])
@pytest.mark.parametrize("s", SCALES)
def test_matrix_pool_bf16_is_one_rounding_of_f32_and_one_step_from_aten(hw, s):
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((2, *hw, 4))
                         .astype(np.float32) + 2.0).to(torch.bfloat16)
    g = torch.from_numpy(np.random.default_rng(s + 1).standard_normal((2, s, s, 4))
                         .astype(np.float32)).to(torch.bfloat16)
    xm, xa = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    xf = x.float().requires_grad_(True)
    ym, ya = pooling.adaptive_avg_pool2d(xm, s), _aten(xa, s)
    yf = pooling.adaptive_avg_pool2d(xf, s)
    assert ym.dtype == torch.bfloat16
    assert torch.equal(ym, yf.to(torch.bfloat16))  # f32, rounded once
    _within_one_bf16_step(ym, ya)
    for y in (ym, ya, yf):
        y.backward(g.to(y.dtype))
    assert xm.grad.dtype == torch.bfloat16
    assert torch.equal(xm.grad, xf.grad.to(torch.bfloat16))
    xs = torch.zeros(x.shape, requires_grad=True)
    pooling.adaptive_avg_pool2d(xs, s).backward(g.float().abs())
    err = (xm.grad.float() - xa.grad.float()).abs()
    assert bool((err <= 2.0 ** -6 * xs.grad).all()), float(err.max())


def test_pool_matrices_are_bins_and_cached_outside_inference_mode():
    m = pooling.adaptive_pool_matrix(7, 3)
    np.testing.assert_array_equal(m.numpy(), jpool._adaptive_pool_matrix_np(7, 3))
    np.testing.assert_allclose(m.sum(1).numpy(), 1.0, rtol=1e-6)
    # the first call at a shape inside inference mode (an eval forward)
    # must not leave an inference tensor for a later training backward
    with torch.inference_mode():
        pooling.adaptive_avg_pool2d(torch.ones(1, 11, 17, 2), 3)
    x = torch.ones(1, 11, 17, 2, requires_grad=True)
    pooling.adaptive_avg_pool2d(x, 3).sum().backward()
    assert x.grad is not None and not pooling.adaptive_pool_matrix(11, 3).is_inference()
