"""can_tpu_torch.ops against can_tpu.ops on the CPU: resize, pooling, conv.

Same numpy inputs through both packages; f32 at rtol 1e-5 / atol 1e-6
(both compute in f32, only the summation order differs).  The bf16 cases
pin the f32-accumulation contract of the pooling/1x1 paths: two bf16
roundings apart at most.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from can_tpu.ops import conv as jconv
from can_tpu.ops import pooling as jpool
from can_tpu.ops import resize as jresize
from can_tpu_torch.ops import conv, pooling, resize

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2 * 2.0 ** -8  # two bf16 roundings


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("s", [1, 2, 3, 6])
@pytest.mark.parametrize("hw", [(7, 11), (12, 16), (6, 6), (13, 5)])
def test_adaptive_avg_pool_matches_jax(s, hw):
    x = _x((2, *hw, 8))
    _close(pooling.adaptive_avg_pool2d(torch.from_numpy(x), s),
           jpool.adaptive_avg_pool2d(jnp.asarray(x), s))


@pytest.mark.parametrize("s", [1, 3, 6])
def test_adaptive_avg_pool_bf16_accumulates_in_f32(s):
    # 48 x 64 cells per map: a bf16 running sum would drift by many ulps
    x = _x((1, 48, 64, 16), seed=1) + 3.0
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jpool.adaptive_avg_pool2d(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), s)
    got = pooling.adaptive_avg_pool2d(xb, s)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("hw", [(7, 11), (8, 8), (9, 6), (3, 5)])
def test_max_pool_matches_jax_odd_sizes(hw):
    x = _x((2, *hw, 4))
    got = pooling.max_pool2d(torch.from_numpy(x))
    want = jpool.max_pool2d(jnp.asarray(x))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("size_in,size_out", [
    ((1, 1), (5, 7)),    # in == 1: broadcast
    ((2, 3), (9, 4)),
    ((6, 6), (12, 16)),
    ((3, 2), (1, 1)),    # out == 1: reads index 0
    ((4, 5), (4, 5)),    # in == out: identity
    ((6, 6), (47, 61)),  # the ragged feature map of the kernel checks
])
def test_resize_align_corners_matches_jax(size_in, size_out):
    x = _x((2, *size_in, 8))
    _close(resize.resize_bilinear_align_corners(torch.from_numpy(x), size_out),
           jresize.resize_bilinear_align_corners(jnp.asarray(x), size_out))


@pytest.mark.parametrize("n_in,n_out", [(1, 1), (1, 9), (2, 96), (3, 128),
                                        (6, 47), (7, 1), (5, 5)])
def test_upsample_matrix_is_the_jax_matrix(n_in, n_out):
    got = resize.upsample_matrix(n_in, n_out)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  jresize._upsample_matrix_np(n_in, n_out))


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("padding", [None, 0])
def test_conv2d_matches_jax(dilation, padding):
    x = _x((2, 9, 10, 5))
    w = _x((3, 3, 5, 4), seed=1) * 0.3  # HWIO
    b = _x((4,), seed=2)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        dilation=dilation, padding=padding,
                        precision="highest")
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = conv.conv2d(torch.from_numpy(x), w_oihw, torch.from_numpy(b),
                      dilation=dilation, padding=padding)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_conv2d_output_conv_1x1_padding0():
    x = _x((2, 5, 7, 64))
    w = _x((1, 1, 64, 1), seed=3) * 0.1
    b = _x((1,), seed=4)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        padding=0, precision="highest")
    got = conv.conv2d(torch.from_numpy(x),
                      torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                      torch.from_numpy(b), padding=0)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv1x1_matches_jax(dtype):
    x = _x((2, 3, 3, 64))
    w = _x((64, 32), seed=5) * 0.1  # (Cin, Cout)
    if dtype == "f32":
        want = jconv.conv1x1(jnp.asarray(x), jnp.asarray(w), precision="highest")
        _close(conv.conv1x1(torch.from_numpy(x), torch.from_numpy(w)), want)
    else:
        xb = torch.from_numpy(x).to(torch.bfloat16)
        wb = torch.from_numpy(w).to(torch.bfloat16)
        want = jconv.conv1x1(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16),
                             precision="highest")
        got = conv.conv1x1(xb, wb)
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want, np.float32), rtol=BF16_RTOL, atol=1e-6)


def test_nhwc_in_channels_last_out():
    """A contiguous NHWC activation reaches the conv as channels_last
    storage: the NHWC -> NCHW permute is a view, not a copy."""
    x = torch.from_numpy(_x((1, 6, 6, 8)))
    w = torch.from_numpy(_x((4, 8, 3, 3))).contiguous(
        memory_format=torch.channels_last)
    assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    y = conv.conv2d(x, w)
    assert tuple(y.shape) == (1, 6, 6, 4)
