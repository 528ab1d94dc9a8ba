"""The space-to-depth stem against the JAX package's.

* ``space_to_depth``, ``depth_to_space`` and ``fold_stem_kernel`` equal
  JAX's exactly on the same seeded inputs (the fold only places values).
* ``CANNet(s2d_stem=True)`` against ``cannet_apply(s2d_stem=True)`` on
  He-scaled weights, plain and BN models: rtol 1e-3 / atol 1e-4, the
  model tolerance of tests/test_model.py.
* The stem weight's gradient through the fold equals the plain stem's,
  in float64 (the fold is linear in w: autograd trains the original).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from can_tpu.models import cannet_apply
from can_tpu.models.cannet import init_batch_stats
from can_tpu.ops import conv as jconv
from can_tpu_torch.models import CANNet, random_state_dict
from can_tpu_torch.ops import conv
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from test_torch_bn import jax_bn_params
from test_torch_model import jax_params


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(1, 8, 8, 3), (2, 16, 24, 5), (3, 6, 10, 64)])
def test_space_to_depth_round_trip_equals_jax(shape):
    x = _rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = conv.space_to_depth(torch.from_numpy(x))
    want = np.asarray(jconv.space_to_depth(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(conv.depth_to_space(got).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jconv.depth_to_space(jnp.asarray(want))), x)


@pytest.mark.parametrize("cin,cout", [(3, 64), (3, 5), (7, 2)])
def test_fold_stem_kernel_equals_jax(cin, cout):
    w = _rng(cin * cout).standard_normal((3, 3, cin, cout)).astype(np.float32)
    b = _rng(cout).standard_normal(cout).astype(np.float32)
    jw, jb = jconv.fold_stem_kernel(jnp.asarray(w), jnp.asarray(b))
    pw, pb = conv.fold_stem_kernel(torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(b))
    assert tuple(pw.shape) == (4 * cout, 4 * cin, 3, 3)
    np.testing.assert_array_equal(pw.permute(2, 3, 1, 0).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert conv.fold_stem_kernel(torch.from_numpy(w).permute(3, 2, 0, 1))[1] is None
    with pytest.raises(ValueError, match="3x3"):
        conv.fold_stem_kernel(torch.zeros(4, 3, 5, 5))


def test_folded_conv_is_the_stem_conv():
    x = torch.from_numpy(_rng(1).standard_normal((2, 24, 32, 3)))
    w = torch.from_numpy(_rng(2).standard_normal((16, 3, 3, 3)))
    b = torch.from_numpy(_rng(3).standard_normal(16))
    wp, bp = conv.fold_stem_kernel(w, b)
    got = conv.depth_to_space(conv.conv2d(conv.space_to_depth(x), wp, bp))
    np.testing.assert_allclose(got.numpy(), conv.conv2d(x, w, b).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_s2d_forward_matches_cannet_apply(batch_norm):
    params = jax_bn_params(2) if batch_norm else jax_params("he", 2)
    stats = init_batch_stats(params) if batch_norm else None
    x = _rng(4).standard_normal((2, 64, 96, 3)).astype(np.float32)
    kw = {"batch_stats": stats} if batch_norm else {}
    want = np.asarray(cannet_apply(params, jnp.asarray(x), s2d_stem=True,
                                   precision="highest", **kw))
    model = CANNet(seed=None, batch_norm=batch_norm, s2d_stem=True)
    model.load_state_dict(state_dict_from_jax_params(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1e-2  # He-scaled: the comparison bites
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_stem_gradient_through_the_fold_equals_the_plain_stem_f64():
    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(5, he=True).items()}
    x = torch.from_numpy(_rng(6).standard_normal((2, 32, 48, 3)))
    grads = {}
    for s2d in (False, True):
        model = CANNet(seed=None, dtype=torch.float64, s2d_stem=s2d)
        model.load_state_dict(sd)
        model(x).square().sum().backward()
        grads[s2d] = (model.frontend[0].weight.grad, model.frontend[0].bias.grad)
    for a, b in zip(grads[True], grads[False]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()))


def test_s2d_f32_forward_is_as_close_to_f64_as_the_plain_stem():
    """In f32 the two stems differ only by rounding, amplified through the
    16 layers after the stem: the folded stem's forward lies no further
    from the f64 forward than twice the plain stem's own f32 error."""
    sd = {k: torch.from_numpy(v) for k, v in
          random_state_dict(7, he=True, batch_norm=True).items()}
    x = torch.from_numpy(_rng(8).standard_normal((2, 96, 128, 3)))
    outs = {}
    for s2d in (False, True):
        for dt in (torch.float32, torch.float64):
            model = CANNet(seed=None, batch_norm=True, s2d_stem=s2d, dtype=dt)
            model.load_state_dict(sd)
            with torch.no_grad():
                outs[(s2d, dt)] = model.eval()(x.to(dt)).double()
    truth = outs[(False, torch.float64)]
    np.testing.assert_allclose(outs[(True, torch.float64)].numpy(), truth.numpy(),
                               rtol=1e-12, atol=1e-12 * float(truth.abs().max()))

    def err(t):
        return float((t - truth).abs().max() / truth.abs().max())

    plain, folded = err(outs[(False, torch.float32)]), err(outs[(True, torch.float32)])
    assert 0 < plain < 1e-4
    assert folded <= 2 * plain, (folded, plain)
