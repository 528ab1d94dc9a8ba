"""The BN slice against the JAX package: masked moment sums (the CUDA
kernel's plain version and its autograd backward), ``bn_moments``'s three
implementations, ``_batch_norm``, the context kernel's backward, and the
BN model's forward and one train step.

The JAX side runs as its own CPU tests run it: ``pallas_bn`` and
``pallas_context`` in interpret mode, ``make_bn_ops("pallas",
interpret=True)``.  On the CPU the port's dispatch takes the plain
versions; the two ``autograd.Function`` backwards are exercised by
standing the plain forward in for the kernel launch (the backward never
touches the kernel).  Tolerances, each with its reason:

* moment sums: rtol 1e-5 of sum|y m| and sum y^2 m per channel (f32
  summation order only), s0 exact;
* moments, ``_batch_norm`` outputs and running stats: rtol 1e-5 /
  atol 1e-6 (f32 summation order; E[x^2] - mean^2 cancellation is not
  exercised at these scales);
* gradients: rtol 1e-5 / atol 1e-6 f32 (the same VJP formula), one bf16
  rounding in bf16;
* the model step (f32, He-scaled weights): loss rtol 1e-5, new running
  stats rtol 1e-4, each parameter's update (new - old) within 1e-3 of
  JAX's in relative L2 norm — pre-BN conv biases excluded, as in
  tests/parity_utils.py: BN cancels them, so their true gradient is 0 and
  their update is float residue (bounded in absolute size instead);
* a bf16 step's loss within 2e-2 of JAX's bf16 step.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from can_tpu.data.batching import pad_batch
from can_tpu.models import cannet_apply, cannet_init, init_batch_stats
from can_tpu.models.cannet import LocalOps
from can_tpu.models.cannet import _batch_norm as jax_batch_norm
from can_tpu.ops import bn_moments as jbm
from can_tpu.ops import pallas_bn, pallas_context
from can_tpu.train import create_train_state, make_lr_schedule, make_optimizer
from can_tpu.train import make_train_step as jax_make_train_step
from can_tpu_torch.models import CANNet
from can_tpu_torch.models.cannet import _batch_norm
from can_tpu_torch.ops import bn_moments as bm
from can_tpu_torch.ops import cuda_bn as cb
from can_tpu_torch.ops import cuda_context as cc
from can_tpu_torch.train import create_train_state as torch_train_state
from can_tpu_torch.train import make_lr_schedule as torch_lr_schedule
from can_tpu_torch.train import make_train_step
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from test_torch_model import he_scaled_params

IMPLS = [("twopass", "twopass"), ("onepass", "onepass"), ("kernel", "pallas")]


def _masked_input(shape, *, mask="pad", seed=0, dtype=np.float32):
    """y ~ 2 N(0, 1) + 0.5 and a mask with bucket padding (bottom rows,
    right columns) and one fill slot; "zeros" = an all-fill batch."""
    rng = np.random.default_rng(seed)
    b, h, w, _ = shape
    y = (2 * rng.standard_normal(shape) + 0.5).astype(dtype)
    m = np.ones((b, h, w, 1), np.float32)
    if mask == "pad":
        m[:, h - h // 4:] = 0
        m[:, :, w - w // 3:] = 0
        m[-1] = 0
    elif mask == "zeros":
        m[:] = 0
    return y, m


def _jax_bn_ops(impl):
    return jbm.make_bn_ops(impl, interpret=True)


# -- moment sums ----------------------------------------------------------
@pytest.mark.parametrize("mask", ["pad", "ones", "zeros"])
@pytest.mark.parametrize("shape", [(2, 8, 12, 64), (3, 5, 7, 512)])
def test_moment_sums_match_jax_and_pallas_kernel(shape, mask):
    y, m = _masked_input(shape, mask=mask)
    got = [t.numpy() for t in cb.moment_sums(torch.from_numpy(y), torch.from_numpy(m))]
    ref = jbm.masked_moment_sums(jnp.asarray(y), jnp.asarray(m))
    kern = pallas_bn.moment_sums(jnp.asarray(y), jnp.asarray(m), interpret=True)
    scale1 = np.abs(y * m).sum(axis=(0, 1, 2))
    scale2 = (y * y * m).sum(axis=(0, 1, 2))
    for want in (ref, kern):
        want = [np.asarray(t) for t in want]
        assert np.all(np.abs(got[0] - want[0]) <= 1e-5 * scale1)
        assert np.all(np.abs(got[1] - want[1]) <= 1e-5 * scale2)
        assert float(got[2]) == float(want[2])
    if mask == "zeros":
        assert not got[0].any() and not got[1].any() and float(got[2]) == 0.0


def test_moment_sums_cpu_never_launches():
    y, m = _masked_input((2, 4, 4, 64))
    before = cb.LAUNCHES
    cb.moment_sums(torch.from_numpy(y), torch.from_numpy(m))
    assert cb.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        cb.moment_sums_cuda(torch.from_numpy(y), torch.from_numpy(m))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moment_sums_function_gradient_matches_jax_vjp(monkeypatch, dtype):
    """``MomentSums.backward`` against ``jax.vjp`` of ``pallas_bn._sums``
    (the custom VJP: the jnp twin, re-differentiated)."""
    # the kernel's forward, stood in by its plain version on the CPU
    monkeypatch.setattr(cb, "moment_sums_cuda",
                        lambda y, m: cb.masked_moment_sums(y.float(), m))
    y, m = _masked_input((2, 6, 10, 64), seed=1)
    rng = np.random.default_rng(2)
    g1, g2 = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    yt = torch.from_numpy(y).to(tdt).requires_grad_()
    s1, s2, s0 = cb.MomentSums.apply(yt, torch.from_numpy(m))
    (dy,) = torch.autograd.grad((s1 * torch.from_numpy(g1)).sum()
                                + (s2 * torch.from_numpy(g2)).sum(), (yt,))
    yj = jnp.asarray(yt.detach().float().numpy()).astype(jdt)
    _, vjp = jax.vjp(lambda a: pallas_bn._sums(a, jnp.asarray(m), True),
                     yj)
    (want,) = vjp((jnp.asarray(g1), jnp.asarray(g2), jnp.zeros((), jnp.float32)))
    assert dy.dtype == tdt and want.dtype == jdt
    rtol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(dy.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("mask", ["pad", "ones", "zeros"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moment_sums_backward_twin_matches_jax_vjp(dtype, mask):
    """``masked_moment_sums_backward`` (the backward kernel's plain twin,
    dy = m (g1 + 2 g2 y) rounded once to y's dtype) against ``jax.vjp``
    of ``pallas_bn._sums`` in interpret mode: f32 to rtol 1e-5 (the same
    formula, summed in another order), bf16 to one bf16 rounding."""
    y, m = _masked_input((2, 6, 10, 64), mask=mask, seed=12)
    rng = np.random.default_rng(13)
    g1, g2 = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    yt = torch.from_numpy(y).to(tdt)
    dy = cb.masked_moment_sums_backward(yt, torch.from_numpy(m),
                                        torch.from_numpy(g1), torch.from_numpy(g2))
    yj = jnp.asarray(yt.float().numpy()).astype(jdt)
    _, vjp = jax.vjp(lambda a: pallas_bn._sums(a, jnp.asarray(m), True), yj)
    (want,) = vjp((jnp.asarray(g1), jnp.asarray(g2), jnp.zeros((), jnp.float32)))
    assert dy.dtype == tdt and want.dtype == jdt and dy.shape == yt.shape
    rtol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(dy.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=1e-6)
    if mask == "zeros":
        assert not dy.float().any()


def test_moment_sums_backward_cpu_is_the_plain_recompute():
    """On a CPU tensor ``MomentSums`` differentiates the plain forward and
    launches nothing; the kernel wrapper refuses a CPU tensor."""
    y, m = _masked_input((2, 4, 6, 64), seed=14)
    rng = np.random.default_rng(15)
    g1, g2 = (torch.from_numpy(rng.standard_normal(64).astype(np.float32))
              for _ in range(2))
    yt, mt = torch.from_numpy(y), torch.from_numpy(m)
    before = cb.BACKWARD_LAUNCHES
    dy = cb.MomentSums.backward(type("Ctx", (), {"saved_tensors": (yt, mt)})(),
                                g1, g2, None)[0]
    assert cb.BACKWARD_LAUNCHES == before
    torch.testing.assert_close(dy, cb.moment_sums_vjp_plain(yt, mt, g1, g2),
                               rtol=0, atol=0)
    torch.testing.assert_close(dy, cb.masked_moment_sums_backward(yt, mt, g1, g2),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cb.moment_sums_backward_cuda(yt, mt, g1, g2)
    cb.reset_launches()
    assert cb.LAUNCHES == cb.BACKWARD_LAUNCHES == 0


# -- bn_moments -----------------------------------------------------------
@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("mask", ["pad", "zeros"])
def test_masked_moments_match_jax(impl, jimpl, mask):
    y, m = _masked_input((3, 8, 12, 64), mask=mask, seed=3)
    ops = bm.make_bn_ops(impl) or bm.BNOps()
    jops = _jax_bn_ops(jimpl) or jbm.BNOps()
    got = ops.masked_moments(torch.from_numpy(y), torch.from_numpy(m), ())
    want = jops.masked_moments(jnp.asarray(y), jnp.asarray(m), ())
    assert ops.impl == impl
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_unmasked_moments_and_collectives_refused():
    y, _ = _masked_input((2, 4, 6, 64), seed=4)
    yt = torch.from_numpy(y)
    mean_t, var_t = bm.global_moments_twopass(yt, ())
    mean_o, var_o = bm.global_moments_onepass(yt, ())
    np.testing.assert_allclose(mean_t.numpy(), y.mean(axis=(0, 1, 2)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var_t.numpy(), y.var(axis=(0, 1, 2)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean_o.numpy(), mean_t.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var_o.numpy(), var_t.numpy(), rtol=1e-5, atol=1e-6)
    # SyncBN sums over a process group (tests/test_torch_ddp.py); a JAX
    # mesh-axis name is no group
    with pytest.raises(TypeError, match="ProcessGroup"):
        bm.masked_moments_onepass(yt, torch.ones(2, 4, 6, 1), ("data",))
    assert bm.make_bn_ops(None) is None and bm.make_bn_ops("twopass") is None
    with pytest.raises(ValueError, match="pallas"):
        bm.make_bn_ops("pallas")


# -- _batch_norm ----------------------------------------------------------
def _bn_params(c, seed=5):
    rng = np.random.default_rng(seed)
    return ({"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
             "bias": rng.standard_normal(c).astype(np.float32)},
            {"mean": rng.standard_normal(c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)})


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("mask", ["pad", "zeros", None])
def test_batch_norm_train_matches_jax(impl, jimpl, mask):
    y, m = _masked_input((2, 8, 12, 64), mask=mask or "ones", seed=6)
    params, stats = _bn_params(64)
    mt = None if mask is None else torch.from_numpy(m)
    mj = None if mask is None else jnp.asarray(m)
    out, upd = _batch_norm(torch.from_numpy(y), _t(params), _t(stats), True, 0.1,
                           mask=mt, bn_ops=bm.make_bn_ops(impl))
    jout, jupd = jax_batch_norm(jnp.asarray(y), _j(params), _j(stats), True, 0.1,
                                mask=mj, bn_ops=_jax_bn_ops(jimpl))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        assert upd[k].dtype == torch.float32 and not upd[k].requires_grad
        np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                   rtol=1e-5, atol=1e-6)
        if mask == "zeros":  # an all-fill batch leaves the running stats alone
            np.testing.assert_array_equal(upd[k].numpy(), stats[k])


def test_batch_norm_eval_matches_jax():
    y, _ = _masked_input((2, 8, 12, 64), seed=7)
    params, stats = _bn_params(64)
    out, upd = _batch_norm(torch.from_numpy(y), _t(params), _t(stats), False, 0.1)
    jout, _ = jax_batch_norm(jnp.asarray(y), _j(params), _j(stats), False, 0.1)
    assert upd is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_batch_norm_bf16_keeps_f32_accumulators(impl, jimpl):
    y, m = _masked_input((2, 8, 12, 64), seed=8)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    params, stats = _bn_params(64)
    out, upd = _batch_norm(yb, _t(params), _t(stats), True, 0.1,
                           mask=torch.from_numpy(m), bn_ops=bm.make_bn_ops(impl))
    yj = jnp.asarray(yb.float().numpy()).astype(jnp.bfloat16)
    jout, jupd = jax_batch_norm(yj, _j(params), _j(stats), True, 0.1,
                                mask=jnp.asarray(m), bn_ops=_jax_bn_ops(jimpl))
    assert out.dtype == torch.bfloat16
    for k in ("mean", "var"):
        # the same bf16 values summed in f32 on both sides
        assert upd[k].dtype == torch.float32
        np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


# -- the context kernel's backward ----------------------------------------
def test_context_function_gradients_match_jax_vjp(monkeypatch):
    """``ContextTail.backward`` against ``jax.vjp`` of
    ``pallas_context._reference`` (the JAX custom VJP's recompute)."""
    monkeypatch.setattr(cc, "context_tail_cuda", cc.context_tail_reference)
    b, h, w, c = 2, 6, 10, 128
    rng = np.random.default_rng(9)
    fv = rng.standard_normal((b, h, w, c)).astype(np.float32)
    aves = [rng.standard_normal((b, s, s, c)).astype(np.float32) for s in cc.SCALES]
    ws = [(rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
          for _ in cc.SCALES]
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    avew, uh = cc.precompute([torch.from_numpy(a) for a in aves], (h, w))
    leaves = [torch.from_numpy(fv).requires_grad_(), avew.clone().requires_grad_(),
              uh, torch.from_numpy(np.stack(ws)).requires_grad_()]
    out = cc.ContextTail.apply(*leaves)
    dfv, davew, dw = torch.autograd.grad(out, [leaves[0], leaves[1], leaves[3]],
                                         torch.from_numpy(g))
    javews, juhs = pallas_context._precompute([jnp.asarray(a) for a in aves], (h, w))
    _, vjp = jax.vjp(pallas_context._reference, jnp.asarray(fv), tuple(javews),
                     tuple(juhs), tuple(jnp.asarray(x) for x in ws))
    jfv, javew, _, jw = vjp(jnp.asarray(g))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(pallas_context._reference(
                                   jnp.asarray(fv), tuple(javews), tuple(juhs),
                                   tuple(jnp.asarray(x) for x in ws))), **tol)
    np.testing.assert_allclose(dfv.numpy(), np.asarray(jfv), **tol)
    for k, (off, s) in enumerate(zip(cc.ROW_OFFSETS, cc.SCALES)):
        np.testing.assert_allclose(davew[:, off:off + s].numpy(),
                                   np.asarray(javew[k]), **tol)
        np.testing.assert_allclose(dw[k].numpy(), np.asarray(jw[k]), **tol)


# -- the BN model ---------------------------------------------------------
def jax_bn_params(seed: int = 0):
    """A ``cannet_init(batch_norm=True)`` tree (N(0, 0.01) weights, zero
    biases, BN scale 1 / bias 0) drawn with numpy — ``cannet_init`` itself
    compiles one random op per distinct shape, ~10 s on the CPU — then
    He-scaled (``test_torch_model.he_scaled_params``) so the comparisons
    bite."""
    shapes = jax.eval_shape(lambda k: cannet_init(k, batch_norm=True),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("b", "bias"):
            return np.zeros(s.shape, np.float32)
        if name == "scale":
            return np.ones(s.shape, np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    return he_scaled_params(jax.tree_util.tree_map_with_path(leaf, shapes))


@pytest.fixture(scope="module")
def bn_params():
    return jax_bn_params()


def _step_batch(fill: bool = True, bucket=(64, 96)):
    """Bucket h x w (64 x 96 by default): an h x h image (padded), then a
    fill slot or an h x w image."""
    rng = np.random.default_rng(10)
    h, w = bucket
    img = rng.standard_normal((h, h, 3)).astype(np.float32)
    dm = rng.uniform(0, 0.1, (h // 8, h // 8, 1)).astype(np.float32)
    img2 = rng.standard_normal((h, w, 3)).astype(np.float32)
    dm2 = rng.uniform(0, 0.1, (h // 8, w // 8, 1)).astype(np.float32)
    b = (pad_batch([(img, dm)], bucket, 2, [True], 8) if fill else
         pad_batch([(img, dm), (img2, dm2)], bucket, 2, [True, True], 8))
    return {k: getattr(b, k) for k in ("image", "dmap", "pixel_mask", "sample_mask")}


def _port_model(params, batch_stats=None):
    model = CANNet(seed=None, batch_norm=True)
    model.load_state_dict(state_dict_from_jax_params(params, batch_stats))
    return model


def test_bn_model_forward_matches_jax(bn_params):
    """Train mode (batch moments through the masks, new running stats)
    and eval mode (those stats) against ``cannet_apply``, run op by op
    with the Pallas moments kernel's plain reference (onepass; the kernel
    itself is held against it above)."""
    batch = _step_batch()
    stats0 = jax.tree.map(np.asarray, init_batch_stats(bn_params))
    jout, jstats = cannet_apply(
        bn_params, jnp.asarray(batch["image"]), batch_stats=stats0, train=True,
        pixel_mask=jnp.asarray(batch["pixel_mask"]),
        sample_mask=jnp.asarray(batch["sample_mask"]),
        ops=LocalOps(bn_ops=_jax_bn_ops("onepass")))
    model = _port_model(bn_params)
    with torch.no_grad():
        out = model(torch.from_numpy(batch["image"]), train=True,
                    pixel_mask=torch.from_numpy(batch["pixel_mask"]),
                    sample_mask=torch.from_numpy(batch["sample_mask"]),
                    bn_ops=bm.make_bn_ops("kernel"))
    scale = np.abs(np.asarray(jout)).max()
    assert scale > 1e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4 * scale)
    want = state_dict_from_jax_params(bn_params, jax.tree.map(np.asarray, jstats))
    got = model.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    jeval = cannet_apply(bn_params, jnp.asarray(batch["image"]),
                         batch_stats=jstats, train=False)
    with torch.no_grad():
        ev = model(torch.from_numpy(batch["image"]))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jeval), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jeval)).max())


def _pre_bn_bias(key, sd):
    prefix, leaf = key.rsplit(".", 1)
    group, idx = prefix.split(".")[0], prefix.split(".")[-1]
    return (leaf == "bias" and group in ("frontend", "backend")
            and f"{group}.{int(idx) + 1}.running_mean" in sd)


def _one_step(params, *, dtype: str, fill: bool = True, bucket=(64, 96)):
    """One train step at lr 1e-3 through both packages on ``_step_batch``;
    dtype "f32", "bf16" (compute) or "f64" (parameters and data, under
    jax_enable_x64).  Returns (old, new, JAX's new) state dicts and both
    steps' metrics."""
    batch = _step_batch(fill, bucket)
    if dtype == "f64":
        batch = {k: v.astype(np.float64) for k, v in batch.items()}
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    lr = 1e-3
    opt = make_optimizer(make_lr_schedule(lr))
    jstate = create_train_state(jax.tree.map(jnp.asarray, params), opt,
                                jax.tree.map(lambda a: jnp.asarray(a, batch["image"].dtype),
                                             init_batch_stats(params)))
    # the fused context tail, as the port always runs it (its plain
    # version on the CPU): f32 gates, sums and division under bf16 compute
    apply_fn = partial(cannet_apply, ops=LocalOps(
        bn_ops=_jax_bn_ops("pallas"),
        context_fused=pallas_context.make_fused_context(interpret=True)))
    jstep = jax.jit(jax_make_train_step(
        apply_fn, opt, compute_dtype=jnp.bfloat16 if dtype == "bf16" else None,
        health_metrics=True))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(params)
    if dtype == "f64":
        model = model.double()
    old = {k: v.clone() for k, v in model.state_dict().items()}
    state = torch_train_state(model, torch_lr_schedule(lr))
    step = make_train_step(compute_dtype=torch.bfloat16 if dtype == "bf16" else None,
                           bn_ops=bm.make_bn_ops("kernel"), health_metrics=True)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = {k: v.double() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats)).items()}
    return old, model.state_dict(), want, m, jm, state


def _compare_updates(old, got, want) -> dict:
    """Worst relative differences of one step: running stats (max abs
    diff over max abs) and each parameter's update (relative L2 norm);
    the largest pre-BN conv bias update (whose true value is 0)."""
    out = {"stats": 0.0, "update": 0.0, "pre_bn_bias": 0.0, "checked": 0}
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            diff = float((got[k].double() - want[k]).abs().max()
                         / want[k].abs().max())
            out["stats"] = max(out["stats"], diff)
            continue
        d_port = (got[k] - old[k]).double()
        d_jax = want[k] - old[k].double()
        if _pre_bn_bias(k, want):
            out["pre_bn_bias"] = max(out["pre_bn_bias"], float(d_port.abs().max()))
            continue
        rel = float((d_port - d_jax).norm() / d_jax.norm())
        out["update"] = max(out["update"], rel)
        out["checked"] += 1
    return out


def test_bn_train_step_matches_jax(bn_params):
    """f32: loss, running stats and the health norms."""
    old, got, want, m, jm, state = _one_step(bn_params, dtype="f32")
    assert state.step == 1
    assert all(int(got[k]) == 1 for k in got if k.endswith("num_batches_tracked"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["num_valid"]) == float(jm["num_valid"]) == 1.0
    assert _compare_updates(old, got, want)["stats"] <= 1e-4
    # health norms against float64 norms of JAX's own update (JAX's
    # in-program vdot sums of squares are ~1e-3 off on the CPU); on the
    # first step the momentum buffer is the gradient, so update = lr * grad
    d_all = np.sqrt(sum(float(((want[k] - old[k].double()) ** 2).sum())
                        for k in want if not k.endswith(
                            ("running_mean", "running_var", "num_batches_tracked"))))
    np.testing.assert_allclose(float(m["update_norm"]), d_all, rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]) * 1e-3,
                               float(m["update_norm"]), rtol=1e-6)
    assert abs(float(jm["update_norm"]) / d_all - 1) < 5e-2


def test_bn_train_step_updates_match_jax_in_x64():
    """Each parameter's update within 1e-3 of JAX's (relative L2), in
    float64 on both sides: in f32, backprop through 16 stacked BNs
    amplifies summation-order noise to ~1e-3 in the earliest layers.  A
    subprocess, because x64 is process-wide JAX config (as
    tests/bn_sp_x64_worker.py).  The port's context tail and loss stay
    f32 inside (the kernel's contract), which bounds the agreement here at
    ~1e-4, not f64 noise."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, "x64"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loss_rel"] <= 1e-5, res
    assert res["stats"] <= 1e-4, res
    assert res["update"] <= 1e-3, res
    assert res["pre_bn_bias"] < 1e-6, res
    assert res["checked"] == 16 * 3 + 2 + 8, res  # conv w, BN scale/bias; out; ctx


def test_bn_train_step_bf16_matches_jax_bf16(bn_params):
    """Two real images (one padded), not a fill slot: with one 8 x 8 valid
    map each backend BN takes its moments over 64 pixels, and bf16
    rounding alone then moves the loss by several percent (the jitted JAX
    step and the same step run op by op differ by 4.6% there)."""
    _, got, _, m, jm, _ = _one_step(bn_params, dtype="bf16", fill=False)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)
    assert all(torch.isfinite(v).all() for v in got.values())


def _x64_main() -> None:
    import json

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # the smallest bucket that keeps every context scale (a 6 x 8 map
    # under the 6 x 6 pool) and still pads the image: XLA's f64 convs on
    # the CPU are the test's cost
    old, got, want, m, jm, _ = _one_step(jax_bn_params(), dtype="f64",
                                         bucket=(48, 64))
    res = _compare_updates(old, got, want)
    res["loss_rel"] = abs(float(m["loss"]) - float(jm["loss"])) / abs(float(jm["loss"]))
    print(json.dumps(res))


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["x64"]:
        _x64_main()
