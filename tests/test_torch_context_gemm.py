"""The context kernel's decomposition on the CPU: ``context_tail_decomposed``
(the kernel's arithmetic — Wcat by permutation, Q = avew @ W_k in f32, one
product fv @ Wcat, the gate epilogue sigmoid(sum_s uh Q - acc)) against
the JAX package's Pallas kernel (interpret mode) and its jnp twin
``_reference``, and against the port's plain version.

Inputs come from numpy with a seed; gate matrices are He-scaled
(N(0, 2/C)), so the gates vary.  Tolerances are the kernel's: f32 rtol /
atol 1e-5, bf16 2e-2 / 1e-2.  The TPU kernel rounds the contrast to bf16
before its product; the decomposition multiplies bf16 fv by bf16 W with
f32 sums and takes sm @ W in f32, so it sits inside the same bf16 bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from can_tpu.ops import pallas_context as jpc
from can_tpu_torch.ops import cuda_context as cc

TOL = {"f32": (1e-5, 1e-5), "bf16": (2e-2, 1e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the Pallas kernel runs (not its fallback) where W % 16 == 0 and C % 128 == 0
SHAPES = [(2, 8, 16, 128), (1, 8, 16, 512)]


def _inputs(shape, seed, fv_scale=1.0, ave_scale=1.0):
    """fv, the four pooled maps and He-scaled gate matrices, f32 numpy."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    fv = (rng.standard_normal(shape) * fv_scale).astype(np.float32)
    aves = [(rng.standard_normal((b, s, s, c)) * ave_scale).astype(np.float32)
            for s in cc.SCALES]
    ws = [(rng.standard_normal((c, c)) * np.sqrt(2.0 / c)).astype(np.float32)
          for _ in cc.SCALES]
    return fv, aves, ws


def _rounded(arrays, tdt):
    """The same (already rounded) values as torch tensors and jnp arrays."""
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()) for t in ts]


def _decomposed(fv_t, aves_t, ws_t, hw):
    avew, uh, wmat = cc.pack_inputs(fv_t, aves_t, ws_t, hw)
    return cc.context_tail_decomposed(fv_t, avew, uh, wmat)


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decomposed_matches_pallas_kernel(shape, dtype):
    jdt, tdt = DT[dtype]
    fv, aves, ws = _inputs(shape, seed=10)
    (fv_t, *rest), (fv_j, *rest_j) = _rounded([fv, *aves, *ws], tdt)
    aves_t, ws_t = rest[:4], rest[4:]
    aves_j, ws_j = rest_j[:4], rest_j[4:]
    assert jpc.supports(shape)  # the kernel itself, not its fallback
    want = jpc.make_fused_context(interpret=True)(
        fv_j.astype(jdt), [a.astype(jdt) for a in aves_j],
        [x.astype(jdt) for x in ws_j], shape[1:3])
    got = _decomposed(fv_t, aves_t, ws_t, shape[1:3])
    assert got.dtype == tdt and tuple(got.shape) == shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decomposed_matches_jnp_twin(dtype):
    """The JAX ``_reference`` (all f32) on the packed JAX precompute."""
    shape = (2, 12, 20, 128)  # W % 16 != 0: a shape the Pallas kernel refuses
    _, tdt = DT[dtype]
    fv, aves, ws = _inputs(shape, seed=11)
    (fv_t, *rest), (fv_j, *rest_j) = _rounded([fv, *aves, *ws], tdt)
    javews, juhs = jpc._precompute(rest_j[:4], shape[1:3])
    want = jpc._reference(fv_j, tuple(javews), tuple(juhs), tuple(rest_j[4:]))
    got = _decomposed(fv_t, rest[:4], rest[4:], shape[1:3])
    _close(got, want, dtype)


@pytest.mark.parametrize("shape", [(2, 8, 16, 128), (3, 5, 7, 64),
                                   (1, 1, 1, 64), (1, 9, 33, 192)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decomposed_matches_plain_version(shape, dtype):
    _, tdt = DT[dtype]
    fv, aves, ws = _inputs(shape, seed=12)
    fv_t, *rest = [torch.from_numpy(a).to(tdt) for a in (fv, *aves, *ws)]
    avew, uh, wmat = cc.pack_inputs(fv_t, rest[:4], rest[4:], shape[1:3])
    got = cc.context_tail_decomposed(fv_t, avew, uh, wmat)
    want = cc.context_tail_reference(fv_t, avew, uh, wmat)
    _close(got, want, dtype)


def _truth(fv, avew, uh, wmat):
    """The function in float64, contrast first."""
    fv, avew, uh, wmat = (t.double() for t in (fv, avew, uh, wmat))
    num = den = 0.0
    for k, (off, s) in enumerate(zip(cc.ROW_OFFSETS, cc.SCALES)):
        sm = torch.einsum("hs,bswc->bhwc", uh[:, off:off + s], avew[:, off:off + s])
        gate = torch.sigmoid(torch.matmul(sm - fv, wmat[k]))
        num, den = num + gate * sm, den + gate
    return num / (den + cc.EPS)


@pytest.mark.parametrize("case", ["fv_x100", "all_x100"])
def test_decomposed_holds_under_cancellation(case):
    """q - acc subtracts two f32 terms larger than the logit.  With fv x100
    (and, in ``all_x100``, the pooled maps x100 too, so sm @ W and fv @ W
    are both large) the problem is ill-conditioned in f32 itself: the
    contrast-first f32 plain version is ~0.8x (fv_x100) and ~20x
    (all_x100) the 1e-5 tolerance away from the float64 answer.  So the
    decomposition is held to the float64 answer within 4x the plain f32
    version's own error there (measured: 2.1x and 1.4x), and must reach the
    x100 scale in its output."""
    shape = (2, 8, 16, 128)
    fv, aves, ws = _inputs(shape, seed=13, fv_scale=100.0,
                           ave_scale=100.0 if case == "all_x100" else 1.0)
    fv_t = torch.from_numpy(fv)
    avew, uh, wmat = cc.pack_inputs(fv_t, [torch.from_numpy(a) for a in aves],
                                    [torch.from_numpy(x) for x in ws], shape[1:3])
    truth = _truth(fv_t, avew, uh, wmat)
    plain_err = (cc.context_tail_reference(fv_t, avew, uh, wmat).double()
                 - truth).abs().max().item()
    got_err = (cc.context_tail_decomposed(fv_t, avew, uh, wmat).double()
               - truth).abs().max().item()
    assert plain_err > 0
    assert got_err <= 4 * plain_err, (got_err, plain_err)
    if case == "all_x100":
        assert truth.abs().max().item() > 10  # the x100 reached fi


def _wmat_from(wcat):
    """The inverse permutation of ``cc.wcat_from``."""
    c = wcat.shape[0]
    k = wcat.shape[1] // c
    return (wcat.reshape(c, c // cc.WCAT_BLOCK, k, cc.WCAT_BLOCK)
            .permute(2, 0, 1, 3).reshape(k, c, c))


@pytest.mark.parametrize("c", [64, 128, 512])
def test_wcat_is_a_permutation_that_round_trips(c):
    rng = np.random.default_rng(c)
    wmat = torch.from_numpy(rng.standard_normal((4, c, c)).astype(np.float32))
    wcat = cc.wcat_from(wmat)
    assert tuple(wcat.shape) == (c, 4 * c)
    assert torch.equal(_wmat_from(wcat), wmat)
    # column (d // 32) * 128 + k * 32 + d % 32 of Wcat is column d of W_k
    blk = cc.WCAT_BLOCK
    for k in range(4):
        for d in (0, 1, blk - 1, blk, c - 1):
            j = (d // blk) * 4 * blk + k * blk + d % blk
            assert torch.equal(wcat[:, j], wmat[k][:, d])
    # bf16 is permuted, never rounded again
    wb = wmat.to(torch.bfloat16)
    assert torch.equal(_wmat_from(cc.wcat_from(wb)), wb)
    # the bf16 launch's K-major operand is the same permutation, transposed
    assert torch.equal(cc.wcat_t_from(wb), cc.wcat_from(wb).t())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_q_is_avew_times_w_per_row_block(dtype):
    _, tdt = DT[dtype]
    shape = (2, 6, 10, 64)
    fv, aves, ws = _inputs(shape, seed=14)
    fv_t, *rest = [torch.from_numpy(a).to(tdt) for a in (fv, *aves, *ws)]
    avew, _, wmat = cc.pack_inputs(fv_t, rest[:4], rest[4:], shape[1:3])
    q = cc.q_reference(avew, wmat)
    assert q.dtype == torch.float32 and q.shape == avew.shape
    a64 = avew.double().numpy()
    for k, (off, s) in enumerate(zip(cc.ROW_OFFSETS, cc.SCALES)):
        want = a64[:, off:off + s] @ wmat[k].double().numpy()
        np.testing.assert_allclose(q[:, off:off + s].numpy(), want,
                                   rtol=1e-5, atol=1e-5)
