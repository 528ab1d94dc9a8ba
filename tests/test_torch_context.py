"""The fused context tail: the port's plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) and its jnp block.

On the CPU the port's seam runs ``context_tail_reference``, the plain
version the CUDA kernel is held against on the card.  Tolerances are
those of tests/test_pallas_context.py: f32 rtol 1e-5 / atol 1e-6, bf16
rtol 2e-2 / atol 1e-2.  (1, 8, 20, 512) is ragged for the TPU kernel
(W % 16 != 0): JAX routes it to its fallback; the port has no shape
rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from can_tpu.models import cannet_init
from can_tpu.models.cannet import LocalOps
from can_tpu.models.cannet import context_block as jax_context_block
from can_tpu.ops import pallas_context as jpc
from can_tpu_torch.models.cannet import context_block
from can_tpu_torch.ops import cuda_context as cc

SHAPES = [(2, 16, 32, 512), (1, 8, 20, 512)]
TOL = {"f32": (1e-5, 1e-6), "bf16": (2e-2, 1e-2)}


@pytest.fixture(scope="module")
def cparams_np():
    cp = cannet_init(jax.random.key(0))["context"]
    return jax.tree.map(np.asarray, cp)


def _torch_cparams(cp):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
            for k, d in cp.items()}


def _fv(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_pallas_kernel(cparams_np, shape, dtype):
    fv = _fv(shape)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    fvt = torch.from_numpy(fv).to(tdt)
    # the same (already rounded) values on both sides
    fvj = jnp.asarray(fvt.float().numpy()).astype(jdt)
    ops = LocalOps(context_fused=jpc.make_fused_context(interpret=True))
    want = jax_context_block(cparams_np, fvj, ops=ops)
    before = cc.LAUNCHES
    with torch.no_grad():
        got = context_block(_torch_cparams(cparams_np), fvt,
                            context_fused=cc.make_fused_context())
    assert cc.LAUNCHES == before  # a CPU tensor never launches the kernel
    assert got.dtype == tdt and tuple(got.shape) == shape
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_seam_matches_jnp_context_block(cparams_np, shape):
    """The port's seam (on the CPU, the plain version) and the JAX jnp
    block (upsample, 1x1, sigmoid per scale)."""
    fv = _fv(shape, seed=1)
    want = np.asarray(jax_context_block(cparams_np, jnp.asarray(fv)))
    with torch.no_grad():
        got = context_block(_torch_cparams(cparams_np), torch.from_numpy(fv),
                            context_fused=cc.make_fused_context())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_packed_precompute_is_jax_precompute(cparams_np):
    """avew/uh packed at row offsets 0, 1, 3, 6 hold exactly the JAX
    ``_precompute`` tensors, and the plain version on them equals the JAX
    twin ``_reference``."""
    b, h, w, c = 2, 12, 20, 512
    rng = np.random.default_rng(2)
    aves = [rng.standard_normal((b, s, s, c)).astype(np.float32)
            for s in cc.SCALES]
    fv = _fv((b, h, w, c), seed=3)
    weights = [np.array(cparams_np[f"s{s}"]["weight"]) for s in cc.SCALES]
    javews, juhs = jpc._precompute([jnp.asarray(a) for a in aves], (h, w))
    avew, uh = cc.precompute([torch.from_numpy(a) for a in aves], (h, w))
    assert tuple(avew.shape) == (b, cc.N_ROWS, w, c)
    assert tuple(uh.shape) == (h, cc.N_ROWS)
    for off, s, ja, ju in zip(cc.ROW_OFFSETS, cc.SCALES, javews, juhs):
        np.testing.assert_allclose(avew[:, off:off + s].numpy(), np.asarray(ja),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(uh[:, off:off + s].numpy(), np.asarray(ju))
    wmat = torch.stack([torch.from_numpy(x) for x in weights])
    got = cc.context_tail_reference(torch.from_numpy(fv), avew, uh, wmat)
    want = jpc._reference(jnp.asarray(fv), tuple(javews), tuple(juhs),
                          tuple(jnp.asarray(x) for x in weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cuda_entry_refuses_cpu_tensors(cparams_np):
    fv = torch.zeros((1, 8, 8, 512))
    aves = [torch.zeros((1, s, s, 512)) for s in cc.SCALES]
    weights = [torch.zeros((512, 512)) for _ in cc.SCALES]
    avew, uh, wmat = cc.pack_inputs(fv, aves, weights, (8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cc.context_tail_cuda(fv, avew, uh, wmat)


def test_seam_refuses_sharded_hw(cparams_np):
    fv = torch.zeros((1, 8, 8, 512))
    aves = [torch.zeros((1, s, s, 512)) for s in cc.SCALES]
    weights = [torch.zeros((512, 512)) for _ in cc.SCALES]
    with pytest.raises(ValueError, match="single-device"):
        cc.make_fused_context()(fv, aves, weights, (16, 8))


def test_kernel_build_refuses_outside_a_checkout(tmp_path, monkeypatch):
    """The kernels build into <checkout>/build; an installed copy with no
    checkout around it raises instead of writing beside site-packages."""
    from can_tpu_torch.ops import _build

    assert (_build.CHECKOUT / "pyproject.toml").is_file()
    assert _build.BUILD_ROOT == _build.CHECKOUT / "build" / "can_tpu_torch"
    monkeypatch.setattr(_build, "CHECKOUT", tmp_path)
    with pytest.raises(RuntimeError, match="checkout"):
        _build.load_kernel_library("context_fused_not_loaded")


def test_precompute_refuses_wrong_scales():
    aves = [torch.zeros((1, s, s, 8)) for s in (1, 2, 4, 6)]
    with pytest.raises(ValueError, match="scales"):
        cc.precompute(aves, (8, 8))
