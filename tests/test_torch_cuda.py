"""The context kernel on the card (marker ``cuda``; skipped without a GPU).

Runs on a machine with an NVIDIA GPU and nvcc, from the repo root
(``--noconftest``: tests/conftest.py sets up JAX, which that machine
lacks and these tests do not use):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

No JAX here: the kernel is held against its plain PyTorch version, at the
tolerances chip_smoke.py states (f32 rtol/atol 1e-5, bf16 2e-2 / 1e-2).
"""

import pytest
import torch

from can_tpu_torch.models import CANNet, random_state_dict
from can_tpu_torch.ops import cuda_context as cc

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def _inputs(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    b, h, w, c = shape
    fv = torch.randn(shape, generator=g, device=device).to(dtype)
    aves = [torch.randn((b, s, s, c), generator=g, device=device).to(dtype)
            for s in cc.SCALES]
    ws = [(torch.randn((c, c), generator=g, device=device) / c ** 0.5).to(dtype)
          for _ in cc.SCALES]
    return cc.pack_inputs(fv, aves, ws, (h, w)), fv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 20, 512), (2, 47, 61, 512),
                                   (3, 5, 7, 128), (1, 1, 1, 64)])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    (avew, uh, wmat), fv = _inputs(shape, dtype, cuda)
    before = cc.LAUNCHES
    got = cc.context_tail_cuda(fv, avew, uh, wmat)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 1
    want = cc.context_tail_reference(fv, avew, uh, wmat)
    assert got.dtype == dtype and got.shape == fv.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_kernel_is_deterministic(cuda):
    (avew, uh, wmat), fv = _inputs((2, 24, 40, 512), torch.float32, cuda)
    a = cc.context_tail_cuda(fv, avew, uh, wmat)
    b = cc.context_tail_cuda(fv, avew, uh, wmat)
    assert torch.equal(a, b)


def test_kernel_refuses_what_it_does_not_take(cuda):
    (avew, uh, wmat), fv = _inputs((1, 4, 4, 96), torch.float32, cuda)
    with pytest.raises(ValueError, match="C %"):
        cc.context_tail_cuda(fv, avew, uh, wmat)
    (avew, uh, wmat), fv = _inputs((1, 4, 4, 64), torch.float32, cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        cc.context_tail_cuda(fv.requires_grad_(), avew, uh, wmat)
    with pytest.raises(TypeError):
        cc.context_tail_cuda(fv.detach().half(), avew, uh, wmat.half())


def _no_gates(fv, aves, weights, hw):
    return cc.reference_context(fv, aves, [torch.zeros_like(w) for w in weights],
                                hw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_forward_goes_through_the_kernel(cuda, dtype):
    """He-scaled weights: the gates vary, so the map depends on the
    kernel's gate products (zeroing the gate matrices moves it by many
    tolerances) and the comparison with the plain seam can see them."""
    torch.backends.cudnn.allow_tf32 = False
    model = CANNet(seed=None, device=cuda, dtype=dtype).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(0, he=True).items()})
    x = torch.randn((2, 64, 96, 3), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    with torch.inference_mode():
        before = cc.LAUNCHES
        got = model(x, compute_dtype=dtype)
        assert cc.LAUNCHES == before + 1
        model.context_fused = cc.reference_context
        want = model(x, compute_dtype=dtype)
        model.context_fused = _no_gates
        flat = model(x, compute_dtype=dtype)
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(want.float().abs().max())
    assert scale > 1e-2  # O(1) activations, not the reference init's ~1e-8
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=rtol * scale)
    assert float((flat.float() - want.float()).abs().max()) > 5 * rtol * scale
