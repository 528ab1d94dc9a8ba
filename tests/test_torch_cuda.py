"""The CUDA kernels on the card (marker ``cuda``; skipped without a GPU).

Runs on a machine with an NVIDIA GPU and nvcc, from the repo root
(``--noconftest``: tests/conftest.py sets up JAX, which that machine
lacks and these tests do not use):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

No JAX here: each kernel is held against its plain PyTorch version, at the
tolerances chip_smoke.py states — context: f32 rtol/atol 1e-5, bf16
2e-2 / 1e-2; BN moment sums: s1 and s2 within 1e-5 of sum|y m| and
sum y^2 m per channel (only the summation order differs: bf16 is widened
exactly), s0 exact; BN backward dy: f32 rtol 1e-6, bf16 one bf16 rounding.
Device prefetch (pinned memory, side stream) is held against a
synchronous copy, and eval at prefetch depth 2 against depth 0, exactly.
"""

import numpy as np
import pytest
import torch

from can_tpu_torch.models import CANNet, random_state_dict
from can_tpu_torch.ops import cuda_bn as cb
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
                                   (3, 5, 7, 128), (1, 1, 1, 64),
                                   # pixel counts off the 128-pixel tile and
                                   # off its 8 x 16 image tiling
                                   (1, 9, 17, 64), (3, 13, 31, 256),
                                   (8, 72, 96, 512)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda, dtype):
    (avew, uh, wmat), fv = _inputs((2, 24, 40, 512), dtype, cuda)
    a = cc.context_tail_cuda(fv, avew, uh, wmat)
    b = cc.context_tail_cuda(fv, avew, uh, wmat)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_runs_past_the_old_pixel_cap(cuda, dtype):
    """4.3 M pixels: more than the 65535 x 64 = 4.19 M that riding pixel
    tiles on grid.y allowed."""
    shape = (2, 1024, 2100, 64)
    assert shape[0] * shape[1] * shape[2] > 65535 * 64
    (avew, uh, wmat), fv = _inputs(shape, dtype, cuda, seed=5)
    got = cc.context_tail_cuda(fv, avew, uh, wmat)
    torch.cuda.synchronize()
    want = cc.context_tail_reference(fv, avew, uh, wmat)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_its_decomposition(cuda, dtype):
    """The kernel computes what ``context_tail_decomposed`` emulates: in
    f32 the two differ only in summation order."""
    (avew, uh, wmat), fv = _inputs((2, 16, 40, 512), dtype, cuda, seed=6)
    got = cc.context_tail_cuda(fv, avew, uh, wmat)
    want = cc.context_tail_decomposed(fv, avew, uh, wmat)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_kernel_refuses_what_it_does_not_take(cuda):
    (avew, uh, wmat), fv = _inputs((1, 4, 4, 96), torch.float32, cuda)
    with pytest.raises(ValueError, match="C %"):
        cc.context_tail_cuda(fv, avew, uh, wmat)
    (avew, uh, wmat), fv = _inputs((1, 4, 4, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        cc.context_tail_cuda(fv.half(), avew, uh, wmat.half())
    with pytest.raises(ValueError, match="uh"):
        cc.context_tail_cuda(fv, avew, uh[:, :6], wmat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_context_function_gradients_match_plain_version(cuda, dtype):
    """``ContextTail``: the kernel forward, the plain version's VJP for
    fv, avew and wmat (uh gets none)."""
    (avew, uh, wmat), fv = _inputs((2, 12, 20, 128), dtype, cuda, seed=3)
    g = torch.randn(fv.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda).to(dtype)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(i != 2)
                  for i, t in enumerate((fv, avew, uh, wmat))]
        out = fn(*leaves)
        out.backward(g)
        return out, [leaves[i].grad for i in (0, 1, 3)], leaves[2].grad

    before = cc.LAUNCHES
    out_k, gk, uh_k = grads(cc.context_tail)
    assert cc.LAUNCHES == before + 1  # the recompute is the plain version
    out_p, gp, _ = grads(cc.context_tail_reference)
    assert uh_k is None
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(out_k.float(), out_p.float(), rtol=rtol, atol=atol)
    for a, b in zip(gk, gp):
        # the backward IS the plain version's: the same computation on the
        # same inputs, so only library summation order may differ
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


def _bn_inputs(shape, dtype, device, *, pad=True, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    b, h, w, c = shape
    y = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    m = torch.ones((b, h, w, 1), device=device)
    if pad:  # bucket padding on the right and bottom, and one fill slot
        m[:, h - h // 4:] = 0
        m[:, :, w - w // 3:] = 0
        if b > 1:
            m[-1] = 0
    return y, m


def _check_sums(got, y, m):
    yf = y.float()
    s1, s2, s0 = got
    w1, w2, w0 = cb.masked_moment_sums(yf, m)
    scale1 = torch.sum((yf * m).abs(), dim=(0, 1, 2))
    scale2 = torch.sum(yf * yf * m, dim=(0, 1, 2))
    assert s1.dtype == s2.dtype == s0.dtype == torch.float32
    assert bool(((s1 - w1).abs() <= 1e-5 * scale1).all())
    assert bool(((s2 - w2).abs() <= 1e-5 * scale2).all())
    assert float(s0) == float(w0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (3, 37, 51, 128),
                                   (2, 9, 13, 256), (4, 18, 24, 512),
                                   (1, 1, 1, 64),
                                   # ragged: n_pix % 4 != 0 (m's hand-copied
                                   # end), 8 channels, a partial last stage,
                                   # two channel groups (C / vec > 256)
                                   (3, 1, 1, 64), (1, 3, 3, 8), (5, 7, 11, 32),
                                   (1, 7, 9, 2048)])
def test_bn_kernel_matches_plain_version(cuda, shape, dtype):
    y, m = _bn_inputs(shape, dtype, cuda)
    before = cb.LAUNCHES
    got = cb.moment_sums_cuda(y, m)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + 1
    _check_sums(got, y, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 8, 512), (1, 12, 8, 512), (1, 2, 3, 64)])
def test_bn_kernel_below_one_full_cluster(cuda, shape, dtype):
    """Grids that do not fill whole clusters: one block (a cluster of 1),
    and in f32 (1, 12, 8, 512)'s three blocks of pixels rounded up to two
    clusters of 2 with an empty block."""
    b, h, w, c = shape
    n = b * h * w
    plan = cb.forward_plan(n, c, dtype)
    assert plan["blocks"] % plan["cluster"] == 0
    assert plan["blocks"] * plan["chunk"] >= n
    if shape == (1, 2, 3, 64):
        assert plan["blocks"] == plan["cluster"] == 1
    if shape == (1, 12, 8, 512) and dtype == torch.float32:
        assert (plan["blocks"] - 1) * plan["chunk"] >= n  # one block has no pixels
    y, m = _bn_inputs(shape, dtype, cuda, seed=2)
    _check_sums(cb.moment_sums_cuda(y, m), y, m)


def test_bn_kernel_s0_above_2_24_valid_pixels(cuda):
    """16,793,603 valid pixels (odd, above 2^24): s0 is the f32 nearest
    the true count (a tie, to even), not an f32 running count's drift."""
    import numpy as np

    shape = (1, 4097, 4099, 8)
    y, m = _bn_inputs(shape, torch.bfloat16, cuda, pad=False, seed=3)
    n = shape[1] * shape[2]
    assert n > 2 ** 24 and n % 2 == 1
    s1, s2, s0 = cb.moment_sums_cuda(y, m)
    assert float(s0) == float(np.float32(n)) == n + 1
    yf = y.float()
    scale1 = torch.sum((yf * m).abs(), dim=(0, 1, 2))
    assert bool(((s1 - (yf * m).sum(dim=(0, 1, 2))).abs() <= 1e-5 * scale1).all())
    assert bool(((s2 - (yf * yf * m).sum(dim=(0, 1, 2))).abs()
                 <= 1e-5 * (yf * yf * m).sum(dim=(0, 1, 2))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernels_take_misaligned_views(cuda, dtype):
    """y and m as views 4 bytes past a 16-byte boundary: the wrapper
    copies them aligned, and both kernels give the plain answers."""
    shape = (2, 9, 13, 64)
    y0, m0 = _bn_inputs(shape, dtype, cuda, seed=4)
    ybuf = torch.empty(y0.numel() + 8, device=cuda, dtype=dtype)
    mbuf = torch.empty(m0.numel() + 4, device=cuda)
    y = ybuf[2 if dtype == torch.bfloat16 else 1:][:y0.numel()].view(shape)
    m = mbuf[1:][:m0.numel()].view(m0.shape)
    y.copy_(y0)
    m.copy_(m0)
    assert y.data_ptr() % 16 and m.data_ptr() % 16
    _check_sums(cb.moment_sums_cuda(y, m), y0, m0)
    g1 = torch.linspace(-1, 1, 64, device=cuda)
    g2 = torch.linspace(0.5, -0.5, 64, device=cuda)
    assert torch.equal(cb.moment_sums_backward_cuda(y, m, g1, g2),
                       cb.moment_sums_backward_cuda(y0, m0, g1, g2))


def test_bn_kernel_on_two_streams(cuda):
    """Calls in flight on two streams at once each keep their own ticket
    and partials: every result is bitwise the one-stream result."""
    ya, ma = _bn_inputs((8, 72, 96, 64), torch.float32, cuda, seed=5)
    yb, mb = _bn_inputs((4, 36, 48, 128), torch.float32, cuda, seed=6)
    want_a = torch.cat([t.reshape(-1) for t in cb.moment_sums_cuda(ya, ma)])
    want_b = torch.cat([t.reshape(-1) for t in cb.moment_sums_cuda(yb, mb)])
    sa, sb = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    got_a, got_b = [], []
    for _ in range(20):
        with torch.cuda.stream(sa):
            got_a.append(torch.cat([t.reshape(-1) for t in cb.moment_sums_cuda(ya, ma)]))
        with torch.cuda.stream(sb):
            got_b.append(torch.cat([t.reshape(-1) for t in cb.moment_sums_cuda(yb, mb)]))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want_a) for g in got_a)
    assert all(torch.equal(g, want_b) for g in got_b)
    keys = [k for k in cb._scratch if k[0] == cuda.index]
    assert (cuda.index, sa.cuda_stream) in keys and (cuda.index, sb.cuda_stream) in keys


def test_bn_kernel_is_one_launch_per_call(cuda):
    """torch.profiler sees exactly one device kernel per forward call and
    one per backward call."""
    from torch.profiler import ProfilerActivity, profile

    y, m = _bn_inputs((8, 72, 96, 512), torch.bfloat16, cuda, seed=7)
    g1 = torch.linspace(-1, 1, 512, device=cuda)
    g2 = torch.linspace(0.5, -0.5, 512, device=cuda)
    cb.moment_sums_cuda(y, m)
    cb.moment_sums_backward_cuda(y, m, g1, g2)
    torch.cuda.synchronize()
    for fn in (lambda: cb.moment_sums_cuda(y, m),
               lambda: cb.moment_sums_backward_cuda(y, m, g1, g2)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and kernels[0].count == 3, [
            (ev.key, ev.count) for ev in kernels]


def test_bn_kernel_all_zero_mask_gives_exact_zeros(cuda):
    y, m = _bn_inputs((2, 16, 24, 64), torch.float32, cuda)
    s1, s2, s0 = cb.moment_sums_cuda(y, torch.zeros_like(m))
    assert not bool(s1.any()) and not bool(s2.any()) and float(s0) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernel_is_deterministic(cuda, dtype):
    y, m = _bn_inputs((8, 72, 96, 512), dtype, cuda)
    a = torch.cat([t.reshape(-1) for t in cb.moment_sums_cuda(y, m)])
    b = torch.cat([t.reshape(-1) for t in cb.moment_sums_cuda(y, m)])
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (3, 37, 51, 128),
                                   (1, 3, 3, 8), (8, 72, 96, 512),
                                   (1, 7, 9, 2048)])
def test_bn_backward_kernel_matches_twin(cuda, shape, dtype):
    """dy = m (g1 + 2 g2 y) against ``masked_moment_sums_backward``: f32
    within rtol 1e-6, bf16 within one bf16 rounding; bitwise repeatable."""
    y, m = _bn_inputs(shape, dtype, cuda, seed=8)
    g = torch.Generator(device=cuda).manual_seed(9)
    g1 = torch.randn((shape[-1],), generator=g, device=cuda)
    g2 = torch.randn((shape[-1],), generator=g, device=cuda)
    before = cb.BACKWARD_LAUNCHES
    dy = cb.moment_sums_backward_cuda(y, m, g1, g2)
    torch.cuda.synchronize()
    assert cb.BACKWARD_LAUNCHES == before + 1
    want = cb.masked_moment_sums_backward(y, m, g1, g2)
    assert dy.dtype == dtype and dy.shape == y.shape
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(dy.float(), want.float(), rtol=rtol, atol=1e-30)
    assert torch.equal(dy, cb.moment_sums_backward_cuda(y, m, g1, g2))


def test_bn_kernel_refuses_what_it_does_not_take(cuda):
    y, m = _bn_inputs((2, 4, 4, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        cb.moment_sums_cuda(y.half(), m)
    with pytest.raises(ValueError, match="C %"):
        cb.moment_sums_cuda(y[..., :62].contiguous(), m)
    with pytest.raises(ValueError, match="m:"):
        cb.moment_sums_cuda(y, m[..., 0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        cb.moment_sums_cuda(y.cpu(), m.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_function_gradient_is_plain_vjp(cuda, dtype):
    """dy = g1 m + 2 g2 y m, cast to y's dtype, by the backward kernel
    through autograd; m gets no gradient."""
    y, m = _bn_inputs((2, 8, 12, 128), dtype, cuda)
    y.requires_grad_()
    s1, s2, s0 = cb.moment_sums(y, m)
    g1 = torch.linspace(-1, 1, 128, device=cuda)
    g2 = torch.linspace(0.5, -0.5, 128, device=cuda)
    before = cb.BACKWARD_LAUNCHES
    (dy,) = torch.autograd.grad((s1 * g1).sum() + (s2 * g2).sum(), (y,))
    assert cb.BACKWARD_LAUNCHES == before + 1  # the backward is the kernel
    want = ((g1 + 2 * g2 * y.detach().float()) * m).to(dtype)
    assert dy.dtype == dtype
    # f32: rounding order of the two terms; bf16: one rounding of that
    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(dy.float(), want.float(), rtol=rtol, atol=1e-6)


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


def _host_batches(n, seed=0):
    from can_tpu_torch.data import pad_batch

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (int(rng.integers(8, 65)) * 8 for _ in range(2))
        b = int(rng.integers(1, 5))
        items = [(rng.standard_normal((h, w, 3)).astype(np.float32),
                  rng.uniform(0, 1, (h // 8, w // 8, 1)).astype(np.float32))
                 for _ in range(b)]
        out.append(pad_batch(items, (h, w), b + 1, [True] * b, 8))
    return out


def test_prefetch_on_a_side_stream_equals_a_synchronous_copy(cuda):
    """50 batches of changing shapes through pinned memory and a side
    stream, two ahead, while the consumer keeps the card busy (a long
    product queued before each read) and churns the caching allocator
    (every freed block handed out again at once and overwritten): each
    batch must arrive equal to a plain synchronous copy."""
    from can_tpu_torch.data.prefetch import DevicePut, prefetch_to_device
    from can_tpu_torch.train.steps import batch_to_device

    host = _host_batches(50)
    a = torch.randn((2048, 2048), device=cuda)
    seen = 0
    for i, dev in enumerate(prefetch_to_device(host, DevicePut(cuda), depth=2)):
        busy = a @ a  # queued ahead of the reads on the consumer stream
        got = {k: t.clone() for k, t in dev.items()}
        sizes = [t.numel() for t in dev.values()]
        del dev
        junk = [torch.full((n,), float("nan"), device=cuda) for n in sizes]
        want = batch_to_device(host[i], cuda)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        del junk, busy
        seen += 1
    torch.cuda.synchronize()
    assert seen == 50


def test_eval_mae_is_the_same_at_prefetch_depth_0_and_2(cuda, tmp_path):
    from can_tpu_torch.cli import test as eval_cli
    from can_tpu_torch.data import make_synthetic_dataset
    from can_tpu_torch.utils.torch_import import save_params_npz

    make_synthetic_dataset(str(tmp_path / "test_data"), 12,
                           sizes=((128, 160), (96, 128), (120, 88)), seed=4)
    npz = str(tmp_path / "he.npz")
    save_params_npz({k: torch.from_numpy(v) for k, v in
                     random_state_dict(0, he=True).items()}, npz)
    args = ["--data_root", str(tmp_path), "--params-npz", npz,
            "--batch-size", "4", "--pad-multiple", "auto"]
    outs = [eval_cli.evaluate_checkpoint(eval_cli.parse_args(list(args)),
                                         prefetch=d) for d in (0, 2, 0, 2)]
    assert outs[0]["mae"] > 1.0
    for o in outs[1:]:
        assert (o["mae"], o["mse"]) == (outs[0]["mae"], outs[0]["mse"])
