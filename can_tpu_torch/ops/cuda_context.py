"""The fused CANNet context tail: CUDA kernel, plain version, seam.

Replaces the Pallas TPU kernel ``can_tpu/ops/pallas_context.py::_kernel``
(``pl.pallas_call`` in ``_fused_forward``, entry ``make_fused_context``).
For each scale k in (1, 2, 3, 6)::

    sm_k   = upsample(ave_k)                       (row interp of avew_k)
    gate_k = sigmoid((sm_k - fv) @ W_k)
    num   += gate_k * sm_k ;  den += gate_k
    fi     = num / (den + 1e-12)

The kernel (``csrc/context_fused.cu``) computes the same function through
the linearity of the logits::

    (sm_k - fv) @ W_k = sum_s uh * Q[off_k + s] - fv @ W_k,
    Q[b, r, w, :]     = avew[b, r, w, :] @ W_k(r)

One wrapper call runs two device launches: Q (avew's shape, f32, an f32
GEMM in the kernel itself), then ONE GEMM ``fv @ Wcat`` — Wcat the four
W_k side by side, columns in the order (channel block of 32, scale,
channel within the block), a permutation of ``wmat`` — whose epilogue
reads Q and avew at the pixel's 12 rows and folds the gates into num and
den in registers.  bf16 runs the GEMM on tensor cores (``wgmma``
m64n128k16, f32 sums; Wcat passed transposed so both operands are
K-major); f32 on CUDA-core FMAs (no TF32).

What bounds it on an H100: operations — 208.6 GFLOP for an 8 x 96 x 128
x 512 feature map (the four products and the elementwise work) against
~400 MB of compulsory f32 traffic; beside them the epilogue needs 24 f32
values per output (12 rows of Q and of avew), which the kernel stages in
shared memory once per 8 x 16-pixel tile.

Numerics: in bf16, fv and W are bf16 as given, their products summed in
f32, and sm @ W is taken in f32 (Q): closer to the all-f32 plain version
than the TPU kernel, which rounds the contrast to bf16 before its
product.  ``context_tail_decomposed`` is a plain PyTorch emulation of the
kernel's arithmetic at its rounding points, for the tests; nothing on the
main path calls it.

Under spatial parallelism (``parallel/spatial.py``) each H-shard calls the
seam with ``row0``, its first row of the whole feature map: the kernel
reads uh per local row, so the shard runs it unchanged with rows ``[row0,
row0 + H_local)`` of the whole map's uh (``pack_inputs``).

On a CPU tensor the seam runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises — no fallback.  ``LAUNCHES`` counts one
per wrapper call (its two device launches together).  Gradients: on the
card the kernel runs inside a ``torch.autograd.Function``
(``ContextTail``) whose backward recomputes the plain version on the
saved inputs and returns its VJP for fv, avew and wmat — the JAX custom
VJP's recompute-in-backward (pallas_context.py:177-191).  The backward is
plain PyTorch: the JAX package has no backward kernel either.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from can_tpu_torch.ops._build import load_kernel_library
from can_tpu_torch.ops.resize import upsample_matrix

SCALES = (1, 2, 3, 6)
ROW_OFFSETS = (0, 1, 3, 6)  # each scale's first row in the packed buffers
N_ROWS = sum(SCALES)
EPS = 1e-12
KERNEL = "context_fused"
WCAT_BLOCK = 32  # channels per Wcat column block (csrc: kDB)

# Kernel launches since the last reset_launches(): proof that a run went
# through the kernel (the plain version and CPU tensors never count).
# Fleet replicas launch from several threads at once, and ``+= 1`` on a
# global is a read, an add and a write: the lock keeps every increment.
LAUNCHES = 0
_launches_lock = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    with _launches_lock:
        LAUNCHES = 0


def _count_launch() -> None:
    global LAUNCHES
    with _launches_lock:
        LAUNCHES += 1


def precompute(aves: Sequence[torch.Tensor],
               hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the per-scale inputs, all f32 (``_precompute`` of the TPU
    kernel): avew (B, 12, W, C) — each pooled (B, S, S, C) projection
    interpolated along W — and uh (H, 12), the row-interpolation
    matrices, both at row offsets ``ROW_OFFSETS``."""
    if [a.shape[1] for a in aves] != list(SCALES):
        raise ValueError(f"expected pooled maps for scales {SCALES}, got "
                         f"{[tuple(a.shape) for a in aves]}")
    h, w = hw
    dev = aves[0].device
    avews, uhs = [], []
    for ave in aves:
        uw = upsample_matrix(ave.shape[2], w, dev)  # (W, S)
        avews.append(torch.einsum("bpqc,wq->bpwc", ave.float(), uw))
        uhs.append(upsample_matrix(ave.shape[1], h, dev))  # (H, S)
    return torch.cat(avews, 1).contiguous(), torch.cat(uhs, 1).contiguous()


def context_tail_reference(fv: torch.Tensor, avew: torch.Tensor,
                           uh: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``_reference`` of the TPU
    kernel): everything in f32, result in fv's dtype.  fv (B, H, W, C);
    avew, uh as ``precompute`` returns; wmat (4, C, C)."""
    fvf = fv.float()
    num = torch.zeros_like(fvf)
    den = torch.zeros_like(fvf)
    for k, (off, s) in enumerate(zip(ROW_OFFSETS, SCALES)):
        sm = torch.einsum("hs,bswc->bhwc", uh[:, off:off + s],
                          avew[:, off:off + s])
        gate = torch.sigmoid(torch.matmul(sm - fvf, wmat[k].float()))
        num = num + gate * sm
        den = den + gate
    return (num / (den + EPS)).to(fv.dtype)


def wcat_from(wmat: torch.Tensor) -> torch.Tensor:
    """(4, C, C) gate matrices -> Wcat (C, 4C), columns in the order
    (channel block of ``WCAT_BLOCK``, scale, channel within the block): a
    permutation, no arithmetic.  Needs C % WCAT_BLOCK == 0."""
    k, c, _ = wmat.shape
    return (wmat.reshape(k, c, c // WCAT_BLOCK, WCAT_BLOCK)
            .permute(1, 2, 0, 3).reshape(c, k * c).contiguous())


def wcat_t_from(wmat: torch.Tensor) -> torch.Tensor:
    """Wcat transposed, (4C, C), in one permutation: the K-major B operand
    of the bf16 launch."""
    k, c, _ = wmat.shape
    return (wmat.reshape(k, c, c // WCAT_BLOCK, WCAT_BLOCK)
            .permute(2, 0, 3, 1).reshape(k * c, c).contiguous())


def q_reference(avew: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Q = avew[:, rows of scale k] @ W_k for each scale, f32, avew's
    shape: what the kernel's first launch computes."""
    return torch.cat([
        torch.matmul(avew[:, off:off + s], wmat[k].float())
        for k, (off, s) in enumerate(zip(ROW_OFFSETS, SCALES))], 1)


def context_tail_decomposed(fv: torch.Tensor, avew: torch.Tensor,
                            uh: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch emulation of the kernel's arithmetic: Wcat by
    permutation, Q in f32, the one product fv @ Wcat with fv and Wcat as
    given (bf16 exact) summed in f32, then the gate epilogue
    ``sigmoid(sum_s uh Q - acc)`` in f32; one rounding to fv's dtype.
    For the tests: nothing on the main path calls it."""
    b, h, w, c = fv.shape
    wcat = wcat_from(wmat)
    q = q_reference(avew, wmat)
    acc = torch.matmul(fv.reshape(-1, c).float(), wcat.float())
    acc = acc.reshape(b, h, w, c // WCAT_BLOCK, len(SCALES), WCAT_BLOCK)
    num = torch.zeros((b, h, w, c), dtype=torch.float32, device=fv.device)
    den = torch.zeros_like(num)
    for k, (off, s) in enumerate(zip(ROW_OFFSETS, SCALES)):
        rows = uh[:, off:off + s]
        qk = torch.einsum("hs,bswc->bhwc", rows, q[:, off:off + s])
        sm = torch.einsum("hs,bswc->bhwc", rows, avew[:, off:off + s])
        gate = torch.sigmoid(qk - acc[..., k, :].reshape(b, h, w, c))
        num = num + gate * sm
        den = den + gate
    return (num / (den + EPS)).to(fv.dtype)


def load_library() -> ctypes.CDLL:
    lib = load_kernel_library(KERNEL)
    if lib.context_fused_forward.argtypes is None:
        # every pointer and the stream as c_void_p: a default ctypes int
        # would cut a 64-bit address to 32 bits
        lib.context_fused_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.context_fused_forward.restype = ctypes.c_int
        lib.context_fused_channel_tile.argtypes = []
        lib.context_fused_channel_tile.restype = ctypes.c_int
        lib.context_fused_wcat_block.argtypes = []
        lib.context_fused_wcat_block.restype = ctypes.c_int
        if lib.context_fused_wcat_block() != WCAT_BLOCK:
            raise RuntimeError(
                f"csrc/context_fused.cu orders Wcat in blocks of "
                f"{lib.context_fused_wcat_block()} channels, this wrapper "
                f"in blocks of {WCAT_BLOCK}")
    return lib


def context_tail_cuda(fv: torch.Tensor, avew: torch.Tensor, uh: torch.Tensor,
                      wmat: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/context_fused.cu`` on the current stream (two device
    launches: Q, then fv @ Wcat with the gate tail; one count in
    ``LAUNCHES``); same arguments and result as
    ``context_tail_reference``.  Raises on anything the kernel does not
    take."""
    if not fv.is_cuda:
        raise ValueError(f"context_tail_cuda runs on CUDA tensors, got fv on "
                         f"{fv.device} (context_tail dispatches by device)")
    if fv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"context_fused takes f32 or bf16 fv, got {fv.dtype}")
    if fv.dim() != 4:
        raise ValueError(f"fv must be (B, H, W, C), got {tuple(fv.shape)}")
    b, h, w, c = fv.shape
    want = {"avew": ((b, N_ROWS, w, c), torch.float32, avew),
            "uh": ((h, N_ROWS), torch.float32, uh),
            "wmat": ((len(SCALES), c, c), fv.dtype, wmat)}
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != fv.device:
            raise ValueError(f"{name} is on {t.device}, fv on {fv.device}")
    lib = load_library()
    tile = lib.context_fused_channel_tile()
    if c % tile:
        raise ValueError(f"context_fused needs C % {tile} == 0, got C={c}")
    fv, avew, uh, wmat = (t.contiguous() for t in (fv, avew, uh, wmat))
    out = torch.empty_like(fv)
    if out.numel() == 0:
        return out
    # bf16: wgmma reads both operands K-major, so Wcat goes transposed
    wcat = wcat_t_from(wmat) if fv.dtype == torch.bfloat16 else wcat_from(wmat)
    q = torch.empty_like(avew)
    with torch.cuda.device(fv.device):
        stream = torch.cuda.current_stream(fv.device).cuda_stream
        rc = lib.context_fused_forward(
            fv.data_ptr(), avew.data_ptr(), uh.data_ptr(), wmat.data_ptr(),
            wcat.data_ptr(), q.data_ptr(), out.data_ptr(), b, h, w, c,
            int(fv.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"context_fused kernel launch failed: CUDA error "
                           f"{rc} for fv {tuple(fv.shape)} {fv.dtype}")
    _count_launch()
    return out


class ContextTail(torch.autograd.Function):
    """The kernel forward with the JAX custom VJP's backward: recompute
    ``context_tail_reference`` on the saved inputs and differentiate it
    (uh, a constant interpolation matrix, gets no gradient)."""

    @staticmethod
    def forward(ctx, fv, avew, uh, wmat):
        ctx.save_for_backward(fv, avew, uh, wmat)
        return context_tail_cuda(fv, avew, uh, wmat)

    @staticmethod
    def backward(ctx, g):
        fv, avew, uh, wmat = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need[i] and i != 2)
                      for i, t in enumerate((fv, avew, uh, wmat))]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                context_tail_reference(*leaves), wrt, g) if wrt else ())
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def context_tail(fv, avew, uh, wmat) -> torch.Tensor:
    """Device dispatch: the plain version for a CPU tensor, the kernel
    (with its recompute backward) for a CUDA tensor."""
    if fv.device.type == "cpu":
        return context_tail_reference(fv, avew, uh, wmat)
    if fv.device.type == "cuda":
        return ContextTail.apply(fv, avew, uh, wmat)
    raise ValueError(f"context_fused runs on cpu or cuda, got {fv.device}")


def pack_inputs(fv, aves, weights, hw, row0=None):
    """Seam arguments -> the kernel's (avew, uh, wmat).

    ``hw`` is the whole feature map's (H, W).  Unsharded (``row0`` None)
    it must be fv's own.  An H-shard passes ``row0``, its first row of
    the whole map: uh is built for the whole height and its rows
    ``[row0, row0 + H_local)`` go to the kernel, which reads uh per
    local row (the rows an H-shard's pixels interpolate from; the pooled
    aves are the whole map's).  W is never sharded."""
    h_l, w_l = fv.shape[1], fv.shape[2]
    if row0 is None:
        if tuple(hw) != (h_l, w_l):
            raise ValueError("the fused context tail is single-device only: "
                             f"hw {tuple(hw)} != fv's {tuple(fv.shape[1:3])}")
    elif hw[1] != w_l or not 0 <= row0 <= hw[0] - h_l:
        raise ValueError(f"an H-shard of fv {tuple(fv.shape[1:3])} at row "
                         f"{row0} does not lie in the map {tuple(hw)}")
    avew, uh = precompute(aves, hw)
    if row0 is not None:
        uh = uh[row0:row0 + h_l].contiguous()
    wmat = torch.stack([wm.to(fv.dtype) for wm in weights])
    return avew, uh, wmat


def make_fused_context():
    """The ``context_fused`` seam of ``models.cannet``: a callable
    ``(fv, aves, weights, hw, row0=None) -> fi`` with fv (B, H, W, C),
    aves the per-scale pooled projections (B, S, S, C), weights the
    per-scale (Cin, Cout) gate matrices in fv's dtype; ``hw`` and
    ``row0`` as ``pack_inputs`` takes them."""

    def fused(fv, aves, weights, hw, row0=None):
        return context_tail(fv, *pack_inputs(fv, aves, weights, hw, row0))

    return fused


def reference_context(fv, aves, weights, hw, row0=None) -> torch.Tensor:
    """The seam with the plain version on every device — the yardstick
    the kernel is held against on the card."""
    return context_tail_reference(fv, *pack_inputs(fv, aves, weights, hw, row0))
