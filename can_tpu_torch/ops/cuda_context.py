"""The fused CANNet context tail: CUDA kernel, plain version, seam.

Replaces the Pallas TPU kernel ``can_tpu/ops/pallas_context.py::_kernel``
(``pl.pallas_call`` in ``_fused_forward``, entry ``make_fused_context``).
For each scale k in (1, 2, 3, 6)::

    sm_k   = upsample(ave_k)                       (row interp of avew_k)
    gate_k = sigmoid((sm_k - fv) @ W_k)            (input dtype, f32 sums)
    num   += gate_k * sm_k ;  den += gate_k
    fi     = num / (den + 1e-12)

What bounds it on an H100: the four (pixels x 512) @ (512 x 512) products
— 2*4*512*512 FLOP per feature pixel, ~206 GFLOP for an 8 x 96 x 128
feature map against ~400 MB of compulsory f32 traffic (fv read once, fi
written once), about 500 FLOP per byte: operations bound it.  The kernel
(``csrc/context_fused.cu``) keeps each 64-pixel x 64-channel tile's
logits, num and den in registers across all four scales and rebuilds the
contrast chunks in shared memory, so none of the per-scale (B, H, W, 512)
intermediates the plain version materialises ever touches device memory;
its products are f32 FMAs on CUDA cores (tensor cores are later work).

On a CPU tensor the seam runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises — no fallback.  Forward only: the
training slice backs the kernel with a ``torch.autograd.Function`` whose
backward re-differentiates the plain version (the JAX custom VJP's
recompute-in-backward).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from can_tpu_torch.ops._build import load_kernel_library
from can_tpu_torch.ops.resize import upsample_matrix

SCALES = (1, 2, 3, 6)
ROW_OFFSETS = (0, 1, 3, 6)  # each scale's first row in the packed buffers
N_ROWS = sum(SCALES)
EPS = 1e-12
KERNEL = "context_fused"

# Kernel launches since the last reset_launches(): proof that a run went
# through the kernel (the plain version and CPU tensors never count).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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


def load_library() -> ctypes.CDLL:
    lib = load_kernel_library(KERNEL)
    if lib.context_fused_forward.argtypes is None:
        # every pointer and the stream as c_void_p: a default ctypes int
        # would cut a 64-bit address to 32 bits
        lib.context_fused_forward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.context_fused_forward.restype = ctypes.c_int
        lib.context_fused_channel_tile.argtypes = []
        lib.context_fused_channel_tile.restype = ctypes.c_int
    return lib


def context_tail_cuda(fv: torch.Tensor, avew: torch.Tensor, uh: torch.Tensor,
                      wmat: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/context_fused.cu`` on the current stream; same
    arguments and result as ``context_tail_reference``.  Raises on
    anything the kernel does not take."""
    global LAUNCHES
    if not fv.is_cuda:
        raise ValueError(f"context_tail_cuda runs on CUDA tensors, got fv on "
                         f"{fv.device} (context_tail dispatches by device)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (fv, avew, uh, wmat)):
        raise RuntimeError(
            "the context_fused CUDA kernel is forward-only; gradients come "
            "with the training slice (an autograd.Function over the plain "
            "version) — run under torch.no_grad()/inference_mode()")
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
    with torch.cuda.device(fv.device):
        stream = torch.cuda.current_stream(fv.device).cuda_stream
        rc = lib.context_fused_forward(
            fv.data_ptr(), avew.data_ptr(), uh.data_ptr(), wmat.data_ptr(),
            out.data_ptr(), b * h * w, h, w, c,
            int(fv.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"context_fused kernel launch failed: CUDA error "
                           f"{rc} for fv {tuple(fv.shape)} {fv.dtype}")
    LAUNCHES += 1
    return out


def context_tail(fv, avew, uh, wmat) -> torch.Tensor:
    """Device dispatch: the plain version for a CPU tensor, the kernel for
    a CUDA tensor."""
    if fv.device.type == "cpu":
        return context_tail_reference(fv, avew, uh, wmat)
    if fv.device.type == "cuda":
        return context_tail_cuda(fv, avew, uh, wmat)
    raise ValueError(f"context_fused runs on cpu or cuda, got {fv.device}")


def pack_inputs(fv, aves, weights, hw):
    """Seam arguments -> the kernel's (avew, uh, wmat)."""
    if tuple(hw) != (fv.shape[1], fv.shape[2]):
        raise ValueError("the fused context tail is single-device only: "
                         f"hw {tuple(hw)} != fv's {tuple(fv.shape[1:3])}")
    avew, uh = precompute(aves, hw)
    wmat = torch.stack([wm.to(fv.dtype) for wm in weights])
    return avew, uh, wmat


def make_fused_context():
    """The ``context_fused`` seam of ``models.cannet``: a callable
    ``(fv, aves, weights, hw) -> fi`` with fv (B, H, W, C), aves the
    per-scale pooled projections (B, S, S, C), weights the per-scale
    (Cin, Cout) gate matrices in fv's dtype."""

    def fused(fv, aves, weights, hw):
        return context_tail(fv, *pack_inputs(fv, aves, weights, hw))

    return fused


def reference_context(fv, aves, weights, hw) -> torch.Tensor:
    """The seam with the plain version on every device — the yardstick
    the kernel is held against on the card."""
    return context_tail_reference(fv, *pack_inputs(fv, aves, weights, hw))
