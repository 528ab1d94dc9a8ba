"""Masked BatchNorm moment sums: CUDA kernel, plain version, autograd.

Replaces the Pallas TPU kernel ``can_tpu/ops/pallas_bn.py::_kernel``
(``pl.pallas_call`` in ``_sums_forward``, entry ``moment_sums``).  For a
train-mode BN layer's activation y (B, h, w, C) and validity mask m
(B, h, w, 1)::

    s1 = sum(y * m)      s2 = sum(y^2 * m)      s0 = sum(m)

per channel, all in f32, from one read of y — the local half of the
one-pass moments contract (``ops/bn_moments.py`` packs and closes them).

What bounds it on an H100: bytes.  Three operations per element of y
against 4 (f32) or 2 (bf16) bytes read, so the least time is one read of
y and m at 3.35 TB/s: ~0.27 ms for the largest training layer,
(8, 576, 768, 64) f32.  The kernel (``csrc/bn_moments.cu``) reads y once
with 16-byte loads along the contiguous channels, keeps the sums in
registers, and reduces across blocks in a second, fixed-order stage — no
float atomics, so the sums are bitwise the same on every run.  bf16 y is
read as bf16 and widened exactly, so the model hands the kernel its
activations as they are (half the bytes of an f32 copy).

On a CPU tensor ``moment_sums`` runs the plain version; on a CUDA tensor
it launches the kernel or raises — no fallback.  Gradients: the kernel is
wrapped in a ``torch.autograd.Function`` whose backward re-differentiates
the plain version (the JAX custom VJP's recompute, pallas_bn.py:143-149):
dy = g1 * m + 2 * g2 * y * m, cast to y's dtype; m gets none.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from can_tpu_torch.ops._build import load_kernel_library

KERNEL = "bn_moments"

# Kernel launches since the last reset_launches(): proof that a run went
# through the kernel (the plain version and CPU tensors never count).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def masked_moment_sums(yf: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel (``masked_moment_sums`` of
    can_tpu/ops/bn_moments.py): per-channel ``(sum(y*m), sum(y^2*m))``
    and the valid-pixel count, in yf's dtype (the caller upcasts)."""
    s1 = torch.sum(yf * m, dim=(0, 1, 2))
    s2 = torch.sum(torch.square(yf) * m, dim=(0, 1, 2))
    s0 = torch.sum(m)
    return s1, s2, s0


def load_library() -> ctypes.CDLL:
    lib = load_kernel_library(KERNEL)
    if lib.bn_moments_forward.argtypes is None:
        # every pointer and the stream as c_void_p: a default ctypes int
        # would cut a 64-bit address to 32 bits
        lib.bn_moments_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p])
        lib.bn_moments_forward.restype = ctypes.c_int
        lib.bn_moments_scratch_floats.argtypes = [ctypes.c_longlong,
                                                  ctypes.c_int, ctypes.c_int]
        lib.bn_moments_scratch_floats.restype = ctypes.c_longlong
        lib.bn_moments_vector_width.argtypes = [ctypes.c_int]
        lib.bn_moments_vector_width.restype = ctypes.c_int
    return lib


def moment_sums_cuda(y: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch ``csrc/bn_moments.cu`` on the current stream: y (B, h, w, C)
    f32 or bf16, m (B, h, w, 1) f32 -> (s1 (C,), s2 (C,), s0 ()) f32.
    Raises on anything the kernel does not take."""
    global LAUNCHES
    if not y.is_cuda:
        raise ValueError(f"moment_sums_cuda runs on CUDA tensors, got y on "
                         f"{y.device} (moment_sums dispatches by device)")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_moments takes f32 or bf16 y, got {y.dtype}")
    if y.dim() != 4:
        raise ValueError(f"y must be (B, h, w, C), got {tuple(y.shape)}")
    b, h, w, c = y.shape
    if tuple(m.shape) != (b, h, w, 1) or m.dtype != torch.float32:
        raise ValueError(f"m: want {(b, h, w, 1)} float32, got "
                         f"{tuple(m.shape)} {m.dtype}")
    if m.device != y.device:
        raise ValueError(f"m is on {m.device}, y on {y.device}")
    lib = load_library()
    is_bf16 = int(y.dtype == torch.bfloat16)
    vec = lib.bn_moments_vector_width(is_bf16)
    if c % vec:
        raise ValueError(f"bn_moments reads {vec} channels per load in "
                         f"{y.dtype}: needs C % {vec} == 0, got C={c}")
    y = y.contiguous()
    if y.data_ptr() % 16:
        y = y.clone()  # a view at an odd offset: 16-byte loads need alignment
    m = m.contiguous()
    n_pix = b * h * w
    out = torch.empty(2 * c + 1, device=y.device, dtype=torch.float32)
    if n_pix == 0:
        out.zero_()
        return out[:c], out[c:2 * c], out[2 * c]
    scratch = torch.empty(lib.bn_moments_scratch_floats(n_pix, c, is_bf16),
                          device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.bn_moments_forward(y.data_ptr(), m.data_ptr(),
                                    scratch.data_ptr(), out.data_ptr(),
                                    n_pix, c, is_bf16, stream)
    if rc != 0:
        raise RuntimeError(f"bn_moments kernel launch failed: CUDA error {rc} "
                           f"for y {tuple(y.shape)} {y.dtype}")
    LAUNCHES += 1
    return out[:c], out[c:2 * c], out[2 * c]


class MomentSums(torch.autograd.Function):
    """The kernel with the JAX custom VJP's backward: re-differentiate
    the plain version on the saved inputs."""

    @staticmethod
    def forward(ctx, y, m):
        ctx.save_for_backward(y, m)
        s1, s2, s0 = moment_sums_cuda(y, m)
        ctx.mark_non_differentiable(s0)
        return s1, s2, s0

    @staticmethod
    def backward(ctx, g1, g2, g0):
        y, m = ctx.saved_tensors
        with torch.enable_grad():
            yd = y.detach().requires_grad_()
            # y.float() is the JAX astype: its VJP casts dy back to y's dtype
            s1, s2, _ = masked_moment_sums(yd.float(), m)
            (dy,) = torch.autograd.grad((s1, s2), (yd,), (g1, g2))
        return dy, None


def moment_sums(y: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Device dispatch: ``(y (B, h, w, C), m (B, h, w, 1)) -> (s1 (C,),
    s2 (C,), s0 ())`` with an f32 floor on the sums (f64 y keeps f64 on
    the CPU).  A CPU tensor takes the plain version, a CUDA tensor the
    kernel through ``MomentSums``."""
    if y.device.type == "cpu":
        acc = torch.float64 if y.dtype == torch.float64 else torch.float32
        return masked_moment_sums(y.to(acc), m.to(acc))
    if y.device.type == "cuda":
        return MomentSums.apply(y, m)
    raise ValueError(f"bn_moments runs on cpu or cuda, got {y.device}")
