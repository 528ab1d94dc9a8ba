"""Masked BatchNorm moment sums: CUDA kernels, plain versions, autograd.

Replaces the Pallas TPU kernel ``can_tpu/ops/pallas_bn.py::_kernel``
(``pl.pallas_call`` in ``_sums_forward``, entry ``moment_sums``) and its
custom VJP ``_sums_bwd`` (pallas_bn.py:143).  For a train-mode BN layer's
activation y (B, h, w, C) and validity mask m (B, h, w, 1)::

    s1 = sum(y * m)      s2 = sum(y^2 * m)      s0 = sum(m)

per channel, all in f32, from one read of y — the local half of the
one-pass moments contract (``ops/bn_moments.py`` packs and closes them) —
and, backward, ``dy = m (g1 + 2 g2 y)`` from one read of y and m.

What bounds both on an H100: bytes (three operations per element of y
against 4 (f32) or 2 (bf16) bytes).  The forward is one launch
(``csrc/bn_moments.cu``): each block streams a contiguous pixel range
through a shared-memory ring of bulk asynchronous copies, clusters of
blocks combine through distributed shared memory, and the last cluster to
finish sums the clusters' partials in a fixed order — no float atomics, so
the sums are bitwise the same on every run.  The backward is one
elementwise launch.  bf16 y is read as bf16 and widened exactly, so the
model hands the kernels its activations as they are.

On a CPU tensor ``moment_sums`` runs the plain version and ``MomentSums``
differentiates it; on a CUDA tensor the forward and the backward launch
their kernels or raise — no fallback.  m gets no gradient.

The forward's scratch holds the kernel's cross-block ticket, which must be
0 at launch and private to one stream: the wrapper keeps one zeroed
scratch per (device, stream), and each launch leaves the ticket at 0.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from can_tpu_torch.ops._build import load_kernel_library

KERNEL = "bn_moments"
BACKWARD_KERNEL = "bn_moments_backward"

# Kernel launches since the last reset_launches(): proof that a run went
# through the kernels (the plain versions and CPU tensors never count).
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

# (n_pix, C, is_bf16) -> scratch bytes of the forward's plan
_scratch_bytes: Dict[Tuple[int, int, int], int] = {}
# (device index, stream handle) -> zeroed scratch (the ticket stays 0
# between launches on that stream)
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}
_vector_width: Dict[int, int] = {}
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global LAUNCHES, BACKWARD_LAUNCHES
    LAUNCHES = 0
    BACKWARD_LAUNCHES = 0


def masked_moment_sums(yf: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel (``masked_moment_sums``
    of can_tpu/ops/bn_moments.py): per-channel ``(sum(y*m), sum(y^2*m))``
    and the valid-pixel count, in yf's dtype (the caller upcasts)."""
    s1 = torch.sum(yf * m, dim=(0, 1, 2))
    s2 = torch.sum(torch.square(yf) * m, dim=(0, 1, 2))
    s0 = torch.sum(m)
    return s1, s2, s0


def masked_moment_sums_backward(y: torch.Tensor, m: torch.Tensor, g1: torch.Tensor,
                                g2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: ``dy = m (g1 + 2 g2
    y)`` in f32 (f64 kept), rounded once to y's dtype — the gradient of
    ``g1 . s1 + g2 . s2`` with respect to y."""
    yf = y if y.dtype == torch.float64 else y.float()
    return (m * (g1 + (2 * g2) * yf)).to(y.dtype)


def moment_sums_vjp_plain(y: torch.Tensor, m: torch.Tensor, g1: torch.Tensor,
                          g2: torch.Tensor) -> torch.Tensor:
    """dy by re-differentiating the plain forward (the JAX custom VJP's
    recompute, pallas_bn.py:143-149): ``MomentSums``' backward on a CPU
    tensor.  y.float() is the JAX astype, whose VJP casts dy back."""
    with torch.enable_grad():
        yd = y.detach().requires_grad_()
        s1, s2, _ = masked_moment_sums(yd.float(), m)
        (dy,) = torch.autograd.grad((s1, s2), (yd,), (g1, g2))
    return dy


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_kernel_library(KERNEL)
    if lib.bn_moments_forward.argtypes is None:
        # every pointer and the stream as c_void_p: a default ctypes int
        # would cut a 64-bit address to 32 bits
        lib.bn_moments_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.bn_moments_forward.restype = ctypes.c_int
        lib.bn_moments_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.bn_moments_backward.restype = ctypes.c_int
        lib.bn_moments_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                                 ctypes.c_int]
        lib.bn_moments_scratch_bytes.restype = ctypes.c_longlong
        lib.bn_moments_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_longlong)]
        lib.bn_moments_plan.restype = None
        lib.bn_moments_vector_width.argtypes = [ctypes.c_int]
        lib.bn_moments_vector_width.restype = ctypes.c_int
    _LIB = lib
    return lib


def forward_plan(n_pix: int, c: int, dtype: torch.dtype) -> dict:
    """The forward's launch plan for a shape (grid, cluster, chunk, ring
    stage, shared bytes): what the kernel does, for tests and reports."""
    keys = ("blocks", "groups", "cluster", "chunk", "stage_pix", "smem")
    out = (ctypes.c_longlong * len(keys))()
    load_library().bn_moments_plan(n_pix, c, int(dtype == torch.bfloat16), out)
    return dict(zip(keys, out))


def _checked(y: torch.Tensor, m: torch.Tensor, what: str):
    """Shapes, dtypes and devices the kernels take; returns (y, m, n_pix,
    C, is_bf16, library) with y and m contiguous and 16-byte aligned."""
    if not y.is_cuda:
        raise ValueError(f"{what} runs on CUDA tensors, got y on {y.device} "
                         f"(moment_sums dispatches by device)")
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
    vec = _vector_width.get(is_bf16)
    if vec is None:
        vec = _vector_width[is_bf16] = lib.bn_moments_vector_width(is_bf16)
    if c % vec:
        raise ValueError(f"bn_moments reads {vec} channels per load in "
                         f"{y.dtype}: needs C % {vec} == 0, got C={c}")
    # a view at an odd offset is copied: 16-byte loads need alignment
    y = y.contiguous()
    if y.data_ptr() % 16:
        y = y.clone()
    m = m.contiguous()
    if m.data_ptr() % 16:
        m = m.clone()
    return y, m, b * h * w, c, is_bf16, lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scratch_for(device: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """The stream's zeroed scratch, grown to ``nbytes`` when too small."""
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _scratch[key] = torch.zeros(max(nbytes, 1 << 16), device=device,
                                          dtype=torch.uint8)
    return buf


def moment_sums_cuda(y: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch the forward kernel of ``csrc/bn_moments.cu`` on the current
    stream (one device launch): y (B, h, w, C) f32 or bf16, m (B, h, w,
    1) f32 -> (s1 (C,), s2 (C,), s0 ()) f32.  Raises on anything the
    kernel does not take."""
    global LAUNCHES
    y, m, n_pix, c, is_bf16, lib = _checked(y, m, "moment_sums_cuda")
    out = torch.empty(2 * c + 1, device=y.device, dtype=torch.float32)
    if n_pix == 0:
        out.zero_()
        return out[:c], out[c:2 * c], out[2 * c]
    key = (n_pix, c, is_bf16)
    nbytes = _scratch_bytes.get(key)
    if nbytes is None:
        nbytes = _scratch_bytes[key] = lib.bn_moments_scratch_bytes(n_pix, c, is_bf16)
    dev = y.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return moment_sums_cuda(y, m)
    handle = _stream(dev)
    scratch = _scratch_for(dev, handle, nbytes)
    rc = lib.bn_moments_forward(y.data_ptr(), m.data_ptr(), scratch.data_ptr(),
                                out.data_ptr(), n_pix, c, is_bf16, handle)
    if rc != 0:
        raise RuntimeError(f"bn_moments kernel launch failed: CUDA error {rc} "
                           f"for y {tuple(y.shape)} {y.dtype}")
    LAUNCHES += 1
    return out[:c], out[c:2 * c], out[2 * c]


def moment_sums_backward_cuda(y: torch.Tensor, m: torch.Tensor, g1: torch.Tensor,
                              g2: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel of ``csrc/bn_moments.cu`` on the current
    stream: ``dy = m (g1 + 2 g2 y)`` in y's dtype and shape, from y (B, h,
    w, C) f32 or bf16, m (B, h, w, 1) f32 and g1, g2 (C,).  Raises on
    anything the kernel does not take."""
    global BACKWARD_LAUNCHES
    y, m, n_pix, c, is_bf16, lib = _checked(y, m, "moment_sums_backward_cuda")
    for name, g in (("g1", g1), ("g2", g2)):
        if tuple(g.shape) != (c,) or g.device != y.device:
            raise ValueError(f"{name}: want ({c},) on {y.device}, got "
                             f"{tuple(g.shape)} on {g.device}")
    g1, g2 = (g.float().contiguous() for g in (g1, g2))
    dy = torch.empty_like(y)
    if n_pix == 0:
        return dy
    dev = y.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return moment_sums_backward_cuda(y, m, g1, g2)
    rc = lib.bn_moments_backward(y.data_ptr(), m.data_ptr(), g1.data_ptr(),
                                 g2.data_ptr(), dy.data_ptr(), n_pix, c, is_bf16,
                                 _stream(dev))
    if rc != 0:
        raise RuntimeError(f"bn_moments_backward kernel launch failed: CUDA "
                           f"error {rc} for y {tuple(y.shape)} {y.dtype}")
    BACKWARD_LAUNCHES += 1
    return dy


class MomentSums(torch.autograd.Function):
    """The forward kernel with the JAX custom VJP's gradient: the backward
    kernel on a CUDA tensor, the plain re-differentiation on a CPU one."""

    @staticmethod
    def forward(ctx, y, m):
        ctx.save_for_backward(y, m)
        s1, s2, s0 = moment_sums_cuda(y, m)
        ctx.mark_non_differentiable(s0)
        return s1, s2, s0

    @staticmethod
    def backward(ctx, g1, g2, g0):
        y, m = ctx.saved_tensors
        if y.is_cuda:
            return moment_sums_backward_cuda(y, m, g1, g2), None
        return moment_sums_vjp_plain(y, m, g1, g2), None


def moment_sums(y: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Device dispatch: ``(y (B, h, w, C), m (B, h, w, 1)) -> (s1 (C,),
    s2 (C,), s0 ())`` with an f32 floor on the sums (f64 y keeps f64 on
    the CPU).  A CPU tensor takes the plain version, a CUDA tensor the
    kernels through ``MomentSums``."""
    if y.device.type == "cpu":
        acc = torch.float64 if y.dtype == torch.float64 else torch.float32
        return masked_moment_sums(y.to(acc), m.to(acc))
    if y.device.type == "cuda":
        return MomentSums.apply(y, m)
    raise ValueError(f"bn_moments runs on cpu or cuda, got {y.device}")
