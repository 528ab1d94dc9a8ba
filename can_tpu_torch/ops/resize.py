"""Bilinear resize with ``align_corners=True`` semantics (counterpart of
``can_tpu/ops/resize.py:26, 65``).

Align-corners bilinear interpolation is a separable linear map with
static coefficients, so it is written as a contraction against two tiny
``(out, in)`` f32 matrices.  The same matrices feed the fused context
kernel (``cuda_context.precompute``), which is why they are kept rather
than calling ``F.interpolate``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _upsample_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if out_size == 1:
        # align_corners with a single output sample reads source index 0.
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    for i in range(out_size):
        pos = i * scale
        lo = int(np.floor(pos))
        lo = min(lo, in_size - 2)
        frac = pos - lo
        m[i, lo] += 1.0 - frac
        m[i, lo + 1] += frac
    return m


@functools.lru_cache(maxsize=512)
def _upsample_matrix_on(in_size: int, out_size: int,
                        device: str) -> torch.Tensor:
    # one host->device copy per (in, out, device) for the life of the
    # process: a pageable copy inside the forward would stall the host
    # until the device caught up
    return torch.from_numpy(_upsample_matrix_np(in_size, out_size)).to(device)


def upsample_matrix(in_size: int, out_size: int,
                    device="cpu") -> torch.Tensor:
    """(out_size, in_size) f32 align-corners interpolation matrix on
    ``device`` (cached; treat as read-only)."""
    return _upsample_matrix_on(in_size, out_size, str(torch.device(device)))


def separable_hw_contract(x: torch.Tensor, mh: torch.Tensor,
                          mw: torch.Tensor) -> torch.Tensor:
    """einsum('nhwc,ph,qw->npqc') in f32 (f32 coefficients, f32
    accumulation even under bf16 compute), cast back to ``x.dtype``."""
    out = torch.einsum("nhwc,ph,qw->npqc", x.float(), mh, mw)
    return out.to(x.dtype)


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear align_corners=True resize of NHWC ``x`` to ``size=(H, W)``."""
    oh, ow = size
    h, w = x.shape[-3], x.shape[-2]
    return separable_hw_contract(x, upsample_matrix(h, oh, x.device),
                                 upsample_matrix(w, ow, x.device))
