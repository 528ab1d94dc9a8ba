"""Convolutions over NHWC activations (counterpart of
``can_tpu/ops/conv.py:16, 51-110, 113``).

A contiguous NHWC tensor permuted to NCHW is ``torch.channels_last``
storage, so cuDNN runs its NHWC kernels with no copy and hands back a
channels_last result, which permutes back to contiguous NHWC for free.
Conv weights stay in the ``nn.Conv2d`` layout (OIHW) the reference state
dict carries; the context 1x1s are ``(Cin, Cout)`` matrices as in the
JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, dilation: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """Stride-1 conv, SAME-style padding ``dilation * (k // 2)`` by default.

    x: (N, H, W, Cin); w: (Cout, Cin, kh, kw); b: (Cout,) or None.
    ``padding=dilation`` with kernel 3 keeps the spatial size, matching
    the reference's ``nn.Conv2d(k=3, padding=d, dilation=d)``.  bf16
    inputs accumulate in f32 inside cuDNN (and oneDNN on the CPU); the sum
    is rounded to x's dtype and the bias added after, in that dtype — the
    JAX package's two roundings (``out + b`` on the conv result), which
    oneDNN's fused bias would otherwise merge into one.
    """
    if padding is None:
        pad = (dilation * (w.shape[2] // 2), dilation * (w.shape[3] // 2))
    else:
        pad = (padding, padding)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad, dilation=dilation)
    if b is not None:
        y = y.add_(b.view(1, -1, 1, 1))
    return y.permute(0, 2, 3, 1)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, b*b*C); packed channel index is
    (di*b + dj)*C + c for sub-pixel (di, dj)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // block, w // block, block * block * c)


def depth_to_space(y: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Inverse of ``space_to_depth`` (same channel packing)."""
    n, h, w, pc = y.shape
    c = pc // (block * block)
    y = y.reshape(n, h, w, block, block, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h * block, w * block, c)


@functools.lru_cache(maxsize=None)
def _fold_index(c: int, o: int) -> Tuple[np.ndarray, np.ndarray]:
    """Where each tap of a 3x3 stride-1 kernel lands in the folded block-2
    kernel: ``(src, dst)`` flat indices into (o, c, 3, 3) and (4o, 4c, 3,
    3).  Output sub-pixel (do, dp) reads input pixel offset (u, v), which
    lies in packed cell (fa, fb) at sub-pixel (ra, rb); no two taps share
    a destination, so the fold places values and sums nothing."""
    src, dst = [], []
    oi, ci = np.meshgrid(np.arange(o), np.arange(c), indexing="ij")
    for do in (0, 1):
        for dp in (0, 1):
            for u in (-1, 0, 1):
                fa, ra = (do + u) // 2, (do + u) % 2
                for v in (-1, 0, 1):
                    fb, rb = (dp + v) // 2, (dp + v) % 2
                    out = (2 * do + dp) * o + oi
                    inp = (ra * 2 + rb) * c + ci
                    src.append(((oi * c + ci) * 3 + u + 1) * 3 + v + 1)
                    dst.append(((out * 4 * c + inp) * 3 + fa + 1) * 3 + fb + 1)
    return (np.concatenate([s.ravel() for s in src]),
            np.concatenate([d.ravel() for d in dst]))


def fold_stem_kernel(w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                     block: int = 2):
    """Fold a 3x3 stride-1 SAME conv into space-to-depth space:
    ``conv2d(x, w, b) == depth_to_space(conv2d(space_to_depth(x), w', b'))``
    up to summation order (both sides zero-pad, and the packed canvas's
    zeros land where SAME padding's would).  The folded conv contracts
    K = 12 * 9 at a quarter of the positions instead of K = 27 (4x the
    nominal operations; the JAX package measured it slower on its chip
    and keeps it off by default, as the port does).

    The fold is linear in w and built by index-adds into a zeros tensor,
    so autograd trains the original stem weights.
    w: (O, C, 3, 3) -> (4O, 4C, 3, 3); b: (O,) -> (4O,).
    """
    if block != 2 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"the fold is derived for a 3x3 kernel and block 2, "
                         f"got kernel {tuple(w.shape[2:])} and block {block}")
    o, c = w.shape[0], w.shape[1]
    src, dst = (torch.from_numpy(a).to(w.device) for a in _fold_index(c, o))
    wp = torch.zeros(16 * o * c * 9, dtype=w.dtype, device=w.device)
    wp = wp.index_add(0, dst, w.reshape(-1)[src]).reshape(4 * o, 4 * c, 3, 3)
    bp = None if b is None else b.repeat(4)
    return wp, bp


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv == channel matmul; w: (Cin, Cout).  bf16 inputs are
    multiplied in f32 (bf16 products are exact in f32) and the f32 sum is
    rounded once, the JAX package's ``preferred_element_type=f32``."""
    out = torch.matmul(x.float(), w.float()) if x.dtype == torch.bfloat16 \
        else torch.matmul(x, w)
    if b is not None:
        out = out + b.to(out.dtype)
    return out.to(x.dtype)
