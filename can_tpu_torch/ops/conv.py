"""Convolutions over NHWC activations (counterpart of
``can_tpu/ops/conv.py:16, 113``).

A contiguous NHWC tensor permuted to NCHW is ``torch.channels_last``
storage, so cuDNN runs its NHWC kernels with no copy and hands back a
channels_last result, which permutes back to contiguous NHWC for free.
Conv weights stay in the ``nn.Conv2d`` layout (OIHW) the reference state
dict carries; the context 1x1s are ``(Cin, Cout)`` matrices as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

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
