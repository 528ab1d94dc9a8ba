"""Pooling over NHWC tensors with PyTorch semantics (counterpart of
``can_tpu/ops/pooling.py:58, 74``).

The JAX package writes adaptive pooling as a contraction against
averaging matrices that replicate PyTorch's bins (``start = floor(i*in/out)``,
``end = ceil((i+1)*in/out)``); here the bins are ATen's own.  ATen
accumulates bf16 pooling in f32 and rounds once at the end, which is the
JAX package's f32-accumulation contract.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """PyTorch adaptive average pool: (N, H, W, C) -> (N, Sh, Sw, C);
    ``output_size`` is an int or (Sh, Sw)."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), output_size)
    return y.permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pool over NHWC, VALID padding (odd sizes floor, as
    ``nn.MaxPool2d(kernel_size=2, stride=2)``)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)
