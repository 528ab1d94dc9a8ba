"""Pooling over NHWC tensors with PyTorch semantics (counterpart of
``can_tpu/ops/pooling.py:25-72, 74``).

Adaptive average pooling is a linear map along each spatial axis once
the sizes are known, so, as in the JAX package, it is a contraction
against two small ``(out, in)`` f32 averaging matrices with PyTorch's
bins (``start = floor(i*in/out)``, ``end = ceil((i+1)*in/out)``).  Its
backward is the same two products transposed, which is deterministic;
ATen's CUDA backward is not, and deterministic mode refuses it
(``device.use_deterministic``).  bf16 input is pooled in f32 and rounded
once, the JAX package's f32-accumulation contract.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from can_tpu_torch.ops.resize import separable_hw_contract


@functools.lru_cache(maxsize=None)
def _adaptive_pool_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil((i+1)*in/out)
        m[i, start:end] = 1.0 / (end - start)
    return m


@functools.lru_cache(maxsize=512)
def _adaptive_pool_matrix_on(in_size: int, out_size: int,
                             device: str) -> torch.Tensor:
    # one host->device copy per (in, out, device); made outside inference
    # mode, as ops/resize.py's matrices: an inference tensor in the cache
    # would break every later training forward at the shape
    with torch.inference_mode(False):
        return torch.from_numpy(
            _adaptive_pool_matrix_np(in_size, out_size)).to(device)


def adaptive_pool_matrix(in_size: int, out_size: int,
                         device="cpu") -> torch.Tensor:
    """(out_size, in_size) row-stochastic f32 averaging matrix on
    ``device`` (cached; treat as read-only)."""
    return _adaptive_pool_matrix_on(in_size, out_size, str(torch.device(device)))


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """PyTorch adaptive average pool: (N, H, W, C) -> (N, Sh, Sw, C);
    ``output_size`` is an int or (Sh, Sw)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    sh, sw = output_size
    h, w = x.shape[-3], x.shape[-2]
    return separable_hw_contract(x, adaptive_pool_matrix(h, sh, x.device),
                                 adaptive_pool_matrix(w, sw, x.device))


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pool over NHWC, VALID padding (odd sizes floor, as
    ``nn.MaxPool2d(kernel_size=2, stride=2)``)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)
