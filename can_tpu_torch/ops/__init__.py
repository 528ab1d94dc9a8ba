"""Spatial ops of the CANNet forward pass over NHWC tensors.

Convolutions, pooling and the align-corners resize map onto ATen/cuDNN
(the JAX package leaves the same ops to XLA); the fused context tail is
the one hand-written CUDA kernel (``cuda_context``)."""

from can_tpu_torch.ops.conv import conv1x1, conv2d
from can_tpu_torch.ops.pooling import adaptive_avg_pool2d, max_pool2d
from can_tpu_torch.ops.resize import resize_bilinear_align_corners, upsample_matrix

__all__ = ["conv1x1", "conv2d", "adaptive_avg_pool2d", "max_pool2d",
           "resize_bilinear_align_corners", "upsample_matrix"]
