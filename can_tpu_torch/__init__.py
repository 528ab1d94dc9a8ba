"""can_tpu_torch — CANNet crowd counting in PyTorch, with CUDA kernels for Hopper.

The PyTorch counterpart of ``can_tpu`` (the JAX package beside it, which
stays the reference).  Module paths and function names follow
``can_tpu`` so each piece has an obvious counterpart; inside, the code is
plain PyTorch:

* public functions take the JAX layouts — NHWC images and activations,
  ``(Cin, Cout)`` matrices for the context 1x1s, ``(N, H/8, W/8, 1)``
  density maps — and convolutions run NCHW in ``torch.channels_last``
  (the same storage, so the permute is free);
* every entry point takes an explicit device and runs on the card
  (``cuda:LOCAL_RANK``) unless the caller asks for the CPU
  (``device.resolve_device``);
* the TPU kernels — the fused context tail and the BN moment sums with
  their backward — are hand-written CUDA kernels (``csrc/``, wrappers
  ``ops/cuda_context.py`` and ``ops/cuda_bn.py``), each with its plain
  PyTorch version beside it;
* training and evaluation run data-parallel across processes, one per
  GPU, over ``torch.distributed`` (``parallel/``: DDP, SyncBN).

This package imports torch, numpy and the standard library only — never
``jax`` and nothing from ``can_tpu``.
"""

from can_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
