"""Serve-time parameter storage (counterpart of
``can_tpu/serve/quant.py:94-150``, f32 and bf16 modes).

* ``f32``  — identity; the parity mode.
* ``bf16`` — every float tensor stored bf16 and the forward computed in
  bf16 (f32 accumulation inside cuDNN/cuBLAS and the context kernel).
* ``int8`` — weight-only PTQ (and with it ``dequantize_tree``, the
  in-program dequantisation) comes with a later slice; asking for it
  raises ``NotImplementedError`` naming that slice.

Trees here are flat reference-layout state dicts (name -> tensor).
"""

from __future__ import annotations

from typing import Dict

import torch

SERVE_DTYPES = ("f32", "bf16", "int8")
RUNNING_STATS = ("running_mean", "running_var")
PORTED_SERVE_DTYPES = ("f32", "bf16")
INT8_MESSAGE = ("--serve-dtype int8 (weight-only PTQ with in-program "
                "dequantisation) is not ported yet: it comes with the serve "
                "scheduler/fleet/int8/AOT slice of can_tpu_torch")


def _check(serve_dtype: str) -> None:
    if serve_dtype not in SERVE_DTYPES:
        raise ValueError(f"serve_dtype must be one of {SERVE_DTYPES}, "
                         f"got {serve_dtype!r}")
    if serve_dtype not in PORTED_SERVE_DTYPES:
        raise NotImplementedError(INT8_MESSAGE)


def quantize_tree(state_dict: Dict[str, torch.Tensor],
                  serve_dtype: str) -> Dict[str, torch.Tensor]:
    """f32 state dict -> the storage dict for ``serve_dtype``.  BN running
    statistics stay f32 (the JAX package's ``batch_stats`` are not
    quantised either)."""
    _check(serve_dtype)
    if serve_dtype == "f32":
        return dict(state_dict)
    return {k: v.to(torch.bfloat16)
            if v.is_floating_point() and not k.endswith(RUNNING_STATS) else v
            for k, v in state_dict.items()}


def compute_dtype_for(serve_dtype: str):
    """The forward's compute dtype: bf16 for bf16, None (keep f32) else."""
    _check(serve_dtype)
    return torch.bfloat16 if serve_dtype == "bf16" else None


def storage_dtype_for(serve_dtype: str) -> torch.dtype:
    """The dtype the parameters are stored in on the device."""
    _check(serve_dtype)
    return torch.bfloat16 if serve_dtype == "bf16" else torch.float32
