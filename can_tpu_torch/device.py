"""Device selection: the card by default, the CPU only when asked.

Counterpart of the JAX CLIs' ``apply_platform`` (can_tpu/cli/train.py).
There is no silent fallback: a caller that wants the card and finds none
(or whose ``LOCAL_RANK`` names a card that is not there) gets an error
naming the missing card, never a run on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

PLATFORMS = ("default", "gpu", "cpu")
# the two cuBLAS workspace settings NVIDIA documents as deterministic
CUBLAS_DETERMINISTIC_CONFIGS = (":4096:8", ":16:8")


class NoCudaDeviceError(RuntimeError):
    """The card was asked for (``default`` or ``gpu``) and none is visible."""


def resolve_device(platform: str = "default",
                   local_rank: Optional[int] = None) -> torch.device:
    """``"default"``/``"gpu"`` -> ``cuda:LOCAL_RANK``, the process's own
    card (raises ``NoCudaDeviceError`` without a CUDA device, or when
    ``local_rank`` names one past ``torch.cuda.device_count()``);
    ``"cpu"`` -> the CPU.  ``local_rank`` None reads the launcher's
    ``LOCAL_RANK`` (0 when unset): one process per GPU, as under
    ``torchrun``."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "this program runs on an NVIDIA GPU — pass --platform cpu to run "
            "on the CPU instead")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if not 0 <= local_rank < count:
        raise NoCudaDeviceError(
            f"LOCAL_RANK {local_rank} names CUDA device {local_rank}, but "
            f"{count} CUDA device(s) are visible: start at most one process "
            f"per GPU (torchrun --nproc_per_node <= {count}) — pass "
            f"--platform cpu to run on the CPU instead")
    return torch.device("cuda", local_rank)


def use_full_f32() -> None:
    """f32 means f32 on the card: cuDNN runs f32 convolutions in TF32 by
    default (about three decimal digits), so turn TF32 off for
    convolutions and matmuls.  Process-wide PyTorch settings."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def use_deterministic() -> None:
    """Training repeats itself bit for bit, as the JAX trainer does on one
    device.  Process-wide; call it before the process's first CUDA work:

    * ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless one of the two
      deterministic values is set already: PyTorch reads the variable
      once, at the first cuBLAS call, and under deterministic algorithms
      every later cuBLAS call raises when it was missing then;
    * ``cudnn.deterministic`` on and ``cudnn.benchmark`` off: cuDNN picks
      deterministic convolution algorithms (in f32 its default weight
      gradients may accumulate with atomics);
    * ``torch.use_deterministic_algorithms(True)``: an op with no
      deterministic form raises instead of running (the port's adaptive
      pool is a matrix contraction for that reason, ``ops/pooling.py``);
    * ``fill_uninitialized_memory`` off: it would fill every
      ``torch.empty`` with NaN, a write per allocation, and guards only
      against reading memory never written, which no op of the port does
      (``chip_smoke.py [determinism]`` runs the kernel checks with it on).
    """
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC_CONFIGS:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC_CONFIGS[0]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
