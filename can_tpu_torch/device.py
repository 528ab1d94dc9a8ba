"""Device selection: the card by default, the CPU only when asked.

Counterpart of the JAX CLIs' ``apply_platform`` (can_tpu/cli/train.py).
There is no silent fallback: a caller that wants the card and finds none
gets an error naming the missing card, never a run on the CPU.
"""

from __future__ import annotations

import torch

PLATFORMS = ("default", "gpu", "cpu")


class NoCudaDeviceError(RuntimeError):
    """The card was asked for (``default`` or ``gpu``) and none is visible."""


def resolve_device(platform: str = "default") -> torch.device:
    """``"default"``/``"gpu"`` -> ``cuda:0`` (raises ``NoCudaDeviceError``
    without a CUDA device); ``"cpu"`` -> the CPU."""
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
    return torch.device("cuda", 0)
