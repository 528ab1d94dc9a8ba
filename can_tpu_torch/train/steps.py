"""On-device input normalisation (counterpart of
``can_tpu/train/steps.py:39-62``, ``normalize_on_device`` only)."""

from __future__ import annotations

import torch

from can_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD


def normalize_on_device(image: torch.Tensor,
                        pixel_mask: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> ImageNet-normalised f32, on the image's device.

    The host ships bytes (4x less than normalised f32).  Padded pixels are
    zeroed in NORMALISED space via the upsampled pixel_mask (the
    downsample factor comes from the image/mask shapes), so the result
    equals the f32 host path, whose zero padding also lives in normalised
    space.  Float images pass through untouched.
    """
    if image.dtype != torch.uint8:
        return image
    ds = image.shape[-3] // pixel_mask.shape[-3]
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    x = (image.float() / 255.0 - mean) / std
    m = pixel_mask.repeat_interleave(ds, dim=-3).repeat_interleave(ds, dim=-2)
    return x * m
