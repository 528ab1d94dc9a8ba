"""ImageNet normalisation constants and the host-side normaliser
(counterpart of ``can_tpu/data/dataset.py:34-35, 85-91``)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_host(img: np.ndarray) -> np.ndarray:
    """u8 (H, W, 3) -> ImageNet-normalised float32 (the host-side twin of
    ``train.steps.normalize_on_device``).  Float input (already
    normalised) passes through unchanged."""
    if img.dtype != np.uint8:
        return img
    return ((img.astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)
