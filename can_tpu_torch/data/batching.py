"""Shape buckets and padded batch assembly (counterpart of
``can_tpu/data/batching.py:52, 79, 153``).

Serving groups requests by bucket shape and pads each group into one
static-shape batch: a per-image ``sample_mask`` and a per-cell
``pixel_mask`` over the 1/8 density grid make padded pixels and fill
slots contribute exactly zero to the counts.  Host-side numpy, no torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Batch:
    """One static-shape batch.

    image: (B, H, W, 3) float32 (normalised) or uint8; zero-padded
      outside each item.
    dmap: (B, H/ds, W/ds, 1) float32 target density.
    pixel_mask: (B, H/ds, W/ds, 1) float32 — 1 on valid density cells.
    sample_mask: (B,) float32 — 1 for real items, 0 for fill slots.
    """

    image: np.ndarray
    dmap: np.ndarray
    pixel_mask: np.ndarray
    sample_mask: np.ndarray


def _ceil_bound(v: int, bounds: Tuple[int, ...]) -> int:
    """Smallest ladder bound >= v (bounds sorted ascending; last covers max)."""
    for b in bounds:
        if b >= v:
            return b
    return bounds[-1]


def snap_to_bucket(hw: Tuple[int, int], *,
                   ladder: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None,
                   pad_multiple: Optional[Tuple[int, int]] = None,
                   min_bucket_h: Optional[int] = None) -> Tuple[int, int]:
    """Bucket (H, W) for one snapped item shape.

    ladder: per-axis upper bounds ((H bounds), (W bounds)) — each axis
    snaps up to its smallest covering bound (items above the top bound
    get the top bound).  pad_multiple: (mh, mw) round-up multiples, used
    when no ladder is given.  Neither -> exact shape (zero padding).
    """
    if ladder is not None:
        hb, wb = ladder
        key = (_ceil_bound(hw[0], hb), _ceil_bound(hw[1], wb))
    elif pad_multiple is not None:
        mh, mw = pad_multiple
        key = (math.ceil(hw[0] / mh) * mh, math.ceil(hw[1] / mw) * mw)
    else:
        key = hw
    if min_bucket_h is not None and key[0] < min_bucket_h:
        key = (min_bucket_h, key[1])
    return key


def pad_batch(items, bucket_hw: Tuple[int, int], batch_size: int,
              valid_flags, ds: int) -> Batch:
    """Assemble variable-size (img, dmap) numpy pairs into one padded Batch.

    The image buffer keeps the items' dtype: float32 for the normalised
    host path, uint8 for the device-normalised path (where
    ``normalize_on_device`` zeroes padded pixels in normalised space, so
    both paths see identical zero padding)."""
    bh, bw = bucket_hw
    gh, gw = bh // ds, bw // ds
    img_dtype = items[0][0].dtype if items else np.float32
    image = np.zeros((batch_size, bh, bw, 3), img_dtype)
    dmap = np.zeros((batch_size, gh, gw, 1), np.float32)
    pixel_mask = np.zeros((batch_size, gh, gw, 1), np.float32)
    sample_mask = np.zeros((batch_size,), np.float32)
    for slot, ((img, dm), valid) in enumerate(zip(items, valid_flags)):
        h, w = img.shape[:2]
        image[slot, :h, :w] = img
        dmap[slot, : h // ds, : w // ds] = dm
        pixel_mask[slot, : h // ds, : w // ds] = 1.0
        sample_mask[slot] = float(valid)
    return Batch(image, dmap, pixel_mask, sample_mask)
