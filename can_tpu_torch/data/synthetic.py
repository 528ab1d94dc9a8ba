"""Synthetic crowd data for tests and the card's smoke run (counterpart of
``can_tpu/data/synthetic.py:19``).

The same numpy draws as the JAX package's ``make_synthetic_dataset`` (size,
head count, head positions, noise image with a bright blob per head,
geometry-adaptive density map), written as ``images/IMG_%04d.png`` (PNG,
filter 0, by ``data.imageio.write_png`` — no PIL) beside
``ground_truth/IMG_%04d.npy``: the on-disk layout the reference trains
from.  PNG is lossless, so both packages read back the same pixels.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from can_tpu_torch.data.density import gaussian_density_map
from can_tpu_torch.data.imageio import write_png


def make_synthetic_dataset(root: str, n: int, *,
                           sizes: Sequence[Tuple[int, int]] = ((256, 320), (320, 256), (384, 512)),
                           max_people: int = 40, seed: int = 0,
                           ) -> Tuple[str, str]:
    """Create n synthetic (image, density-map) pairs under ``root``;
    returns (img_root, gt_dmap_root)."""
    img_root = os.path.join(root, "images")
    gt_root = os.path.join(root, "ground_truth")
    os.makedirs(img_root, exist_ok=True)
    os.makedirs(gt_root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = sizes[int(rng.integers(len(sizes)))]
        npeople = int(rng.integers(1, max_people + 1))
        # heads as (col, row) — the ShanghaiTech .mat convention
        points = np.stack([rng.uniform(0, w, npeople),
                           rng.uniform(0, h, npeople)], axis=1)
        img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
        # bright blobs at the heads, so the image predicts the density
        for c, r in points.astype(int):
            img[max(0, r - 3):min(h, r + 4), max(0, c - 3):min(w, c + 4)] = 1.0
        write_png(os.path.join(img_root, f"IMG_{i:04d}.png"),
                  (img * 255).astype(np.uint8))
        np.save(os.path.join(gt_root, f"IMG_{i:04d}.npy"),
                gaussian_density_map(points, (h, w)))
    return img_root, gt_root
