"""Density-map visualisation (counterpart of ``can_tpu/utils/viz.py:18``).

Writes the sample image and the ground-truth and estimated density maps
as PNGs, as the reference's eval-time overlays do.  Without matplotlib or
PIL: the maps are coloured by a jet colour map computed here and written
by ``data.imageio.write_png``; no title text.  The un-normalise uses the
ImageNet std of 0.225 for blue (the reference writes 0.255).
"""

from __future__ import annotations

import os

import numpy as np

from can_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from can_tpu_torch.data.imageio import write_png


def jet(values: np.ndarray) -> np.ndarray:
    """(h, w) values in [0, 1] -> (h, w, 3) uint8 RGB on matplotlib's jet
    ramp (dark blue, blue, cyan, yellow, red, dark red), piecewise linear."""
    x = np.clip(np.asarray(values, np.float64), 0.0, 1.0)[..., None]
    centres = np.array([0.75, 0.5, 0.25])  # where R, G, B peak
    rgb = np.clip(1.5 - np.abs(4.0 * (x - centres)), 0.0, 1.0)
    return np.rint(rgb * 255.0).astype(np.uint8)


def _density_rgb(dmap: np.ndarray) -> np.ndarray:
    d = np.asarray(dmap, np.float64).squeeze()
    peak = d.max() if d.size else 0.0
    return jet(d / peak if peak > 0 else np.zeros_like(d))


def save_density_visualization(image: np.ndarray, gt_dmap: np.ndarray,
                               et_dmap: np.ndarray, out_dir: str, *,
                               tag: str = "sample") -> list:
    """Write ``{tag}_img/gt/et.png`` under ``out_dir``; returns the paths.

    image: (H, W, 3) normalised; gt/et_dmap: (h, w) or (h, w, 1), each
    scaled by its own maximum before colouring.
    """
    os.makedirs(out_dir, exist_ok=True)
    img = np.asarray(image, np.float32) * IMAGENET_STD + IMAGENET_MEAN
    img = np.rint(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    paths = []
    for name, rgb in (("img", img), ("gt", _density_rgb(gt_dmap)),
                      ("et", _density_rgb(et_dmap))):
        path = os.path.join(out_dir, f"{tag}_{name}.png")
        write_png(path, rgb)
        paths.append(path)
    return paths
