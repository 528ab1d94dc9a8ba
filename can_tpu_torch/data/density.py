"""Geometry-adaptive Gaussian ground-truth density maps, numpy and scipy
(counterpart of ``can_tpu/data/density.py:96``, ``gaussian_density_map``;
the numpy stamping path — no native library).

Per head annotation ``(col, row)``: a unit-mass Gaussian of
``sigma = 0.1 * (d1 + d2 + d3)`` (distances to the 3 nearest other heads,
KDTree), stamped as the truncated separable kernel clipped at the image
border — exactly ``scipy.ndimage.gaussian_filter(delta, sigma,
mode='constant')``.  Out-of-image heads are skipped; a single head uses
``sigma = mean(H, W) / 4``; coincident heads get sigma 1.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.spatial import cKDTree


def _gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage's Gaussian: sampled, normalised to sum 1."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


def _stamp_gaussian(density: np.ndarray, row: int, col: int, sigma: float,
                    truncate: float = 4.0) -> None:
    """Add a unit-mass truncated Gaussian at (row, col), clipped to bounds."""
    h, w = density.shape
    radius = int(truncate * float(sigma) + 0.5)
    if radius < 1:
        density[row, col] += 1.0
        return
    k = _gaussian_kernel_1d(sigma, radius)
    r0, r1 = max(0, row - radius), min(h, row + radius + 1)
    c0, c1 = max(0, col - radius), min(w, col + radius + 1)
    kr = k[r0 - (row - radius): r1 - (row - radius)]
    kc = k[c0 - (col - radius): c1 - (col - radius)]
    density[r0:r1, c0:c1] += np.outer(kr, kc)


def gaussian_density_map(points: np.ndarray, shape: Sequence[int], *,
                         k: int = 3, sigma_scale: float = 0.1,
                         truncate: float = 4.0) -> np.ndarray:
    """points: (P, 2) ``(col, row)`` head positions; shape: (H, W).
    Returns the f32 (H, W) density map (sum ~ in-bounds heads, minus mass
    clipped at the border)."""
    h, w = int(shape[0]), int(shape[1])
    density = np.zeros((h, w), dtype=np.float64)
    points = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    n = len(points)
    if n == 0:
        return density.astype(np.float32)
    if n > 1:
        # k + 1 neighbours: the nearest is the point itself at distance 0
        distances, _ = cKDTree(points, leafsize=2048).query(points,
                                                           k=min(k + 1, n))
        distances = np.atleast_2d(distances)
    for i, (c, r) in enumerate(points):
        row, col = int(r), int(c)
        if not (0 <= row < h and 0 <= col < w):
            continue
        if n > 1:
            sigma = float(distances[i][1:].sum()) * sigma_scale
        else:
            sigma = (h + w) / 2.0 / 4.0
        if sigma <= 0:
            sigma = 1.0
        _stamp_gaussian(density, row, col, sigma, truncate)
    return density.astype(np.float32)
