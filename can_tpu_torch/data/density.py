"""Geometry-adaptive Gaussian ground-truth density maps, numpy and scipy
(counterpart of ``can_tpu/data/density.py:96-256``: ``gaussian_density_map``
by the numpy stamping path — no native library — and the offline
generator over ShanghaiTech ``.mat`` annotations).

Per head annotation ``(col, row)``: a unit-mass Gaussian of
``sigma = 0.1 * (d1 + d2 + d3)`` (distances to the 3 nearest other heads,
KDTree), stamped as the truncated separable kernel clipped at the image
border — exactly ``scipy.ndimage.gaussian_filter(delta, sigma,
mode='constant')``.  Out-of-image heads are skipped; a single head uses
``sigma = mean(H, W) / 4``; coincident heads get sigma 1.
"""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np
from scipy.spatial import cKDTree

from can_tpu_torch.data.imageio import image_size


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


_ANNOTATION_KEYS = ("annPoints", "points", "location", "locations")


def _load_mat_points(mat_path: str) -> np.ndarray:
    """(P, 2) ``(col, row)`` head annotations of a ShanghaiTech-style
    ``.mat`` (``image_info[0, 0][0, 0][0]``), or an (N, 2) numeric array
    under a recognised annotation key or struct field: an unconstrained
    search could pick up a [W, H] pair or box corners as heads."""
    import scipy.io as sio

    mat = sio.loadmat(mat_path)
    try:
        pts = np.asarray(mat["image_info"][0, 0][0, 0][0], dtype=np.float64)
        if pts.ndim == 2 and pts.shape[1] == 2:
            return pts
    except (KeyError, IndexError, TypeError, ValueError):
        pass
    for key in _ANNOTATION_KEYS:
        if key in mat:
            found = _find_points(mat[key])
            if found is not None:
                return found
    found = _find_points(mat.get("image_info"))
    if found is None:
        raise ValueError(
            f"no (N, 2) annotation array found in {mat_path} under keys "
            f"{sorted(k for k in mat if not k.startswith('__'))}")
    return found


def _find_points(obj):
    """The first (N, 2) numeric array inside nested MATLAB cells and
    structs, as float64 (N, 2), or None."""
    if isinstance(obj, np.ndarray):
        if (obj.ndim >= 2 and obj.shape[-1] == 2 and obj.size > 0
                and np.issubdtype(obj.dtype, np.number)):
            return np.asarray(obj, dtype=np.float64).reshape(-1, 2)
        if obj.dtype == object or obj.dtype.names:
            for item in obj.flat:
                if obj.dtype.names:
                    for name in obj.dtype.names:
                        got = _find_points(item[name])
                        if got is not None:
                            return got
                else:
                    got = _find_points(item)
                    if got is not None:
                        return got
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            got = _find_points(item)
            if got is not None:
                return got
    return None


def generate_density_maps(image_dirs: Sequence[str], *, k: int = 3,
                          sigma_scale: float = 0.1,
                          verbose: bool = True) -> int:
    """For every ``*.jpg`` and ``*.png`` under each dir, read its paired
    ``GT_<stem>.mat`` (``<stem>.mat`` unless the stem starts with
    ``IMG_``) from the sibling ``ground_truth`` dir of a leaf ``images``
    dir, and write the density map as ``<stem>.npy`` there (the
    reference's scheme, k_nearest_gaussian_kernel.py:76-83).  Only the
    leaf dir and the file's basename are rewritten, never a parent.  The
    image size comes from its header (``imageio.image_size``): no PIL.
    The JAX package's generator reads ``*.jpg`` only; PNG is the port's
    addition, for the card's machine.  Returns the number of maps
    written."""
    written = 0
    for path in image_dirs:
        files = sorted(glob.glob(os.path.join(path, "*.jpg"))
                       + glob.glob(os.path.join(path, "*.png")))
        for img_path in files:
            img_dir, fname = os.path.split(img_path)
            parent, leaf = os.path.split(img_dir)
            gt_dir = (os.path.join(parent, "ground_truth")
                      if leaf == "images" else img_dir)
            stem = os.path.splitext(fname)[0]
            mat_path = os.path.join(
                gt_dir, ("GT_" + stem if stem.startswith("IMG_") else stem)
                + ".mat")
            w, h = image_size(img_path)
            points = _load_mat_points(mat_path)
            dmap = gaussian_density_map(points, (h, w), k=k,
                                        sigma_scale=sigma_scale)
            out = os.path.join(gt_dir, stem + ".npy")
            np.save(out, dmap)
            written += 1
            if verbose:
                print(f"{img_path}: {len(points)} heads -> {out} "
                      f"(sum={dmap.sum():.2f})")
    return written
