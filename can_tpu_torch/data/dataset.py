"""The crowd dataset, ImageNet normalisation and the host-side normaliser
(counterpart of ``can_tpu/data/dataset.py:34-35, 85-281``; no prepared
store and no item cache in this slice).

``CrowdDataset`` follows the reference loader (model/CrowdDataset.py):
RGB image (gray expanded), paired ``.npy`` density map, a seeded 50%
horizontal flip of both in the train phase, H and W snapped down to
multiples of ``gt_downsample`` (8) by a half-pixel bilinear resize, the
density map resized to (H/8, W/8) and scaled by 8 * 8 to keep the head
count, ImageNet normalisation.  Images decode without PIL or OpenCV
(``data.imageio``: PNG in numpy; JPEG only where PIL is installed).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from can_tpu_torch.data.imageio import image_shape, read_image, resize_linear

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


class CrowdDataset:
    """Indexable dataset of (image (H, W, 3), density map (h, w, 1)) numpy
    pairs.

    u8_output=True keeps the pixels as uint8 end to end on the host (u8
    decode, flip and resize — rounded to within one level of the f32
    path — and no normalisation): the train step normalises on the
    device, and the host ships 4x fewer bytes.
    """

    def __init__(self, img_root: str, gt_dmap_root: str, *,
                 gt_downsample: int = 8, phase: str = "train",
                 u8_output: bool = False):
        self.img_root = img_root
        self.gt_dmap_root = gt_dmap_root
        self.gt_downsample = int(gt_downsample)
        self.phase = phase
        self.u8_output = bool(u8_output)
        # sorted: the listing order of the file system is not portable
        self.img_names = sorted(
            f for f in os.listdir(img_root)
            if os.path.isfile(os.path.join(img_root, f)))
        # header reads, once: the batcher asks for every snapped shape, and
        # an image smaller than one density cell is refused here rather
        # than crashing a resize mid-epoch
        self._snapped = [self._snap(image_shape(os.path.join(img_root, f)))
                         for f in self.img_names]
        for f, (h, w) in zip(self.img_names, self._snapped):
            if h == 0 or w == 0:
                raise ValueError(
                    f"image {os.path.join(img_root, f)} is smaller than one "
                    f"{self.gt_downsample}px density cell (snapped shape "
                    f"{h}x{w}); remove or upscale it")

    def _snap(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        ds = self.gt_downsample
        if ds > 1:
            return (hw[0] // ds) * ds, (hw[1] // ds) * ds
        return hw

    def __len__(self) -> int:
        return len(self.img_names)

    def snapped_shape(self, index: int) -> Tuple[int, int]:
        """(H, W) of the item after /8 snapping (from the header)."""
        return self._snapped[index]

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        name = self.img_names[index]
        # the flip decision is one rng draw, taken first (the JAX order)
        flip = bool(self.phase == "train" and rng is not None
                    and rng.integers(0, 2) == 1)
        img = read_image(os.path.join(self.img_root, name))
        if not self.u8_output:
            img = img.astype(np.float32) / np.float32(255.0)
        base, _ = os.path.splitext(name)
        dmap = np.asarray(np.load(os.path.join(self.gt_dmap_root, base + ".npy")),
                          dtype=np.float32)
        if flip:
            img = img[:, ::-1]
            dmap = dmap[:, ::-1]
        ds = self.gt_downsample
        if ds > 1:
            rows, cols = img.shape[0] // ds, img.shape[1] // ds
            if img.shape[:2] != (rows * ds, cols * ds):
                img = resize_linear(img, rows * ds, cols * ds)
            dmap = resize_linear(dmap, rows, cols) * np.float32(ds * ds)
        img = np.ascontiguousarray(img)
        dmap = np.ascontiguousarray(dmap[..., np.newaxis], dtype=np.float32)
        if not self.u8_output:
            img = ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        return img, dmap
