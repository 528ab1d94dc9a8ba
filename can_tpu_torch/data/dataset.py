"""The crowd dataset, ImageNet normalisation and the host-side normaliser
(counterpart of ``can_tpu/data/dataset.py:34-35, 85-281``).

``CrowdDataset`` follows the reference loader (model/CrowdDataset.py):
RGB image (gray expanded), paired ``.npy`` density map, a seeded 50%
horizontal flip of both in the train phase, H and W snapped down to
multiples of ``gt_downsample`` (8) by a half-pixel bilinear resize, the
density map resized to (H/8, W/8) and scaled by 8 * 8 to keep the head
count, ImageNet normalisation.  Images decode without PIL or OpenCV
(``data.imageio``: PNG in numpy; JPEG only where PIL is installed).
The density maps can come from a prepared store and whole items from a
shared ``ItemCache`` (``data/prepared.py``), bit-identical either way.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from can_tpu_torch.data.imageio import image_shape, read_image, resize_linear
from can_tpu_torch.data.prepared import PreparedStore, StaleStoreError, downsample_density

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

    prepared: "auto" (default) probes ``<gt_dmap_root>/prepared`` for a
    baked 1/8-density store and uses it when its manifest validates, else
    decodes as usual, with the reason in ``prepared_note``; "off" (or
    None) decodes; a path names a store that must validate
    (``StaleStoreError`` otherwise).

    item_cache: an ``ItemCache`` shared across datasets: decoded items
    keyed on the decode config, index and flip.
    """

    def __init__(self, img_root: str, gt_dmap_root: str, *,
                 gt_downsample: int = 8, phase: str = "train",
                 u8_output: bool = False, prepared: Optional[str] = "auto",
                 item_cache=None):
        self.img_root = img_root
        self.gt_dmap_root = gt_dmap_root
        self.gt_downsample = int(gt_downsample)
        self.phase = phase
        self.u8_output = bool(u8_output)
        self.item_cache = item_cache
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
        self.prepared: Optional[PreparedStore] = None
        self._resolve_prepared(prepared)

    def _resolve_prepared(self, spec) -> None:
        """Open the prepared store per ``spec`` ("auto", "off"/None or a
        path); a probe that fails leaves the reason in ``prepared_note``."""
        spec = "off" if spec is None else spec
        self.prepared_note = {"mode": str(spec), "active": False,
                              "root": None, "reason": None}
        if spec == "off":
            self.prepared_note["reason"] = "disabled"
            return
        if self.gt_downsample <= 1:
            self.prepared_note["reason"] = \
                "gt_downsample <= 1 (no resize to do ahead of time)"
            return
        root = (PreparedStore.default_root(self.gt_dmap_root)
                if spec == "auto" else spec)
        self.prepared_note["root"] = root
        try:
            self.prepared = PreparedStore.open(
                root, gt_dmap_root=self.gt_dmap_root,
                gt_downsample=self.gt_downsample, img_names=self.img_names,
                expected_hw=dict(zip(self.img_names, self._snapped)))
            self.prepared_note["active"] = True
        except StaleStoreError as e:
            if spec != "auto":
                raise
            self.prepared_note["reason"] = str(e)

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
        if self.item_cache is not None:
            # the whole decode config is in the key: a shared cache never
            # hands an f32 item to a u8 dataset
            cache_key = (self.img_root, self.gt_dmap_root, self.gt_downsample,
                         self.u8_output, index, flip)
            hit = self.item_cache.get(cache_key)
            if hit is not None:
                return hit
        img = read_image(os.path.join(self.img_root, name))
        if not self.u8_output:
            img = img.astype(np.float32) / np.float32(255.0)
        if flip:
            img = img[:, ::-1]
        ds = self.gt_downsample
        rows, cols = img.shape[0] // ds, img.shape[1] // ds
        if ds > 1 and img.shape[:2] != (rows * ds, cols * ds):
            img = resize_linear(img, rows * ds, cols * ds)
        if self.prepared is not None:
            # baked in this flip orientation: the full map is never read
            dmap = self.prepared.load(name, flip=flip)
            if dmap.shape != (rows, cols):
                raise StaleStoreError(
                    f"prepared map {name} is {dmap.shape}, expected "
                    f"{(rows, cols)}: the store is out of date")
        else:
            base, _ = os.path.splitext(name)
            dmap = np.asarray(np.load(os.path.join(self.gt_dmap_root,
                                                   base + ".npy")),
                              dtype=np.float32)
            if flip:
                dmap = dmap[:, ::-1]
            if ds > 1:
                dmap = downsample_density(dmap, rows, cols, ds)
        img = np.ascontiguousarray(img)
        dmap = np.ascontiguousarray(dmap[..., np.newaxis], dtype=np.float32)
        if not self.u8_output:
            img = ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        if self.item_cache is not None:
            # read-only before sharing: every later epoch gets these buffers
            img.setflags(write=False)
            dmap.setflags(write=False)
            self.item_cache.put(cache_key, (img, dmap))
        return img, dmap
