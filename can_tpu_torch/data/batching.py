"""Shape buckets, padded batch assembly and the training batcher
(counterpart of ``can_tpu/data/batching.py:52, 79, 153, 177``).

Serving and training group items by bucket shape and pad each group into
one static-shape batch: a per-image ``sample_mask`` and a per-cell
``pixel_mask`` over the 1/8 density grid make padded pixels and fill
slots contribute exactly zero to losses and counts.  ``ShardedBatcher``
is the one-process training schedule: a seeded shuffle per (seed, epoch),
exact-shape or integer-multiple buckets, full groups as they fill, then
each bucket's stragglers padded to the batch with fill slots.  Host-side
numpy, no torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

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


PLANNER_MESSAGE = ("{what} comes with the planner slice of can_tpu_torch "
                   "(data/planner.py, ROADMAP Queue 1); use an integer "
                   "pad multiple or exact shapes (None)")


class ShardedBatcher:
    """Shuffled, shape-bucketed batch iterator for one process (the
    non-ladder path of the JAX ``ShardedBatcher``: ``_build_schedule``
    without group merging; the schedule is identical to the JAX one for
    the same seed, epoch and arguments).

    dataset: needs ``__len__``, ``snapped_shape(i) -> (H, W)`` and
      ``__getitem__(i, rng) -> (img HWC, dmap hw1)``.
    batch_size: items per emitted batch.
    pad_multiple: None -> bucket by exact snapped shape (zero padding);
      int or (mh, mw), multiples of ``ds`` -> round H, W up to them.
      ``"auto"`` (and ``remnant_sizes=True``) belong to the planner and
      are refused.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, pad_multiple=None, ds: int = 8,
                 remnant_sizes: bool = False):
        if pad_multiple == "auto":
            raise ValueError(PLANNER_MESSAGE.format(
                what="pad_multiple='auto' (the bucket ladder)"))
        if remnant_sizes:
            raise ValueError(PLANNER_MESSAGE.format(
                what="remnant_sizes=True (remnant sub-batches)"))
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.ds = int(ds)
        if isinstance(pad_multiple, int):
            pad_multiple = (pad_multiple, pad_multiple)
        if pad_multiple is not None:
            pad_multiple = tuple(int(m) for m in pad_multiple)
            if any(m <= 0 or m % self.ds for m in pad_multiple):
                raise ValueError(
                    f"pad_multiple ({pad_multiple}) must be positive "
                    f"multiples of the density downsample factor ({self.ds})")
        self.pad_multiple = pad_multiple
        self._shape_cache: Dict[int, Tuple[int, int]] = {}
        # the last epoch's schedule: batches_per_epoch and epoch() ask for
        # the same one, and a rebuild is an O(dataset) sort and group
        self._epoch_cache: Optional[Tuple[int, list]] = None

    def _item_shape(self, idx: int) -> Tuple[int, int]:
        hw = self._shape_cache.get(idx)
        if hw is None:
            hw = self._shape_cache[idx] = self.dataset.snapped_shape(idx)
        return hw

    def _bucket_key(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        return snap_to_bucket(hw, pad_multiple=self.pad_multiple)

    @property
    def dataset_size(self) -> int:
        """True dataset length — the unbiased eval denominator."""
        return len(self.dataset)

    def describe_buckets(self) -> str:
        if self.pad_multiple is None:
            return "exact shapes"
        mh, mw = self.pad_multiple
        return f"multiple of {mh}" if mh == mw else \
            f"H multiple of {mh}, W multiple of {mw}"

    def padding_overhead(self) -> float:
        """Fraction of bucket pixels that are padding (0 = exact shapes)."""
        shapes = [self._item_shape(i) for i in range(len(self.dataset))]
        item_area = sum(h * w for h, w in shapes)
        bucket_area = sum(bh * bw for bh, bw in map(self._bucket_key, shapes))
        return bucket_area / max(item_area, 1) - 1.0

    def distinct_shapes(self, epoch: int = 0) -> int:
        return len({key for key, _ in self.global_schedule(epoch)})

    def global_schedule(self, epoch: int
                        ) -> List[Tuple[Tuple[int, int], List[Tuple[int, bool]]]]:
        """Deterministic batch plan: [(bucket_hw, [(idx, valid)] of length
        batch_size)] for a given (seed, epoch)."""
        if self._epoch_cache is None or self._epoch_cache[0] != epoch:
            self._epoch_cache = (epoch, self._build_schedule(epoch))
        return self._epoch_cache[1]

    def _build_schedule(self, epoch: int):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        pending: Dict[Tuple[int, int], List[Tuple[int, bool]]] = {}
        schedule = []
        for idx in order.tolist():
            key = self._bucket_key(self._item_shape(idx))
            group = pending.setdefault(key, [])
            group.append((idx, True))
            if len(group) == self.batch_size:
                schedule.append((key, group))
                pending[key] = []
        for key, group in sorted(((k, g) for k, g in pending.items() if g),
                                 key=lambda kg: kg[0]):
            # dead slots (static shape, zero weight) instead of the
            # reference's wrap-around duplicates
            group = group + [(group[0][0], False)] * (self.batch_size - len(group))
            schedule.append((key, group))
        return schedule

    def batches_per_epoch(self, epoch: int = 0) -> int:
        return len(self.global_schedule(epoch))

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """Yield each batch of the epoch's schedule, in order.  Each item's
        RNG (the flip) is keyed on (seed, epoch, index)."""
        for key, group in self.global_schedule(epoch):
            items = [self._load_item(int(idx), epoch) for idx, _ in group]
            yield pad_batch(items, key, len(group), [v for _, v in group],
                            self.ds)

    def _load_item(self, idx: int, epoch: int):
        rng = np.random.default_rng((self.seed, epoch, idx))
        return self.dataset.__getitem__(idx, rng=rng)
