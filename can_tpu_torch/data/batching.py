"""Shape buckets, padded batch assembly and the training batcher
(counterpart of ``can_tpu/data/batching.py:52-911``).

Serving and training group items by bucket shape and pad each group into
one static-shape batch: a per-image ``sample_mask`` and a per-cell
``pixel_mask`` over the 1/8 density grid make padded pixels and fill
slots contribute exactly zero to losses and counts.  ``ShardedBatcher``
is the one-process training schedule: a seeded shuffle per (seed, epoch)
and buckets that are exact shapes, integer multiples or, with
``pad_multiple="auto"``, a per-axis ladder chosen from the dataset's
shape histogram.  Under several processes every process computes the
same global schedule from the same seed and loads only its own slice of
each global launch (the lockstep sharding ``DistributedSampler`` gives
the reference, train.py:79-88): every process steps through the same
launch count and shapes, which DDP's collectives need.  Short launches
get ``sample_mask = 0`` fill slots, not the reference's wrap-around
duplicates.  With ``remnant_sizes`` the launch plan (per-cell batch
sizes under the memory cap, straggler covers at exact sizes, group
merges) comes from the cost model of ``data/planner.py``, or with
``plan_mode="legacy"`` from its pre-cost-model heuristics.  The schedule
equals the JAX package's for the same seed, epoch and arguments.
Host-side numpy, no torch.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from can_tpu_torch.data.planner import (
    GlobalPlanner,
    PlanCostModel,
    merge_partial_groups,
    remnant_menu,
)


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




class ShardedBatcher:
    """Shuffled, shape-bucketed, lockstep-sharded batch iterator.

    dataset: needs ``__len__``, ``snapped_shape(i) -> (H, W)`` and
      ``__getitem__(i, rng) -> (img HWC, dmap hw1)``.
    batch_size: items per process per emitted batch (remnant launches may
      be smaller); the global batch is ``batch_size * process_count``.
    process_index, process_count: this process and the world; each
      process loads slice ``process_index`` of every global launch.
    pad_multiple: None -> bucket by exact snapped shape (zero padding);
      int or (mh, mw), multiples of ``ds`` -> round H, W up to them;
      ``"auto"`` -> exact shapes when at most ``max_buckets`` distinct
      shapes occur, else a per-axis ladder (``_resolve_auto_buckets``).
    max_buckets: the budget of distinct (shape, size) programs for
      ``"auto"``.
    num_workers: loader threads (0 = load in the caller's thread); the
      batches come out in schedule order either way.
    remnant_sizes: straggler groups launch at the sizes of a menu (every
      multiple of ``batch_quantum`` up to the global batch) instead of
      padding to the full batch; with a ladder the whole launch plan
      comes from ``data/planner.py``.
    batch_quantum: global launch sizes are multiples of it, so every
      launch splits evenly across processes (callers pass lcm(dp,
      process_count)); default ``process_count``.
    launch_cost_px: fixed cost of one launch in pixel equivalents, for the
      planner's pixels-against-launches trade (``cli/common.py`` derives
      it from the card's measurement).
    max_launch_px: device-memory cap per launch (batch * H * W), or None:
      cells whose full batch would not fit run at smaller menu sizes.
    plan_mode: "cost" (default) or "legacy" (``data/planner.py``'s
      modes; legacy also scores ladders by padded area and uses the
      power-of-two menu).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, process_index: int = 0, process_count: int = 1,
                 pad_multiple=None, ds: int = 8,
                 max_buckets: int = 8, num_workers: int = 0,
                 remnant_sizes: bool = False,
                 batch_quantum: Optional[int] = None,
                 launch_cost_px: float = 2e6,
                 max_launch_px: Optional[float] = None,
                 plan_mode: str = "cost"):
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if plan_mode not in ("cost", "legacy"):
            raise ValueError(f"unknown plan_mode {plan_mode!r}")
        self.plan_mode = plan_mode
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.ds = int(ds)
        self.max_buckets = int(max_buckets)
        self.remnant_sizes = bool(remnant_sizes)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"process_count {process_count}")
        self.batch_quantum = int(batch_quantum or self.process_count)
        self.launch_cost_px = float(launch_cost_px)
        self.max_launch_px = (None if max_launch_px is None
                              else float(max_launch_px))
        self.num_workers = int(num_workers)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._cap_warned: set = set()
        self._plan_cache = None
        self._cell_counts_cache: Optional[Dict[Tuple[int, int], int]] = None
        # the last epoch's schedule: batches_per_epoch, epoch() and the
        # overhead figures ask for the same one, and a rebuild is an
        # O(dataset) sort and group
        self._epoch_cache: Optional[Tuple[int, list]] = None
        self._shape_cache: Dict[int, Tuple[int, int]] = {}
        self.bucket_ladder: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
        if self.remnant_sizes:
            gbs = self.batch_size * self.process_count
            if self.batch_quantum % self.process_count:
                raise ValueError(
                    f"batch_quantum ({self.batch_quantum}) must be a multiple "
                    f"of process_count ({self.process_count}) so every "
                    f"process slices an equal share of each sub-batch")
            if gbs % self.batch_quantum:
                raise ValueError(f"global batch ({gbs}) must be a multiple "
                                 f"of batch_quantum ({self.batch_quantum})")
        if pad_multiple == "auto":
            pad_multiple = self._resolve_auto_buckets()
        if isinstance(pad_multiple, int):
            pad_multiple = (pad_multiple, pad_multiple)
        if pad_multiple is not None:
            pad_multiple = tuple(int(m) for m in pad_multiple)
            if any(m <= 0 or m % self.ds for m in pad_multiple):
                raise ValueError(
                    f"pad_multiple ({pad_multiple}) must be positive "
                    f"multiples of the density downsample factor ({self.ds})")
        self.pad_multiple = pad_multiple

    def _item_shape(self, idx: int) -> Tuple[int, int]:
        hw = self._shape_cache.get(idx)
        if hw is None:
            hw = self._shape_cache[idx] = self.dataset.snapped_shape(idx)
        return hw

    def _shapes(self) -> List[Tuple[int, int]]:
        return [self._item_shape(i) for i in range(len(self.dataset))]

    # -- the auto ladder ---------------------------------------------------
    @staticmethod
    def _axis_bounds(values, k: int, floor: int) -> Tuple[int, ...]:
        """k quantile upper bounds of one axis, rounded up to ``floor``
        multiples: the coordinate descent's seed."""
        vs = sorted(values)
        n = len(vs)
        bounds = set()
        for i in range(1, k + 1):
            v = vs[-(-i * n // k) - 1]  # ceil(i*n/k)-1: the i-th quantile's top
            bounds.add(-(-v // floor) * floor)
        return tuple(sorted(bounds))

    @staticmethod
    def _dp_axis_bounds(values, weights, k: int, floor: int) -> Tuple[int, ...]:
        """The exact optimal <= k upper bounds of one axis minimising
        ``sum_i weights[i] * bound(values[i])``, bounds on ``floor``
        multiples of observed values (O(k n^2) DP over the n distinct
        candidates)."""
        cands = sorted({-(-v // floor) * floor for v in values})
        n = len(cands)
        if n <= k:
            return tuple(cands)
        wsum = {c: 0.0 for c in cands}
        for v, wt in zip(values, weights):
            wsum[-(-v // floor) * floor] += float(wt)
        pre = np.concatenate([[0.0], np.cumsum([wsum[c] for c in cands])])
        c_arr = np.asarray(cands, dtype=np.float64)
        # f[m, j]: least cost covering candidates[0..j] with m bounds, the
        # last at j
        f = np.full((k + 1, n), np.inf)
        f[1] = c_arr * pre[1:]
        choice = np.zeros((k + 1, n), dtype=np.int64)
        for m in range(2, k + 1):
            prev = f[m - 1][:, None]
            trans = prev + c_arr[None, :] * (pre[1:][None, :] - pre[1:][:, None])
            trans = np.where(np.tri(n, n, -1, dtype=bool).T, trans, np.inf)
            choice[m] = np.argmin(trans, axis=0)
            f[m] = trans[choice[m], np.arange(n)]
        m_best = int(np.argmin(f[1:, n - 1])) + 1
        bounds, j, m = [], n - 1, m_best
        while m >= 1:
            bounds.append(cands[j])
            j, m = int(choice[m][j]), m - 1
        return tuple(sorted(bounds))

    def _resolve_auto_buckets(self) -> None:
        """Pick bucket shapes for ``pad_multiple="auto"``: exact shapes
        (zero padding) when at most ``max_buckets`` distinct shapes
        occur; else the per-axis ladder (kh H bounds x kw W bounds) of
        least cost.  Each candidate grid starts from quantiles and is
        coordinate-descended (each axis re-solved exactly, weighted by the
        other axis's padded extent).  With remnant sizes in cost mode every
        grid with kh * kw <= max_buckets is scored by the full plan cost
        of the schedule it induces; otherwise grids that fill the budget
        are scored by padded area.  Sets ``bucket_ladder``; returns None (the
        pad multiple)."""
        shapes = self._shapes()
        if not shapes or len(set(shapes)) <= self.max_buckets:
            return None
        floor = self.ds
        hs = [h for h, _ in shapes]
        ws = [w for _, w in shapes]
        cost_scored = self.plan_mode == "cost" and self.remnant_sizes
        candidates = ((kh, kw)
                      for kh in range(1, self.max_buckets + 1)
                      for kw in (range(1, self.max_buckets // kh + 1)
                                 if cost_scored else (self.max_buckets // kh,))
                      if kw >= 1)
        best, seen = None, set()
        for kh, kw in candidates:
            hb = self._axis_bounds(hs, kh, floor)
            wb = self._axis_bounds(ws, kw, floor)
            for _ in range(3):
                hb2 = self._dp_axis_bounds(
                    hs, [_ceil_bound(w, wb) for w in ws], kh, floor)
                wb2 = self._dp_axis_bounds(
                    ws, [_ceil_bound(h, hb2) for h in hs], kw, floor)
                if (hb2, wb2) == (hb, wb):
                    break
                hb, wb = hb2, wb2
            if len(hb) * len(wb) > self.max_buckets or (hb, wb) in seen:
                continue
            seen.add((hb, wb))
            if cost_scored:
                score = self._ladder_plan_cost((hb, wb), shapes)
            else:
                score = sum(_ceil_bound(h, hb) * _ceil_bound(w, wb)
                            for h, w in shapes)
            if best is None or score < best[0]:
                best = (score, hb, wb)
        if best is None:  # budget under any grid: one bucket at the max
            best = (0, (-(-max(hs) // floor) * floor,),
                    (-(-max(ws) // floor) * floor,))
        self.bucket_ladder = (best[1], best[2])
        return None

    def _ladder_plan_cost(self, ladder, shapes) -> float:
        """Plan cost of the epoch a candidate ladder would induce (cell
        counts vectorised; warnings silent here)."""
        hb, wb = ladder
        hb_arr, wb_arr = np.asarray(hb), np.asarray(wb)
        hi = np.minimum(np.searchsorted(hb_arr, [h for h, _ in shapes]),
                        len(hb) - 1)
        wi = np.minimum(np.searchsorted(wb_arr, [w for _, w in shapes]),
                        len(wb) - 1)
        cells, ncell = np.unique(np.stack([hb_arr[hi], wb_arr[wi]], axis=1),
                                 axis=0, return_counts=True)
        counts = {(int(h), int(w)): int(c) for (h, w), c in zip(cells, ncell)}
        planner = GlobalPlanner(self._cost_model(), max_buckets=self.max_buckets,
                                mode=self.plan_mode)
        return planner.plan_with_fallback(counts).cost

    # -- economics and descriptions ---------------------------------------
    def padding_overhead(self) -> float:
        """Fraction of bucket pixels that are padding, over the dataset's
        items (0 = exact shapes)."""
        shapes = self._shapes()
        if not shapes:
            return 0.0
        item_area = sum(h * w for h, w in shapes)
        bucket_area = sum(bh * bw for bh, bw in map(self._bucket_key, shapes))
        return bucket_area / max(item_area, 1) - 1.0

    def schedule_overhead(self, epoch: int = 0) -> float:
        """Fraction of the epoch's launched pixels beyond the valid item
        pixels: padding and fill slots together."""
        valid_px = used_px = 0
        for key, group in self.global_schedule(epoch):
            used_px += key[0] * key[1] * len(group)
            for idx, valid in group:
                if valid:
                    h, w = self._item_shape(idx)
                    valid_px += h * w
        return used_px / max(valid_px, 1) - 1.0

    def describe_buckets(self) -> str:
        if self.bucket_ladder is not None:
            hb, wb = self.bucket_ladder
            return f"auto ladder H{list(hb)} x W{list(wb)}"
        if self.pad_multiple is None:
            return "exact shapes"
        mh, mw = self.pad_multiple
        return f"multiple of {mh}" if mh == mw else \
            f"H multiple of {mh}, W multiple of {mw}"

    def distinct_shapes(self, epoch: int = 0) -> int:
        return len({key for key, _ in self.global_schedule(epoch)})

    def program_count(self, epoch: int = 0) -> int:
        """Distinct (bucket shape, batch size) pairs in the epoch."""
        return len({(key, len(group))
                    for key, group in self.global_schedule(epoch)})

    @property
    def dataset_size(self) -> int:
        """True dataset length — the unbiased eval denominator."""
        return len(self.dataset)

    def _bucket_key(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        return snap_to_bucket(hw, ladder=self.bucket_ladder,
                              pad_multiple=self.pad_multiple)

    # -- the plan ------------------------------------------------------------
    def _remnant_menu(self) -> Tuple[int, ...]:
        return remnant_menu(self.batch_size * self.process_count,
                            self.batch_quantum,
                            mode=self.plan_mode)

    def _cost_model(self, menu: Optional[Tuple[int, ...]] = None):
        return PlanCostModel(menu=menu or self._remnant_menu(),
                             launch_cost_px=self.launch_cost_px,
                             max_launch_px=self.max_launch_px)

    def _warn(self, msg: str) -> None:
        tag = msg[:40]
        if tag not in self._cap_warned:
            self._cap_warned.add(tag)
            print(f"[batching] WARNING: {msg}")

    def _menu_for(self, key: Tuple[int, int],
                  menu: Tuple[int, ...]) -> Tuple[int, ...]:
        """Menu sizes under the per-launch cap for this cell; the smallest
        always survives (warned once when even it is over the cap)."""
        model = self._cost_model(menu)
        if self.max_launch_px is not None and not model.fits(key, min(menu)):
            self._warn(f"bucket {key[0]}x{key[1]} exceeds the per-launch "
                       f"pixel cap even at the minimum batch {min(menu)} "
                       f"({min(menu) * key[0] * key[1] / 1e6:.1f} Mpx > "
                       f"{self.max_launch_px / 1e6:.1f} Mpx) — launching "
                       f"anyway; expect memory pressure")
        return model.fitting(key)

    def _cell_counts(self) -> Dict[Tuple[int, int], int]:
        if self._cell_counts_cache is None:
            self._cell_counts_cache = dict(collections.Counter(
                map(self._bucket_key, self._shapes())))
        return self._cell_counts_cache

    def _partial_plan(self):
        """The epoch-invariant launch plan of ladder + remnant mode: an
        item's cell is a function of its shape, so each cell's count (and
        its full/remnant split) is the same in every epoch; only which
        items fill the slots changes with the shuffle.  Computed once
        from the histogram; ``legacy_fallback`` means padding every
        straggler group to the batch proved cheaper."""
        if self._plan_cache is None:
            planner = GlobalPlanner(self._cost_model(),
                                    max_buckets=self.max_buckets,
                                    mode=self.plan_mode, warn=self._warn)
            self._plan_cache = planner.plan_with_fallback(self._cell_counts())
        return self._plan_cache

    def planner_stats(self, epoch: int = 0) -> Dict[str, object]:
        """Planner decisions and the epoch schedule's realised economics,
        one flat dict; with a ladder and remnant sizes also the plan's
        predicted ones (equal to the realised: pinned by test)."""
        sched = self.global_schedule(epoch)
        used_px = sum(k[0] * k[1] * len(g) for k, g in sched)
        valid_px = sum(h * w for h, w in self._shapes())
        stats = {
            "plan_mode": self.plan_mode,
            "padding_overhead": round(self.padding_overhead(), 4),
            "schedule_overhead": round(used_px / max(valid_px, 1) - 1.0, 4),
            "program_count": len({(k, len(g)) for k, g in sched}),
            "batches_per_epoch": len(sched),
            "realized_px": float(used_px),
            "realized_cost_px": float(used_px + self.launch_cost_px * len(sched)),
            "launch_cost_px": float(self.launch_cost_px),
            "max_launch_px": self.max_launch_px,
            "max_buckets": self.max_buckets,
        }
        if self.bucket_ladder is not None and self.remnant_sizes:
            plan = self._partial_plan()
            stats.update(
                plan_cost_px=float(plan.cost),
                plan_scheduled_px=float(plan.scheduled_px),
                plan_launches=plan.launches,
                plan_programs=len(plan.programs),
                lowered_cells=plan.lowered_cells,
                lowered_launches=plan.lowered_launches,
                legacy_fallback=plan.legacy_fallback,
                menu_sizes=len(plan.menu),
            )
        return stats

    # -- the schedule ----------------------------------------------------------
    def global_schedule(self, epoch: int
                        ) -> List[Tuple[Tuple[int, int], List[Tuple[int, bool]]]]:
        """Deterministic batch plan: [(bucket_hw, [(idx, valid)])] for a
        given (seed, epoch); each group is one launch."""
        if self._epoch_cache is None or self._epoch_cache[0] != epoch:
            self._epoch_cache = (epoch, self._build_schedule(epoch))
        return self._epoch_cache[1]

    def _build_schedule(self, epoch: int):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        gbs = self.batch_size * self.process_count
        menu = self._remnant_menu() if self.remnant_sizes else None
        plan = None
        if self.bucket_ladder is not None and self.remnant_sizes:
            plan = self._partial_plan()
            if plan.legacy_fallback:
                plan = None
        if plan is not None:
            # full launches stream out as cells fill (each cell's planned
            # sizes are descending, so its thresholds are hit in order);
            # then the planned straggler groups
            next_full = {k: list(parts) for k, parts in plan.full_parts.items()}
            pending: Dict[Tuple[int, int], List[Tuple[int, bool]]] = {}
            schedule = []
            for idx in order.tolist():
                key = self._bucket_key(self._item_shape(idx))
                group = pending.setdefault(key, [])
                group.append((idx, True))
                parts = next_full.get(key)
                if parts and len(group) == parts[0]:
                    schedule.append((key, group))
                    pending[key] = []
                    parts.pop(0)
            for pg in plan.groups:
                items = [it for k in pg.sources for it in pending.get(k, [])]
                pos = 0
                for size in pg.parts:
                    take = items[pos:pos + size]
                    pos += size
                    if len(take) < size:
                        take = take + [(take[0][0], False)] * (size - len(take))
                    schedule.append((pg.key, take))
            return schedule

        full_size: Dict[Tuple[int, int], int] = {}  # the cap may lower it

        def cell_full(key):
            s = full_size.get(key)
            if s is None:
                s = full_size[key] = (max(self._menu_for(key, menu))
                                      if self.remnant_sizes else gbs)
            return s

        pending = {}
        schedule = []
        for idx in order.tolist():
            key = self._bucket_key(self._item_shape(idx))
            group = pending.setdefault(key, [])
            group.append((idx, True))
            if len(group) == cell_full(key):
                schedule.append((key, group))
                pending[key] = []
        if self.bucket_ladder is None and self.remnant_sizes:
            # exact or fixed-multiple buckets: each straggler group runs
            # once, at the smallest menu size that holds it (no merge: a
            # join would break these modes' padding promise)
            for key, group in sorted(((k, g) for k, g in pending.items() if g),
                                     key=lambda kg: kg[0]):
                fits = [s for s in self._menu_for(key, menu) if s >= len(group)]
                size = min(fits) if fits else max(self._menu_for(key, menu))
                pos = 0
                while pos < len(group):  # more than one round only under a cap
                    take = group[pos:pos + size]
                    pos += size
                    if len(take) < size:
                        take = take + [(take[0][0], False)] * (size - len(take))
                    schedule.append((key, take))
            return schedule
        partials = sorted(((k, g) for k, g in pending.items() if g),
                          key=lambda kg: kg[0])
        if self.bucket_ladder is not None:
            # ladder joins are grid cells: merging stragglers upward keeps
            # the bucket count bounded
            partials = merge_partial_groups(partials, gbs)
        for key, group in partials:
            if len(group) < gbs:
                # dead slots (static shape, zero weight) instead of the
                # reference's wrap-around duplicates
                group = group + [(group[0][0], False)] * (gbs - len(group))
            schedule.append((key, group))
        return schedule

    def batches_per_epoch(self, epoch: int = 0) -> int:
        return len(self.global_schedule(epoch))

    # -- loading ----------------------------------------------------------------
    def host_slice(self, group):
        """This process's share of one global launch: the
        ``process_index``-th of ``process_count`` equal parts (every
        launch size is a multiple of ``process_count``: the quantum
        contract)."""
        sub = len(group) // self.process_count
        lo = self.process_index * sub
        return group[lo:lo + sub]

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """Yield this process's slice of each batch of the epoch's
        schedule, in order.  Each item's RNG (the flip) is keyed on (seed,
        epoch, index), so the output is the same with or without loader
        threads.  With ``num_workers > 0`` the items of a sliding window
        of upcoming batches load on the thread pool."""
        schedule = [(key, self.host_slice(group))
                    for key, group in self.global_schedule(epoch)]
        pool = self._ensure_pool()
        if pool is None:
            for key, group in schedule:
                items = [self._load_item(int(idx), epoch) for idx, _ in group]
                yield pad_batch(items, key, len(group), [v for _, v in group],
                                self.ds)
            return
        # enough batches in flight to keep every worker busy at batch 1,
        # bounded so at most `window` decoded batches wait in host memory
        window = max(2, -(-self.num_workers // max(self.batch_size, 1)) + 1)
        inflight = collections.deque()
        i = 0
        try:
            while i < len(schedule) or inflight:
                while i < len(schedule) and len(inflight) < window:
                    key, group = schedule[i]
                    futs = [pool.submit(self._load_item, int(idx), epoch)
                            for idx, _ in group]
                    inflight.append((key, group, futs))
                    i += 1
                key, group, futs = inflight.popleft()
                items = [f.result() for f in futs]
                yield pad_batch(items, key, len(group), [v for _, v in group],
                                self.ds)
        finally:
            # an abandoned epoch must not leave its decode tasks queued
            for _, _, futs in inflight:
                for f in futs:
                    f.cancel()

    def close(self) -> None:
        """Shut the loader threads down (idempotent; the next epoch()
        starts them again)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "ShardedBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ensure_pool(self) -> Optional[ThreadPoolExecutor]:
        if self.num_workers > 0 and self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="can_tpu_torch_loader")
        return self._pool

    def _load_item(self, idx: int, epoch: int):
        rng = np.random.default_rng((self.seed, epoch, idx))
        return self.dataset.__getitem__(idx, rng=rng)
