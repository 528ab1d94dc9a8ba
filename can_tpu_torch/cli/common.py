"""Shared CLI plumbing: dataset roots, the prepared-store flag, the world
and each replica's batch, the spatial shards' padding and step caches, the
planner's memory cap and launch price (counterpart of
``can_tpu/cli/common.py:15-140, 359-564, 613-645``).

The planner prices launches in pixels.  Its two device numbers are the
card's own, measured by ``chip_smoke.py``'s ``[planner]`` phase on an
NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md): the peak
memory of a train step, fitted as a fixed part plus bytes per pixel of
the batch (``batch * H * W``) for the BN and the plain model, with and
without remat, and the train step's rate in megapixels per second.  The
same footprints decide per launch whether to rematerialise
(``make_remat_policy``).  None of the JAX package's TPU constants is
used.  Under several processes every input of the plan (the memory cap,
the launch price) is agreed across processes before a batcher is built:
the lockstep schedule needs the same plan on every rank.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from can_tpu_torch.parallel import (
    agree_min_value,
    make_mesh,
    process_count,
    reduce_value,
)

# Peak memory allocated by one train step (forward, backward, SGD update;
# weights, momentum and gradients included) = fixed + per_px * batch * H *
# W, by (model, remat) and dtype: (fixed bytes, bytes per pixel), each
# fitted from (4, 576, 768) and (8, 576, 768) steps under the train CLI's
# deterministic settings and within 0.1% at (6, 768, 1024);
# chip_smoke.py [planner], NVIDIA H100 80GB HBM3, 700.00 W.  At 0.92 of
# its 79.18 GiB the BN model fits 14.8 Mpx f32 / 18.9 bf16 per launch
# without remat, 24.2 / 34.9 with.  The plain model's peak is in the
# first stage's backward either way, so remat leaves its f32 footprint
# as it is.
TRAIN_FOOTPRINT = {
    ("bn", False): {"f32": (291740160.0, 5253.6), "bf16": (310818816.0, 4132.2)},
    ("bn", True): {"f32": (317840384.0, 3216.9), "bf16": (318743040.0, 2230.4)},
    ("plain", False): {"f32": (323441664.0, 2443.8), "bf16": (324374528.0, 1483.8)},
    ("plain", True): {"f32": (319509504.0, 2444.3), "bf16": (320798208.0, 785.8)},
}
# The BN-model train step's rate at (8, 576, 768), bf16, in Mpx/s (same
# run; f32: 10.04): converts a launch's time into the planner's pixels.
MODEL_MPX_PER_S = 32.21
# One launch's cost in Mpx: ``measure_launch_cost_mpx`` on that card
# (0.0268 ms, the median synchronised tiny op) times MODEL_MPX_PER_S.
DEFAULT_LAUNCH_COST_MPX = 0.00086


def parse_pad_multiple(value):
    """``--pad-multiple``: "auto" (the bucket ladder), none/exact/0 (exact
    snapped shapes) or an integer multiple."""
    if value is None:
        return None
    s = str(value).strip().lower()
    if s == "auto":
        return "auto"
    if s in ("exact", "none", "0"):
        return None
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--pad-multiple takes 'auto', 'exact'/'none' or an integer, "
            f"got {value!r}") from None


def resolve_sp_padding(pad_multiple, sp: int):
    """Bucket constraints under spatial parallelism, shared by both CLIs
    (``resolve_sp_padding`` of can_tpu/cli/common.py:33): returns
    ``(pad_multiple, min_pad_multiple, min_bucket_h)``.  Only the sharded
    H axis carries sp constraints; W keeps the cheaper /8 snap:

    * bucket H must be a multiple of 8*sp so max-pool windows never
      straddle shard boundaries (``parallel.spatial._check_spatial_shapes``);
    * bucket H must be >= 16*sp so each shard owns >= 2 feature rows (the
      dilated-conv halo): short images are padded up instead of failing
      the step mid-run.
    """
    if sp <= 1:
        return pad_multiple, None, None
    need = 8 * sp
    if pad_multiple is None:  # exact shapes can't guarantee divisibility
        pad_multiple = (need, 8)
    elif isinstance(pad_multiple, int):
        mh = pad_multiple if pad_multiple % need == 0 else (
            -(-pad_multiple // need) * need)
        pad_multiple = (mh, pad_multiple)
    return pad_multiple, (need, None), 16 * sp


def dataset_roots(data_root: str, split: str) -> Tuple[str, str]:
    """ShanghaiTech layout: <root>/<split>_data/images and .../ground_truth."""
    base = os.path.join(data_root, f"{split}_data")
    img, gt = os.path.join(base, "images"), os.path.join(base, "ground_truth")
    for p in (img, gt):
        if not os.path.isdir(p):
            raise FileNotFoundError(
                f"expected dataset directory {p} (ShanghaiTech layout: "
                f"<data_root>/{split}_data/{{images,ground_truth}})")
    return img, gt


def resolve_split_roots(split: str, image_root: str, gt_root: str,
                        data_root: str, *,
                        flag_stem: Optional[str] = None) -> Tuple[str, str]:
    """Explicit roots of a split win over ``--data_root``'s ShanghaiTech
    layout; give both roots of the split, or a data root.  ``flag_stem``
    prefixes the caller's flag names in errors ("train-"/"test-" in the
    train CLI, "" in the eval CLI).  Pure argument and isdir checks."""
    stem = f"{split}-" if flag_stem is None else flag_stem
    if image_root or gt_root:
        if not (image_root and gt_root):
            raise SystemExit(f"give both --{stem}image-root and "
                             f"--{stem}gt-root (or neither, with --data_root)")
        for p in (image_root, gt_root):
            if not os.path.isdir(p):
                raise SystemExit(f"no such dataset directory: {p}")
        return image_root, gt_root
    if not data_root:
        raise SystemExit(f"need --data_root or --{stem}image-root/"
                         f"--{stem}gt-root")
    try:
        return dataset_roots(data_root, split)
    except FileNotFoundError as e:
        raise SystemExit(f"no such dataset directory: {e}") from None


def split_prepared_spec(spec: str, split: str) -> str:
    """``--prepared-root`` -> ``CrowdDataset(prepared=...)`` of one split:
    'auto'/'off' pass through; a path is a root of per-split stores
    (``<path>/train``, ``<path>/test``)."""
    if spec in ("auto", "off"):
        return spec
    return os.path.join(spec, split)


def build_mesh_and_batch(batch_size: int, sp: int = 1) -> Tuple:
    """The world as a (dp, sp) mesh with ``dp = processes / sp``, and each
    replica's batch: ``(mesh, per_replica_batch, dp)``.  ``batch_size`` is
    per data-parallel replica (the reference's per-GPU batch,
    train.py:177); the global batch is ``batch_size * dp``.  The ``sp``
    ranks of a replica load the same slice of each launch (the batcher's
    ``process_index = mesh.d`` of ``process_count = dp``) and each keeps
    its rows of it (``parallel.make_global_batch(..., spatial=True)``).
    Collective under ``sp > 1`` (``parallel.make_mesh``)."""
    nproc = process_count()
    if sp < 1 or nproc % sp:
        raise ValueError(f"--sp {sp} does not divide the process count {nproc}")
    mesh = make_mesh(dp=nproc // sp, sp=sp)
    return mesh, batch_size, mesh.dp


def agreed_device_memory_bytes(device) -> Optional[int]:
    """``device_memory_bytes`` agreed across processes (the minimum), for
    what feeds the lockstep schedule: every process must derive the same
    launch cap and remat decisions.  A process with no ceiling (the CPU)
    makes it None everywhere.  Collective: call it on every process."""
    mem = device_memory_bytes(device)
    if process_count() < 2:
        return mem
    agreed = float(agree_min_value(np.float64(-1.0 if mem is None else mem)))
    return None if agreed < 0 else int(agreed)


def device_memory_bytes(device) -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``), or None on
    the CPU, where no ceiling exists."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


_DETECT = object()  # "read the card" as against an explicit None


def train_footprint(*, bf16: bool, batch_norm: bool = True,
                    remat: bool = False) -> Tuple[float, float]:
    """``(fixed bytes, bytes per pixel)`` of one train step's peak memory
    on the card (``TRAIN_FOOTPRINT``)."""
    return TRAIN_FOOTPRINT[("bn" if batch_norm else "plain", bool(remat))][
        "bf16" if bf16 else "f32"]


def max_launch_pixels(*, bf16: bool, device=None, ceiling_frac: float = 0.92,
                      hbm_bytes=_DETECT, batch_norm: bool = True,
                      remat: bool = False, shards: int = 1) -> Optional[float]:
    """Per-launch pixel budget (global batch * H * W) for the planner's
    memory cap: ``(ceiling_frac * memory - fixed) / bytes_per_px`` of the
    card's fitted train-step footprint for this model, with remat or
    without (a launch the cap admits only with remat gets it from
    ``make_remat_policy``), times ``shards``: a launch is split across
    ``shards`` processes (dp), each holding its slice on its own card.
    None on the CPU (a cap there would be fiction and change the
    schedule).  ``hbm_bytes`` overrides the card's total memory (tests
    pin it; multi-process CLIs pass ``agreed_device_memory_bytes``)."""
    mem = device_memory_bytes(device) if hbm_bytes is _DETECT else hbm_bytes
    if mem is None:
        return None
    fixed, per_px = train_footprint(bf16=bf16, batch_norm=batch_norm, remat=remat)
    return (ceiling_frac * mem - fixed) / per_px * shards


def make_remat_policy(flag: str, *, global_batch: int, bf16: bool, device=None,
                      batch_norm: bool = True, budget_frac: float = 0.80,
                      hbm_bytes=_DETECT, announce: bool = False,
                      shards: int = 1) -> Callable:
    """Per-launch remat decision (``make_remat_policy`` of
    can_tpu/cli/common.py:413): ``policy(hw, batch=None) -> bool``, batch
    defaulting to ``global_batch``.

    ``"on"`` / ``"off"`` decide for every launch.  ``"auto"``: remat is on
    for a launch whose footprint without remat, by the card's fitted
    constants (``train_footprint``), exceeds ``budget_frac`` of the card's
    memory; off on the CPU, where no ceiling exists.  ``batch`` is the
    global launch, split across ``shards`` processes: each card holds
    ``batch / shards`` of it.  ``announce`` prints a ``[remat]`` line the
    first time a launch shape turns it on.
    """
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"remat is 'auto', 'on' or 'off', got {flag!r}")
    if flag != "auto":
        return lambda hw, batch=None: flag == "on"
    mem = device_memory_bytes(device) if hbm_bytes is _DETECT else hbm_bytes
    if mem is None:
        return lambda hw, batch=None: False
    fixed, per_px = train_footprint(bf16=bf16, batch_norm=batch_norm)
    budget = budget_frac * mem
    said = set()

    def policy(hw, batch=None):
        b = batch or global_batch
        need = fixed + per_px * b * hw[0] * hw[1] / shards
        on = need > budget
        if on and announce and (b, tuple(hw)) not in said:
            said.add((b, tuple(hw)))
            print(f"[remat] launch {hw[0]}x{hw[1]} (batch {b}): footprint "
                  f"{need / 2 ** 30:.2f} GiB without remat exceeds "
                  f"{budget_frac:.0%} of {mem / 2 ** 30:.2f} GiB -> "
                  f"rematerialising this launch")
        return on

    return policy


class SpatialStepCache:
    """Per-key cache of spatial steps (``SpatialStepCache`` of
    can_tpu/cli/common.py:613): each H x W bucket shape (and, for the
    train step, remat flag) gets its own step, whose ``LocalOps`` hold
    the shape's pooling extent and context rows."""

    def __init__(self, factory: Callable):
        self._factory = factory
        self._steps: Dict[tuple, Callable] = {}

    def __call__(self, key):
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = self._factory(key)
        return step


def block_image_hw(batch, sp: int) -> Tuple[int, int]:
    """The whole image's (H, W) of a rank's H-block."""
    return batch["image"].shape[1] * sp, batch["image"].shape[2]


def make_cached_sp_eval_step(mesh, *, compute_dtype=None) -> Callable:
    """Bucket-shape-cached spatial eval step, shared by both CLIs
    (``make_cached_sp_eval_step`` of can_tpu/cli/common.py:628):
    ``eval_step(model, block) -> global metric sums``."""
    from can_tpu_torch.parallel.spatial import make_sp_eval_step

    cache = SpatialStepCache(
        lambda hw: make_sp_eval_step(mesh, hw, compute_dtype=compute_dtype))

    def eval_step(model, batch):
        return cache(block_image_hw(batch, mesh.sp))(model, batch)

    return eval_step


def make_cached_sp_train_step(model, mesh, *, policy: Callable,
                              compute_dtype=None, bn_ops=None) -> Callable:
    """The train CLI's spatial step: one ``make_sp_train_step`` per
    (bucket shape, remat), remat decided per launch by ``policy(hw,
    batch=global launch)`` (``make_remat_policy`` with ``shards = dp *
    sp``)."""
    from can_tpu_torch.parallel.spatial import make_sp_train_step

    cache = SpatialStepCache(lambda key: make_sp_train_step(
        model, mesh, key[0], compute_dtype=compute_dtype, bn_ops=bn_ops,
        remat=key[1]))

    def train_step(state, batch):
        hw = block_image_hw(batch, mesh.sp)
        remat = bool(policy(hw, batch=batch["image"].shape[0] * mesh.dp))
        return cache((hw, remat))(state, batch)

    return train_step


def measure_launch_cost_mpx(device, *, probes: int = 30,
                            device_rate_mpx_s: float = MODEL_MPX_PER_S) -> float:
    """One launch's fixed cost in Mpx equivalents: the median time of a
    tiny op with ``torch.cuda.synchronize()`` after each probe (each probe
    pays the launch and its completion, with next to no work), times the
    device's training rate."""
    device = torch.device(device)
    x = torch.zeros((), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    x + 1.0  # settle
    sync()
    times = []
    for _ in range(probes):
        t0 = time.perf_counter()
        x + 1.0
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * device_rate_mpx_s


def parse_launch_cost(value):
    """argparse type for ``--launch-cost-mpx``: 'auto' or a number."""
    s = str(value).strip().lower()
    if s == "auto":
        return "auto"
    try:
        return float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or a number, got {value!r}") from None


def resolve_launch_cost_px(spec, device, *, announce: bool = False) -> float:
    """``--launch-cost-mpx`` -> planner pixels: 'auto' measures this
    device (``measure_launch_cost_mpx``) and, under several processes,
    takes the mean across them, so every process prices launches alike
    (collective then: call it on every process); a number is used as
    given."""
    if spec == "auto":
        mpx = measure_launch_cost_mpx(device)
        if process_count() > 1:
            mpx = float(reduce_value(np.float64(mpx), average=True))
        if announce:
            print(f"[planner] measured launch overhead ~"
                  f"{mpx / MODEL_MPX_PER_S * 1e3:.3f} ms/launch -> launch "
                  f"cost {mpx:.4f} Mpx"
                  + (" (mean across processes)" if process_count() > 1 else ""))
        return mpx * 1e6
    return float(spec) * 1e6


def resolve_num_workers(value: Optional[int]) -> int:
    """``--num-workers``: None -> min(8, CPUs); else at least 0."""
    if value is not None:
        return max(0, int(value))
    return min(8, os.cpu_count() or 1)


def print_data_line(tag: str, batcher, remat_policy: Optional[Callable] = None) -> None:
    """The ``[data]`` line of one batcher: buckets, shapes, programs, the
    plan mode, the padding and schedule overheads of epoch 0 and, given a
    remat policy, its decision per launch shape (batch x H x W)."""
    remat = ""
    if remat_policy is not None:
        launches = sorted({(len(g), key) for key, g in batcher.global_schedule(0)})
        on = [f"{b}x{h}x{w}" for b, (h, w) in launches
              if remat_policy((h, w), batch=b)]
        remat = (f", remat on for {len(on)} of {len(launches)} launch shapes"
                 + (f" ({', '.join(on)})" if on else ""))
    print(f"[data] {tag}: buckets={batcher.describe_buckets()} -> "
          f"{batcher.distinct_shapes(0)} distinct batch shapes, "
          f"{batcher.program_count(0)} (shape x size) programs, "
          f"{batcher.batches_per_epoch(0)} batches (plan={batcher.plan_mode}, "
          f"padding overhead {batcher.padding_overhead():.1%}, schedule "
          f"overhead {batcher.schedule_overhead(0):.1%}{remat})", flush=True)
