"""Shared CLI plumbing: dataset roots, the prepared-store flag, the
planner's memory cap and launch price (counterpart of
``can_tpu/cli/common.py:15-110, 381-564``, one GPU).

The planner prices launches in pixels.  Its two device numbers are the
card's own, measured by ``chip_smoke.py``'s ``[planner]`` phase on an
NVIDIA H100 80GB HBM3 at a 700.00 W power limit (PERF.md): the peak
memory of a BN-model train step, fitted as a fixed part plus bytes per
pixel of the batch (``batch * H * W``), and the train step's rate in
megapixels per second.  None of the JAX package's TPU constants is used.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Optional, Tuple

import torch

# Peak memory allocated by one BN-model train step (forward, backward,
# SGD update; weights, momentum and gradients included) = fixed + per_px
# * batch * H * W, fitted from (4, 576, 768) and (8, 576, 768) steps and
# within 0.1% at (6, 768, 1024); chip_smoke.py [planner], NVIDIA H100
# 80GB HBM3, 700.00 W.  At 0.92 of its 79.18 GiB: 14.8 Mpx f32, 18.8 bf16.
TRAIN_FIXED_BYTES = {"f32": 321012224.0, "bf16": 339554304.0}
TRAIN_BYTES_PER_PX = {"f32": 5254.7, "bf16": 4133.4}
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


def device_memory_bytes(device) -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``), or None on
    the CPU, where no ceiling exists."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


_DETECT = object()  # "read the card" as against an explicit None


def max_launch_pixels(*, bf16: bool, device=None, ceiling_frac: float = 0.92,
                      hbm_bytes=_DETECT) -> Optional[float]:
    """Per-launch pixel budget (batch * H * W) for the planner's memory
    cap: ``(ceiling_frac * memory - fixed) / bytes_per_px`` of the card's
    fitted train-step footprint.  None on the CPU (a cap there would be
    fiction and change the schedule).  ``hbm_bytes`` overrides the card's
    total memory (tests pin it)."""
    mem = device_memory_bytes(device) if hbm_bytes is _DETECT else hbm_bytes
    if mem is None:
        return None
    key = "bf16" if bf16 else "f32"
    return (ceiling_frac * mem - TRAIN_FIXED_BYTES[key]) / TRAIN_BYTES_PER_PX[key]


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
    device (``measure_launch_cost_mpx``), a number is used as given."""
    if spec == "auto":
        mpx = measure_launch_cost_mpx(device)
        if announce:
            print(f"[planner] measured launch overhead ~"
                  f"{mpx / MODEL_MPX_PER_S * 1e3:.3f} ms/launch -> launch "
                  f"cost {mpx:.4f} Mpx")
        return mpx * 1e6
    return float(spec) * 1e6


def resolve_num_workers(value: Optional[int]) -> int:
    """``--num-workers``: None -> min(8, CPUs); else at least 0."""
    if value is not None:
        return max(0, int(value))
    return min(8, os.cpu_count() or 1)


def print_data_line(tag: str, batcher) -> None:
    """The ``[data]`` line of one batcher: buckets, shapes, programs and
    the padding and schedule overheads of epoch 0."""
    print(f"[data] {tag}: buckets={batcher.describe_buckets()} -> "
          f"{batcher.distinct_shapes(0)} distinct batch shapes, "
          f"{batcher.program_count(0)} (shape x size) programs, "
          f"{batcher.batches_per_epoch(0)} batches (plan=cost, padding "
          f"overhead {batcher.padding_overhead():.1%}, schedule overhead "
          f"{batcher.schedule_overhead(0):.1%})", flush=True)
