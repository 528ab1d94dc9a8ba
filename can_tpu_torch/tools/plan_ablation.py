"""Plan-space ablation of the batch planner: cost mode against legacy
(counterpart of ``tools/plan_ablation.py`` and the sweep it runs,
``bench_suite.bench_plan_space``)::

    python -m can_tpu_torch.tools.plan_ablation --out /tmp/plan_ablation.json

For every (batch, plan mode, launch price) the full epoch plan of a
seeded ShanghaiTech-like shape histogram (40% at 768x1024, the rest
uniform in 384..1024 on each axis, the same draws as the JAX sweep's)
is built under the card's per-launch memory cap (``cli/common.py``'s
bf16 BN-model footprint with remat, at ``--memory-gib``), and the
planner's predicted cost is reported beside the cost re-derived from the
emitted schedule, with the padding and schedule overheads, programs,
launches and the plan's build time (median of ``--repeats``, rounds
interleaved across candidates).  Host code, deterministic but for the
build times; the JSON has the JAX tool's keys and goes only where
``--out`` says.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Tuple

import numpy as np

# the H100 80GB HBM3's total memory as the card reports it (PERF.md)
H100_MEMORY_GIB = 79.18


class VarResShapes:
    """Shapes only (the planner reads nothing else) of a ShanghaiTech-like
    resolution mix: 40% at ``dominant``, the rest uniform, /8-snapped."""

    def __init__(self, n: int, seed: int = 0, lo: int = 384, hi: int = 1024,
                 dominant: Tuple[int, int] = (768, 1024)):
        rng = np.random.default_rng(seed)
        self.sizes: List[Tuple[int, int]] = []
        for _ in range(n):
            if rng.uniform() < 0.4:
                h, w = dominant
            else:
                h = int(rng.integers(lo, hi + 1))
                w = int(rng.integers(lo, hi + 1))
            self.sizes.append(((h // 8) * 8, (w // 8) * 8))

    def __len__(self):
        return len(self.sizes)

    def snapped_shape(self, i):
        return self.sizes[i]


def sweep(*, n_images: int = 64, batches=(8, 16), repeats: int = 5,
          max_buckets: int = 24, launch_costs_mpx=None,
          memory_gib: float = H100_MEMORY_GIB) -> list:
    """One record per (batch, mode, launch price), the JAX sweep's keys."""
    from can_tpu_torch.cli.common import DEFAULT_LAUNCH_COST_MPX, max_launch_pixels
    from can_tpu_torch.data import ShardedBatcher

    if launch_costs_mpx is None:
        launch_costs_mpx = (2.0, 0.5, DEFAULT_LAUNCH_COST_MPX)
    cap = max_launch_pixels(bf16=True, remat=True,
                            hbm_bytes=int(memory_gib * 2 ** 30))
    ds = VarResShapes(n_images)
    combos = [{"batch": b, "mode": mode, "mpx": mpx, "times": []}
              for b in batches for mode in ("legacy", "cost")
              for mpx in launch_costs_mpx]

    def build(c):
        t0 = time.perf_counter()
        sb = ShardedBatcher(ds, c["batch"], shuffle=True, seed=0,
                            pad_multiple="auto", max_buckets=max_buckets,
                            remnant_sizes=True, batch_quantum=1,
                            launch_cost_px=c["mpx"] * 1e6,
                            max_launch_px=cap, plan_mode=c["mode"])
        sb.planner_stats(1)  # the plan and the schedule walk
        return sb, time.perf_counter() - t0

    for rep in range(repeats):
        for c in combos:
            sb, dt = build(c)
            c["times"].append(dt)
            c["batcher"] = sb
    records = []
    for c in combos:
        st = c["batcher"].planner_stats(1)
        times = sorted(c["times"])
        med = float(np.median(times))
        predicted = st.get("plan_cost_px", st["realized_cost_px"])
        name = (f"plan_space_varres_b{c['batch']}_{c['mode']}"
                f"_L{str(c['mpx']).replace('.', 'p')}")
        records.append({
            "metric": name, "value": st["schedule_overhead"],
            "unit": "overhead_frac", "plan_mode": c["mode"],
            "launch_cost_mpx": c["mpx"], "batch": c["batch"],
            "max_buckets": max_buckets, "max_launch_mpx": round(cap / 1e6, 3),
            "padding_overhead": st["padding_overhead"],
            "programs": st["program_count"],
            "launches": st["batches_per_epoch"],
            "lowered_launches": st.get("lowered_launches"),
            "menu_sizes": st.get("menu_sizes"),
            "predicted_cost_mpx": round(predicted / 1e6, 3),
            "realized_cost_mpx": round(st["realized_cost_px"] / 1e6, 3),
            "predicted_eq_realized": bool(
                abs(predicted - st["realized_cost_px"]) < 1.0),
            "plan_s": round(med, 4), "plan_s_min": round(times[0], 4),
            "plan_s_max": round(times[-1], 4),
            "spread_pct": round(100 * (times[-1] - times[0]) / max(med, 1e-9), 1),
            "buckets": c["batcher"].describe_buckets(),
        })
    return records


def headline(records: list) -> dict:
    """b16: legacy at the 2.0 Mpx launch price against cost mode at the
    same price (the search alone) and at the card's price."""
    from can_tpu_torch.cli.common import DEFAULT_LAUNCH_COST_MPX

    def find(mode, mpx):
        for r in records:
            if (r["batch"] == 16 and r["plan_mode"] == mode
                    and r["launch_cost_mpx"] == mpx):
                return r
        raise SystemExit(f"sweep missing b16 {mode} L={mpx}")

    def row(r, note=None):
        out = {"schedule_overhead": r["value"],
               "padding_overhead": r["padding_overhead"],
               "programs": r["programs"]}
        if note:
            out["note"] = note
        return out

    baseline = find("legacy", 2.0)
    return {
        "config": f"b16 varres, max_buckets=24, the card's memory cap "
                  f"({baseline['max_launch_mpx']} Mpx/launch)",
        "baseline_legacy_tunnel_pricing": row(baseline),
        "cost_planner_same_pricing": row(
            find("cost", 2.0), "the search alone: boundary placement, exact "
            "menus and packing, launch price held at 2.0 Mpx"),
        "cost_planner_device_pricing": row(
            find("cost", DEFAULT_LAUNCH_COST_MPX), "the card's measured launch "
            "price (cli/common.py DEFAULT_LAUNCH_COST_MPX)"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="batch planner: cost against legacy")
    p.add_argument("--out", required=True, help="where to write the JSON")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--images", type=int, default=64,
                   help="items in the seeded shape histogram")
    p.add_argument("--memory-gib", type=float, default=H100_MEMORY_GIB,
                   help="the card's memory for the per-launch cap")
    p.add_argument("--round", type=int, default=6, dest="round_no")
    args = p.parse_args(argv)
    records = sweep(n_images=args.images, repeats=args.repeats,
                    memory_gib=args.memory_gib)
    doc = {"round": args.round_no,
           "note": "Simulated plan-space sweep (host only, deterministic but "
                   "for plan_s): the batch planner's schedule of a seeded "
                   "varres histogram under the card's per-launch memory cap, "
                   "legacy against cost mode across launch prices.",
           "headline": headline(records), "results": records}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"# wrote {args.out}")
    print(json.dumps(doc["headline"], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
