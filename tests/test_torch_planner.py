"""The port's batch planner against the JAX package's cost mode:
``decompose``, ``remnant_menu``, ``GlobalPlanner.plan`` and the whole
``ShardedBatcher(pad_multiple="auto", remnant_sizes=True)`` schedule, on
seeded and hypothesis-drawn shape histograms with ``max_buckets``,
``launch_cost_px``, ``max_launch_px`` and ``batch_quantum`` pinned on
both sides.  Host code on both sides: plans and schedules are equal
exactly, not within a tolerance.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from can_tpu.data.batching import ShardedBatcher as JaxShardedBatcher
from can_tpu.data.planner import GlobalPlanner as JaxGlobalPlanner
from can_tpu.data.planner import PlanCostModel as JaxPlanCostModel
from can_tpu.data.planner import decompose as jax_decompose
from can_tpu.data.planner import remnant_menu as jax_remnant_menu
from can_tpu.data.planner import schedule_coverage as jax_coverage
from can_tpu_torch.data import ShardedBatcher
from can_tpu_torch.data.planner import (
    GlobalPlanner,
    PlanCostModel,
    decompose,
    remnant_menu,
    schedule_coverage,
)


class _ShapeDs:
    """A dataset of shapes only: the planner reads nothing else."""

    def __init__(self, shapes):
        self.shapes = list(shapes)

    def __len__(self):
        return len(self.shapes)

    def snapped_shape(self, i):
        return self.shapes[i]


def varres_shapes(n, seed):
    """A wild histogram: 40% one common shape, the rest uniform."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.uniform() < 0.4:
            h, w = 576, 768
        else:
            h, w = int(rng.integers(240, 1025)), int(rng.integers(240, 1025))
        out.append(((h // 8) * 8, (w // 8) * 8))
    return out


def both(shapes, bs, **kw):
    common = dict(shuffle=True, seed=0, pad_multiple="auto", remnant_sizes=True)
    common.update(kw)
    return (ShardedBatcher(_ShapeDs(shapes), bs, **common),
            JaxShardedBatcher(_ShapeDs(shapes), bs, plan_mode="cost", **common))


def assert_same_batcher(port, ref, epochs=(0, 1)):
    assert port.bucket_ladder == ref.bucket_ladder
    assert port.pad_multiple == ref.pad_multiple
    for e in epochs:
        sched = port.global_schedule(e)
        assert sched == ref.global_schedule(e)
        assert schedule_coverage(sched) == {i: 1 for i in range(len(port.dataset))}
    assert port.describe_buckets() == ref.describe_buckets()
    assert port.program_count(0) == ref.program_count(0)
    assert port.distinct_shapes(0) == ref.distinct_shapes(0)
    assert port.padding_overhead() == ref.padding_overhead()
    assert port.schedule_overhead(0) == ref.schedule_overhead(0)
    mine, theirs = port.planner_stats(0), ref.planner_stats(0)
    assert mine == theirs


# -- the pieces -------------------------------------------------------------
@pytest.mark.parametrize("gbs,quantum", [(16, 1), (16, 4), (8, 2), (12, 3), (1, 1)])
def test_remnant_menu_is_the_cost_menu(gbs, quantum):
    assert remnant_menu(gbs, quantum) == jax_remnant_menu(gbs, quantum, mode="cost")


@pytest.mark.parametrize("n", [0, 1, 5, 13, 31])
@pytest.mark.parametrize("launch_cost", [0.0, 3.0, 1e3])
def test_decompose_matches_jax(n, launch_cost):
    for menu in ((16, 8, 4, 2, 1), (12, 9, 6, 3), (8, 7, 5), (1,)):
        for area in (1.0, 0.5, 7.0):
            assert decompose(n, menu, area, launch_cost) == \
                jax_decompose(n, menu, area, launch_cost)


def test_cost_model_cap_split_matches_jax():
    """A cell whose full batch is over the cap prices every size that fits
    (the HBM-cap split); the quantum floor always survives."""
    key = (1024, 1024)
    for cap in (None, 3.5 * 2 ** 20, 8.2 * 2 ** 20, 0.5 * 2 ** 20):
        for lc in (0.0, 5e4, 2e6):
            m = PlanCostModel(menu=remnant_menu(16, 2), launch_cost_px=lc,
                              max_launch_px=cap)
            j = JaxPlanCostModel(menu=jax_remnant_menu(16, 2, mode="cost"),
                                 launch_cost_px=lc, max_launch_px=cap)
            assert m.fitting(key) == j.fitting(key)
            for count in (1, 7, 16, 37):
                assert m.full_size(key, count) == j.full_size(key, count)
                assert m.parts(key, count) == j.parts(key, count)
    capped = PlanCostModel(menu=remnant_menu(16, 1), max_launch_px=3.5 * 2 ** 20)
    assert max(capped.fitting(key)) == 3
    assert capped.full_size(key, 16) <= 3


def _histogram(seed):
    rng = np.random.default_rng(seed)
    keys = {(int(h) * 8, int(w) * 8)
            for h, w in rng.integers(30, 129, size=(int(rng.integers(2, 9)), 2))}
    return {k: int(rng.integers(1, 40)) for k in sorted(keys)}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [None, 6e6])
def test_global_planner_plan_matches_jax(seed, cap):
    counts = _histogram(seed)
    for gbs, quantum, lc, budget in ((16, 1, 2e6, 24), (8, 2, 5e4, 8),
                                     (16, 4, 0.0, 6)):
        kw = dict(launch_cost_px=lc, max_launch_px=cap)
        plan = GlobalPlanner(PlanCostModel(menu=remnant_menu(gbs, quantum), **kw),
                             max_buckets=budget).plan_with_fallback(counts)
        want = JaxGlobalPlanner(
            JaxPlanCostModel(menu=jax_remnant_menu(gbs, quantum, mode="cost"), **kw),
            max_buckets=budget, mode="cost").plan_with_fallback(counts)
        assert tuple(plan) == tuple(want)
        assert (plan.lowered_cells, plan.lowered_launches) == \
            (want.lowered_cells, want.lowered_launches)


# -- the whole schedule -----------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bs,quantum,budget,lc", [(8, 1, 8, 2e6), (16, 1, 24, 5e4),
                                                  (8, 2, 6, 0.0)])
def test_auto_remnant_schedule_matches_jax(seed, bs, quantum, budget, lc):
    port, ref = both(varres_shapes(60, seed), bs, max_buckets=budget,
                     batch_quantum=quantum, launch_cost_px=lc)
    assert port.bucket_ladder is not None  # wild enough for a ladder
    assert_same_batcher(port, ref)


@pytest.mark.parametrize("cap", [4e6, 1.2e6])
def test_auto_schedule_under_the_memory_cap_matches_jax(cap):
    """The HBM-cap split through the whole batcher: cells whose full batch
    does not fit run lowered, and no launch exceeds the cap unless even
    the quantum does."""
    shapes = varres_shapes(48, 5) + [(1024, 1024)] * 20
    port, ref = both(shapes, 16, max_buckets=12, launch_cost_px=5e4,
                     max_launch_px=cap)
    assert_same_batcher(port, ref)
    sched = port.global_schedule(0)
    big = [len(g) for k, g in sched if k == (1024, 1024)]
    assert big and max(big) < 16
    for key, group in sched:
        assert len(group) * key[0] * key[1] <= cap


@pytest.mark.parametrize("pad,remnant", [("auto", False), (None, True), (64, True),
                                         (None, False), (32, False)])
def test_other_bucket_modes_match_jax(pad, remnant):
    port, ref = both(varres_shapes(30, 9), 4, pad_multiple=pad,
                     remnant_sizes=remnant, max_buckets=6)
    assert_same_batcher(port, ref)


def test_auto_keeps_exact_shapes_within_the_budget():
    shapes = [(576, 768)] * 5 + [(480, 640)] * 3 + [(560, 744)] * 4
    port, ref = both(shapes, 4, max_buckets=8)
    assert port.bucket_ladder is None and port.pad_multiple is None
    assert port.describe_buckets() == "exact shapes"
    assert_same_batcher(port, ref)


def test_shuffle_off_and_quantum_checks():
    shapes = varres_shapes(20, 4)
    port, ref = both(shapes, 4, shuffle=False, max_buckets=4)
    assert_same_batcher(port, ref)
    with pytest.raises(ValueError, match="batch_quantum"):
        ShardedBatcher(_ShapeDs(shapes), 6, remnant_sizes=True, batch_quantum=4)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(cells=st.lists(st.tuples(st.integers(20, 80), st.integers(20, 80),
                                st.integers(1, 12)), min_size=1, max_size=10),
       bs=st.sampled_from([1, 4, 8]), budget=st.integers(1, 10),
       lc=st.sampled_from([0.0, 4e4, 2e6]),
       cap=st.sampled_from([None, 2e5, 1.5e6]))
def test_drawn_histograms_plan_like_jax(cells, bs, budget, lc, cap):
    shapes = [(h * 8, w * 8) for h, w, n in cells for _ in range(n)]
    port, ref = both(shapes, bs, max_buckets=budget, launch_cost_px=lc,
                     max_launch_px=cap)
    assert_same_batcher(port, ref, epochs=(0,))
    assert jax_coverage(port.global_schedule(0)) == \
        schedule_coverage(ref.global_schedule(0))


def test_predicted_plan_equals_the_realised_schedule():
    port, _ = both(varres_shapes(64, 3), 16, max_buckets=24, launch_cost_px=5e4)
    stats = port.planner_stats(0)
    assert stats["plan_scheduled_px"] == stats["realized_px"]
    assert stats["plan_launches"] == stats["batches_per_epoch"]
    assert stats["plan_programs"] == stats["program_count"]
