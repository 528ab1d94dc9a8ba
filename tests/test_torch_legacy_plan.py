"""The port's legacy batch planner against the JAX package's
(``plan_mode="legacy"``: the largest fitting full size, the power-of-two
remnant menu, pairwise merges and drops of the smallest size, ladders
scored by padded area), as tests/test_torch_planner.py holds cost mode:
menus, plans, whole schedules, bucket ladders and ``planner_stats`` equal
exactly on seeded and hypothesis-drawn histograms, with and without the
memory cap.  Then ``tools/plan_ablation``'s JSON against the JAX tool's:
the same keys on one seeded histogram.
"""

import importlib.util
import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from can_tpu.data.batching import ShardedBatcher as JaxShardedBatcher
from can_tpu.data.planner import GlobalPlanner as JaxGlobalPlanner
from can_tpu.data.planner import PlanCostModel as JaxPlanCostModel
from can_tpu.data.planner import remnant_menu as jax_remnant_menu
from can_tpu_torch.data import ShardedBatcher
from can_tpu_torch.data.planner import GlobalPlanner, PlanCostModel, remnant_menu
from can_tpu_torch.tools import plan_ablation
from test_torch_planner import _histogram, _ShapeDs, assert_same_batcher, varres_shapes


def both(shapes, bs, **kw):
    common = dict(shuffle=True, seed=0, pad_multiple="auto", remnant_sizes=True,
                  plan_mode="legacy")
    common.update(kw)
    return (ShardedBatcher(_ShapeDs(shapes), bs, **common),
            JaxShardedBatcher(_ShapeDs(shapes), bs, **common))


@pytest.mark.parametrize("gbs,quantum", [(16, 1), (16, 4), (8, 2), (12, 3), (1, 1), (24, 5)])
def test_legacy_menu_is_jax_legacy_menu(gbs, quantum):
    assert remnant_menu(gbs, quantum, mode="legacy") == \
        jax_remnant_menu(gbs, quantum, mode="legacy")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [None, 6e6])
def test_legacy_global_plan_matches_jax(seed, cap):
    counts = _histogram(seed)
    for gbs, quantum, lc, budget in ((16, 1, 2e6, 24), (8, 2, 5e4, 8),
                                     (16, 4, 0.0, 6), (16, 1, 5e4, 3)):
        kw = dict(launch_cost_px=lc, max_launch_px=cap)
        plan = GlobalPlanner(PlanCostModel(menu=remnant_menu(gbs, quantum, mode="legacy"),
                                           **kw),
                             max_buckets=budget, mode="legacy").plan_with_fallback(counts)
        want = JaxGlobalPlanner(
            JaxPlanCostModel(menu=jax_remnant_menu(gbs, quantum, mode="legacy"), **kw),
            max_buckets=budget, mode="legacy").plan_with_fallback(counts)
        assert tuple(plan) == tuple(want)
        assert (plan.lowered_cells, plan.lowered_launches) == \
            (want.lowered_cells, want.lowered_launches)


def test_unknown_modes_are_refused():
    with pytest.raises(ValueError, match="planner mode"):
        GlobalPlanner(PlanCostModel(menu=(4, 2, 1)), max_buckets=4, mode="greedy")
    with pytest.raises(ValueError, match="plan_mode"):
        ShardedBatcher(_ShapeDs([(64, 64)]), 2, plan_mode="greedy")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bs,quantum,budget,lc", [(8, 1, 8, 2e6), (16, 1, 24, 5e4),
                                                  (8, 2, 6, 0.0)])
def test_legacy_auto_schedule_matches_jax(seed, bs, quantum, budget, lc):
    port, ref = both(varres_shapes(60, seed), bs, max_buckets=budget,
                     batch_quantum=quantum, launch_cost_px=lc)
    assert port.bucket_ladder is not None
    assert_same_batcher(port, ref)
    assert port.planner_stats(0)["plan_mode"] == "legacy"


@pytest.mark.parametrize("cap", [4e6, 1.2e6])
def test_legacy_schedule_under_the_memory_cap_matches_jax(cap):
    shapes = varres_shapes(48, 5) + [(1024, 1024)] * 20
    port, ref = both(shapes, 16, max_buckets=12, launch_cost_px=5e4, max_launch_px=cap)
    assert_same_batcher(port, ref)
    for key, group in port.global_schedule(0):
        assert len(group) * key[0] * key[1] <= max(cap, key[0] * key[1])


@pytest.mark.parametrize("pad,remnant", [("auto", False), (None, True), (64, True)])
def test_legacy_other_bucket_modes_match_jax(pad, remnant):
    port, ref = both(varres_shapes(30, 9), 4, pad_multiple=pad,
                     remnant_sizes=remnant, max_buckets=6)
    assert_same_batcher(port, ref)


def test_legacy_and_cost_plans_differ_on_a_wild_set():
    """The mode reaches the plan: the same histogram plans differently."""
    shapes = varres_shapes(64, 3)
    legacy, _ = both(shapes, 16, max_buckets=24, launch_cost_px=2e6)
    cost = ShardedBatcher(_ShapeDs(shapes), 16, seed=0, pad_multiple="auto",
                          remnant_sizes=True, max_buckets=24, launch_cost_px=2e6)
    assert legacy.global_schedule(0) != cost.global_schedule(0)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(cells=st.lists(st.tuples(st.integers(20, 80), st.integers(20, 80),
                                st.integers(1, 12)), min_size=1, max_size=10),
       bs=st.sampled_from([1, 4, 8, 16]), budget=st.integers(1, 10),
       lc=st.sampled_from([0.0, 4e4, 2e6]),
       cap=st.sampled_from([None, 2e5, 1.5e6]))
def test_drawn_histograms_plan_like_jax_legacy(cells, bs, budget, lc, cap):
    shapes = [(h * 8, w * 8) for h, w, n in cells for _ in range(n)]
    port, ref = both(shapes, bs, max_buckets=budget, launch_cost_px=lc,
                     max_launch_px=cap)
    assert_same_batcher(port, ref, epochs=(0,))


def _keys(doc):
    """The nested key structure of a JSON document (lists by their first
    element)."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_keys(doc[0])] if doc else []
    return None


def test_plan_ablation_json_has_the_jax_tools_keys(tmp_path):
    """The port's tool and the JAX tool (its sweep and headline) on one
    seeded 24-item histogram: the same document keys, record keys and
    headline keys, and the same candidates."""
    out = tmp_path / "port.json"
    assert plan_ablation.main(["--out", str(out), "--repeats", "1",
                               "--images", "24"]) == 0
    port = json.loads(out.read_text())
    from bench_suite import bench_plan_space

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_plan_ablation", os.path.join(root, "tools", "plan_ablation.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    records = bench_plan_space(n_images=24, repeats=1)
    ref = {"round": 8, "note": "", "headline": jtool.headline(records),
           "results": records}
    assert _keys(port) == _keys(ref)
    assert [set(r) for r in port["results"]] == [set(r) for r in records]
    assert [(r["batch"], r["plan_mode"]) for r in port["results"]] == \
        [(r["batch"], r["plan_mode"]) for r in records]
    assert all(r["predicted_eq_realized"] for r in port["results"])
    # the same shape histogram as the JAX sweep's dataset
    from bench_suite import SynthVarResDataset

    assert plan_ablation.VarResShapes(24).sizes == SynthVarResDataset(24).sizes
