"""can_tpu_torch.sched against can_tpu.sched on the CPU: menus, covers,
flush deadlines under scripted arrivals, dispatch picks, size
normalisation and prefetch depths must be EXACTLY equal (pure Python on
both sides, the same tie rules and float operations), and the port's
micro-batcher launches exactly the core's parts.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import can_tpu.sched as jsched
import can_tpu_torch.sched as tsched
from can_tpu.data.batching import ShardedBatcher as JaxShardedBatcher
from can_tpu_torch.data import ShardedBatcher
from can_tpu_torch.sched import core as tcore
from can_tpu_torch.serve import BoundedRequestQueue, MicroBatcher, ServeRequest
from tests.test_torch_planner import _ShapeDs, varres_shapes


def test_constants_equal():
    for name in ("DEFAULT_MENU_BUDGET", "DEFAULT_LAUNCH_COST_SLOTS",
                 "MIN_GAP_INTERVALS", "GAP_EWMA_ALPHA",
                 "DEFAULT_WAIT_GAP_FACTOR"):
        assert getattr(tcore, name) == getattr(jsched.core, name), name
    assert set(jsched.__all__) <= set(tsched.__all__)


@pytest.mark.parametrize("budget", [1, 2, 3, 4])
def test_select_menu_sweep(budget):
    for max_batch in range(1, 33):
        assert (tsched.select_menu(max_batch, budget=budget)
                == jsched.select_menu(max_batch, budget=budget)), max_batch
        assert (tsched.default_serve_menu(max_batch, budget=budget)
                == jsched.default_serve_menu(max_batch, budget=budget))


@pytest.mark.parametrize("lc", [0.0, 0.25, 1.0, 7.5])
def test_select_menu_weights_and_launch_cost(lc):
    rng = np.random.default_rng(int(lc * 10))
    for max_batch in (4, 8, 12):
        w = rng.random(max_batch).tolist()
        for budget in (2, 3):
            assert (tsched.select_menu(max_batch, budget=budget,
                                       launch_cost_slots=lc, weights=w)
                    == jsched.select_menu(max_batch, budget=budget,
                                          launch_cost_slots=lc, weights=w))


def test_select_menu_refusals_match():
    for kw in ({"max_batch": 0}, {"max_batch": 4, "budget": 0},
               {"max_batch": 4, "weights": [1.0] * 3}):
        with pytest.raises(ValueError) as a:
            tsched.select_menu(**kw)
        with pytest.raises(ValueError) as b:
            jsched.select_menu(**kw)
        assert str(a.value) == str(b.value)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 40), menu=st.sets(st.integers(1, 12), min_size=1,
                                          max_size=4),
       lc=st.sampled_from([0.0, 0.25, 0.5, 3.0]))
def test_cover_cost_and_costs_match(n, menu, lc):
    menu = tuple(sorted(menu, reverse=True))
    assert tsched.cover_cost(n, menu, lc) == jsched.cover_cost(n, menu, lc)
    assert (tcore._cover_costs(n, menu, lc)
            == jsched.core._cover_costs(n, menu, lc))
    for p, r in ((1.0, 1.0), (1.0, 1.0 + 1e-7), (None, 3.0), (2.0, 2.5)):
        assert tsched.costs_match(p, r) == jsched.core.costs_match(p, r)


@pytest.mark.parametrize("max_batch,budget", [(1, 3), (4, 2), (8, 3),
                                              (8, 1), (16, 4), (5, 3)])
def test_serve_sched_sizes(max_batch, budget):
    t = tsched.ServeSched(max_batch, max_wait_s=0.005, menu_budget=budget)
    j = jsched.ServeSched(max_batch, max_wait_s=0.005, menu_budget=budget)
    assert t.menu == j.menu
    for n in range(0, 3 * max_batch + 2):
        assert t.parts_for(n) == j.parts_for(n)
        assert t.cover_one(n) == j.cover_one(n)
        assert t.coalesce_gain(n) == j.coalesce_gain(n)
        for area in (4096.0, 786432.0):
            assert t.predicted_cost_px(area, n) == j.predicted_cost_px(area, n)
            assert t.realized_cost_px(area, n) == j.realized_cost_px(area, n)


def test_serve_sched_explicit_menu_and_refusal():
    t = tsched.ServeSched(8, max_wait_s=0.01, menu=(2, 8, 5))
    j = jsched.ServeSched(8, max_wait_s=0.01, menu=(2, 8, 5))
    assert t.menu == j.menu == (8, 5, 2)
    with pytest.raises(ValueError) as a:
        tsched.ServeSched(8, max_wait_s=0.01, menu=(4, 2))
    with pytest.raises(ValueError) as b:
        jsched.ServeSched(8, max_wait_s=0.01, menu=(4, 2))
    assert str(a.value) == str(b.value)


@settings(max_examples=80, deadline=None)
@given(gaps=st.lists(st.floats(0.0, 0.05, allow_nan=False), min_size=1,
                     max_size=14),
       n=st.integers(1, 9), priced=st.booleans(),
       slack=st.one_of(st.none(), st.floats(0.0, 0.02, allow_nan=False)),
       factor=st.sampled_from([1.0, 2.0, 3.5]))
def test_flush_at_under_scripted_arrivals(gaps, n, priced, slack, factor):
    """The same arrival script through both cores: every estimate and
    every priced deadline equal, at every step of the script."""
    kw = dict(max_wait_s=0.01, priced_flush=priced, wait_gap_factor=factor)
    t = tsched.ServeSched(8, **kw)
    j = jsched.ServeSched(8, **kw)
    key = (64, 64, "float32")
    now = 0.0
    t0 = None
    for g in gaps:
        now += g
        t0 = now if t0 is None else t0
        t.observe_arrival(key, now)
        j.observe_arrival(key, now)
        assert t.expected_gap(key) == j.expected_gap(key)
        deadline = None if slack is None else now + slack
        for probe in (now, now + 0.001):
            assert (t.flush_at(key, n, t0, now, probe, deadline)
                    == j.flush_at(key, n, t0, now, probe, deadline))
    assert t.expected_gap(("other",)) is None is j.expected_gap(("other",))


def test_normalize_sizes():
    for mb, sizes in ((8, None), (8, (1, 8, 3, 3)), (4, [4]), (2, (2, 1, 2))):
        assert tsched.normalize_sizes(mb, sizes) == jsched.normalize_sizes(mb, sizes)


class Item:
    def __init__(self, seq, t_enqueue, cost_px, min_deadline=None,
                 redispatches=0, pin=None):
        self.seq, self.t_enqueue, self.cost_px = seq, t_enqueue, cost_px
        self.min_deadline, self.redispatches = min_deadline, redispatches
        if pin is not None:
            self.pin = pin


@pytest.mark.parametrize("seed", range(6))
def test_pick_work_on_the_same_items(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        items = []
        for i in range(int(rng.integers(1, 9))):
            dl = (None if rng.random() < 0.4
                  else float(rng.uniform(0.0, 2.0)))
            pin = None if rng.random() < 0.5 else int(rng.integers(0, 3))
            items.append(Item(i, float(rng.uniform(0.0, 3.0)),
                              float(rng.choice([4096, 8192, 786432])),
                              dl, int(rng.random() < 0.1), pin))
        now = float(rng.uniform(1.0, 4.0))
        for prefer in (None, 0, 1, 2):
            for kw in ({}, {"starvation_age_s": 0.5, "pressure_s": 0.1}):
                assert (tsched.pick_work(items, now, prefer=prefer, **kw)
                        == jsched.pick_work(items, now, prefer=prefer, **kw))


def test_prefetch_depth_formula():
    for px, lc in ((1e6, 0.05e6), (1e4, 0.05e6), (1e4, 1e9), (1e9, 0.0),
                   (0.5, 3.0), (2e6, 2e6)):
        for lo, hi in ((2, 4), (1, 8)):
            assert (tsched.prefetch_depth(px, lc, lo=lo, hi=hi)
                    == jsched.prefetch_depth(px, lc, lo=lo, hi=hi))


@pytest.mark.parametrize("lc", [860.0, 0.05e6, 2e6, 5e7])
def test_prefetch_depth_for_equal_batchers(lc):
    shapes = varres_shapes(30, seed=int(lc) % 7)
    kw = dict(shuffle=True, seed=0, pad_multiple="auto", remnant_sizes=True,
              launch_cost_px=lc)
    port = ShardedBatcher(_ShapeDs(shapes), 4, **kw)
    ref = JaxShardedBatcher(_ShapeDs(shapes), 4, plan_mode="cost", **kw)
    assert tsched.prefetch_depth_for(port) == jsched.prefetch_depth_for(ref)
    small = [(64, 64)] * 16
    port = ShardedBatcher(_ShapeDs(small), 4, shuffle=False, launch_cost_px=lc)
    ref = JaxShardedBatcher(_ShapeDs(small), 4, shuffle=False,
                            launch_cost_px=lc)
    assert tsched.prefetch_depth_for(port) == jsched.prefetch_depth_for(ref)


def test_offline_planner_is_the_global_planner():
    from can_tpu_torch.data.planner import GlobalPlanner, PlanCostModel

    model = PlanCostModel(menu=(4, 2, 1), launch_cost_px=2e5)
    counts = {(512, 768): 9, (384, 512): 3, (768, 1024): 5}
    got = tsched.offline_planner(model, max_buckets=4).plan(counts)
    want = GlobalPlanner(model, max_buckets=4).plan(counts)
    assert got == want


# -- the port's batcher consumes the core as JAX's does ---------------------
class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _run_batcher(core_mod, batcher_cls, queue_cls, request_cls, script):
    """Drive one batcher through ``script`` [(dt, n_arrivals), ...]; return
    [(t, launch size, valid)] for every dispatch."""
    clock = FakeClock()
    launches = []

    def dispatch(bucket, batch, reqs):
        launches.append((round(clock.t, 9), batch.image.shape[0], len(reqs)))

    sched = core_mod.ServeSched(8, max_wait_s=0.01)
    q = queue_cls(64, clock=clock)
    b = batcher_cls(q, dispatch, max_batch=8, max_wait_ms=10.0, clock=clock,
                    sched=sched)
    for dt, n in script:
        clock.t += dt
        for _ in range(n):
            q.offer(request_cls(np.zeros((64, 64, 3), np.float32),
                                deadline_s=None, clock=clock))
        b.intake()
        b.poll(clock.t)
    clock.t += 1.0
    b.poll(clock.t)
    b.flush_all()
    return launches


def test_batcher_launches_equal_jax():
    from can_tpu.serve import BoundedRequestQueue as JQ
    from can_tpu.serve import MicroBatcher as JB
    from can_tpu.serve import ServeRequest as JR

    rng = np.random.default_rng(3)
    script = [(float(rng.choice([0.0, 0.001, 0.004, 0.02])),
               int(rng.integers(0, 4))) for _ in range(60)]
    got = _run_batcher(tsched, MicroBatcher, BoundedRequestQueue,
                       ServeRequest, script)
    want = _run_batcher(jsched, JB, JQ, JR, script)
    assert got == want and len(got) > 10
    menu = tsched.default_serve_menu(8)
    sched = tsched.ServeSched(8, max_wait_s=0.01)
    # every launch is a menu size, and exactly the core's cover
    assert all(size in menu and size == sched.cover_one(valid)
               for _, size, valid in got)
