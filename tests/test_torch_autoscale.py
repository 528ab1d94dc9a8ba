"""The self-healing fleet and the autoscaler of can_tpu_torch on the CPU:
``decide``, ``Autoscaler.tick`` sequences (fake clock), ``priced_deadline_s``
and the probation schedule (``probe_at`` / ``backoff_s`` under scripted
probe failures, driven through ``maintenance_tick(now=...)``) equal to the
JAX package's on shared scripts; then tests/test_autoscale.py's
TestBufferRelease, TestWatchdogMath, TestWatchdog, TestResurrection (no
AOT case), TestProbeBackoff, TestProbeIsolation, TestDrainingWatchdog,
TestAutoscalerUnit, TestAutoscalerLive, TestChaos and TestCLI, by name
(the AOT, obs, Prometheus and report tests wait for ROADMAP Queue 1 items
3c and 5; the paging test here holds the trigger, the incident manager's
once-per-cooldown is item 5's).  Every cooldown is 2 s or less; the
chaos hang is twice a watchdog deadline priced from warm launches timed
on the host (2 s on a quiet one).
"""

import gc
import json
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

import can_tpu.serve.autoscale as jautoscale
import can_tpu.serve.fleet as jfleet_mod
from can_tpu import obs
from can_tpu.data import batching as jbatching
from can_tpu.serve import FleetEngine as JaxFleetEngine
from can_tpu.serve.queue import ServeRequest as JaxServeRequest
from can_tpu_torch.data import pad_batch
from can_tpu_torch.serve import (
    Autoscaler,
    AutoscalePolicy,
    CountService,
    FleetEngine,
    ServeEngine,
    ServeRequest,
    prepare_image,
    priced_deadline_s,
)
from can_tpu_torch.serve.autoscale import decide
from can_tpu_torch.serve.fleet import REPLICA_DRAINING, _WorkItem
from can_tpu_torch.testing import faults, serve_on
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from tests.test_torch_model import jax_params

CPU = torch.device("cpu")
# the hang test's watchdog deadline in warm survivor launches: the hung
# batch's detour (the deadline, then a few survivor launches) stays
# well inside the hang of twice the deadline
WATCHDOG_LAUNCHES = 25


@pytest.fixture(scope="module")
def he():
    return jax_params("he")


@pytest.fixture(scope="module")
def params(he):
    return state_dict_from_jax_params(he)


@pytest.fixture(scope="module")
def params2():
    return state_dict_from_jax_params(jax_params("he", seed=1))


class Events:
    """A telemetry stand-in: records ``emit(kind, **payload)``."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))

    def of(self, kind):
        return [p for k, p in self.events if k == kind]


def make_image(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return prepare_image((rng.uniform(0, 1, (h, w, 3)) * 255)
                         .astype(np.uint8))


def make_fleet_service(params, *, replicas=2, ladder=((64,), (64,)),
                       max_batch=2, telemetry=None, warm=True, slots=4,
                       **kw):
    kw.setdefault("self_heal", False)  # tests drive maintenance_tick
    fleet = FleetEngine(params, replicas=replicas, telemetry=telemetry,
                        devices=[CPU] * slots, **kw)
    svc = CountService(fleet, max_batch=max_batch, max_wait_ms=1.0,
                       queue_capacity=256, bucket_ladder=ladder)
    if warm:
        svc.warmup([(h, w) for h in ladder[0] for w in ladder[1]])
    return fleet, svc


def one_batch(img, n=1):
    dm = np.zeros((img.shape[0] // 8, img.shape[1] // 8, 1), np.float32)
    return pad_batch([(img, dm)] * n, img.shape[:2], n, [True] * n, 8)


def own_tensors(fleet, replica) -> list:
    """The replica engine's weight tensors that are not the fleet's host
    tree (CPU placement shares 1-D storage with it)."""
    host = {id(t) for v in fleet._host_q.values()
            for t in (v.values() if isinstance(v, dict) else (v,))}
    return [t for v in replica.engine.params.values()
            for t in (v.values() if isinstance(v, dict) else (v,))
            if id(t) not in host]


# --- the HBM leak fix (tests/test_autoscale.py::TestBufferRelease) -------
class TestBufferRelease:
    def test_quarantine_releases_device_bytes(self, params):
        """A quarantined replica's weights leave at once: no tensor of its
        engine survives, and the survivor keeps serving."""
        fleet, _ = make_fleet_service(params, warm=False)
        fleet.warmup([(64, 64)], 2)
        mine = own_tensors(fleet, fleet.replicas[1])
        before = sum(t.numel() * t.element_size() for t in mine)
        assert before > 50 * 1024 * 1024  # the ~83 MB f32 tree
        refs = [weakref.ref(t) for t in mine]
        del mine
        img = np.zeros((64, 64, 3), np.float32)
        r = ServeRequest(img, deadline_s=None)
        fleet._quarantine(fleet.replicas[1],
                          _WorkItem((64, 64), one_batch(img), [r]),
                          RuntimeError("induced"))
        assert fleet.replicas[1].state == "quarantined"
        assert fleet.replicas[1].engine.released
        gc.collect()
        assert sum(w().numel() * w().element_size()
                   for w in refs if w() is not None) == 0
        assert fleet.replicas[1].probe_at is not None
        c, _ = fleet.replicas[0].engine.predict_batch(one_batch(img, 2))
        assert c.shape == (2,)

    def test_released_engine_refuses_predict(self, params):
        eng = ServeEngine(params, device="cpu")
        eng.release_buffers()
        eng.release_buffers()  # idempotent
        with pytest.raises(RuntimeError, match="released"):
            eng.predict_batch(one_batch(np.zeros((64, 64, 3), np.float32)))


# --- watchdog deadline math ---------------------------------------------
class FakeLedger:
    def __init__(self, rows):
        self._rows = rows

    def rows(self):
        return self._rows


def row(name, shape, mean_s, reliable=True):
    return {"name": name, "shape": list(shape), "mean_s": mean_s,
            "timing_reliable": reliable}


class TestWatchdogMath:
    SHAPE = (2, 64, 64, 3)

    def test_no_ledger_falls_back_to_default(self):
        assert priced_deadline_s(None, "f", self.SHAPE, slack=10,
                                 floor_s=1, default_s=30) == 30

    def test_priced_from_reliable_mean_times_slack(self):
        led = FakeLedger([row("f_r0", self.SHAPE, 0.5)])
        assert priced_deadline_s(led, "f", self.SHAPE, slack=10,
                                 floor_s=1, default_s=30) == 5.0

    def test_max_over_replica_programs(self):
        led = FakeLedger([row("f_r0", self.SHAPE, 0.5),
                          row("f_r1", self.SHAPE, 0.9),
                          row("other", self.SHAPE, 99.0)])
        assert priced_deadline_s(led, "f", self.SHAPE, slack=10,
                                 floor_s=1, default_s=30) == 9.0

    def test_floor_binds_tiny_programs(self):
        led = FakeLedger([row("f_r0", self.SHAPE, 0.001)])
        assert priced_deadline_s(led, "f", self.SHAPE, slack=10,
                                 floor_s=1, default_s=30) == 1.0

    def test_dtype_mismatch_falls_back(self):
        led = FakeLedger([{**row("f_r0", self.SHAPE, 0.5),
                           "dtype": "float32"}])
        assert priced_deadline_s(led, "f", self.SHAPE, dtype="uint8",
                                 slack=10, floor_s=1, default_s=30) == 30
        assert priced_deadline_s(led, "f", self.SHAPE, dtype="float32",
                                 slack=10, floor_s=1, default_s=30) == 5.0
        led_unknown = FakeLedger([{**row("f_r0", self.SHAPE, 0.5),
                                   "dtype": "?"}])
        assert priced_deadline_s(led_unknown, "f", self.SHAPE,
                                 dtype="uint8", slack=10, floor_s=1,
                                 default_s=30) == 5.0

    def test_unwarmed_batch_gets_compile_allowance(self, params):
        fleet, _ = make_fleet_service(params)  # warmed f32 64x64
        dm = np.zeros((8, 8, 1), np.float32)

        def item_for(img):
            return _WorkItem((64, 64), pad_batch([(img, dm)], (64, 64), 2,
                                                 [True], 8), [])

        r = fleet.replicas[0]
        warm = fleet._deadline_for(
            item_for(np.zeros((64, 64, 3), np.float32)), r)
        cold = fleet._deadline_for(
            item_for(np.zeros((64, 64, 3), np.uint8)), r)
        assert warm == fleet.watchdog_default_s  # warmed: normal path
        assert cold == fleet.watchdog_compile_s  # unwarmed: allowance
        assert cold > warm

    def test_unreliable_or_unmatched_rows_fall_back(self):
        led = FakeLedger([row("f_r0", self.SHAPE, 0.5, reliable=False),
                          row("f_r0", (2, 96, 64, 3), 0.5)])
        assert priced_deadline_s(led, "f", self.SHAPE, slack=10,
                                 floor_s=1, default_s=30) == 30
        assert priced_deadline_s(FakeLedger([]), "f", self.SHAPE,
                                 slack=10, floor_s=1, default_s=30) == 30

    def test_priced_deadline_equals_jax_over_random_ledgers(self):
        rng = np.random.default_rng(0)
        shapes = [(2, 64, 64, 3), (1, 64, 96, 3), (2, 96, 64, 3)]
        for _ in range(200):
            rows = []
            for _ in range(int(rng.integers(0, 6))):
                r = row(str(rng.choice(["f_r0", "f_r1", "g_r0"])),
                        shapes[int(rng.integers(0, 3))],
                        float(rng.choice([0.0, rng.uniform(1e-4, 2.0)])),
                        reliable=bool(rng.integers(0, 2)))
                dt = rng.integers(0, 4)
                if dt:
                    r["dtype"] = ["float32", "uint8", "?"][int(dt) - 1]
                rows.append(r)
            ledger = FakeLedger(rows) if rng.integers(0, 5) else None
            kw = dict(slack=float(rng.uniform(1, 20)),
                      floor_s=float(rng.uniform(0, 2)),
                      default_s=float(rng.uniform(5, 60)),
                      dtype=[None, "float32", "uint8"][int(rng.integers(0, 3))])
            shape = shapes[int(rng.integers(0, 3))]
            assert priced_deadline_s(ledger, "f", shape, **kw) == \
                jfleet_mod.priced_deadline_s(ledger, "f", shape, **kw)


# --- watchdog behaviour --------------------------------------------------
class TestWatchdog:
    def test_hung_launch_wedged_and_batch_completes_on_survivor(
            self, params):
        events = Events()
        fleet, svc = make_fleet_service(params, telemetry=events)
        origs = {r.index: r.engine.predict_batch for r in fleet.replicas}
        hung = []

        def make_hang(idx):
            def predict(batch, want_density=False):
                if not hung:
                    hung.append(idx)
                    time.sleep(1.5)  # a launch that wedges
                return origs[idx](batch, want_density=want_density)
            return predict

        for r in fleet.replicas:
            r.engine.predict_batch = make_hang(r.index)
        with svc:
            t = svc.submit(make_image(), deadline_ms=60_000)
            deadline = time.time() + 10
            while not hung and time.time() < deadline:
                time.sleep(0.01)
            assert hung
            # one far-future tick: a deterministic wedge
            fleet.maintenance_tick(now=fleet._clock() + 1000.0)
            res = t.result(timeout=30.0)
        assert res.count is not None  # zero lost admitted requests
        wedged_idx = hung[0]
        states = {r["replica"]: r for r in fleet.healthz()["replicas"]}
        assert states[wedged_idx]["state"] == "wedged"
        assert "watchdog" in states[wedged_idx]["error"]
        assert states[1 - wedged_idx]["state"] == "active"
        assert svc.stats()["rejected"] == 0
        assert len([p for p in events.of("fleet.replica")
                    if p["state"] == "wedged"]) == 1

    def test_completed_launch_never_wedges(self, params):
        fleet, svc = make_fleet_service(params)
        with svc:
            assert svc.predict(make_image(),
                               deadline_ms=60_000).count is not None
            fleet.maintenance_tick(now=fleet._clock() + 1000.0)
        assert all(r.state == "active" for r in fleet.replicas)


# --- resurrection --------------------------------------------------------
def boom(batch, want_density=False):
    raise RuntimeError("induced death")


class TestResurrection:
    def test_crash_probe_resurrect_zero_lost(self, params):
        events = Events()
        fleet, svc = make_fleet_service(params, telemetry=events,
                                        probe_cooldown_s=2.0)
        fleet.replicas[0].engine.predict_batch = boom
        img = make_image()
        with svc:
            tickets = [svc.submit(img, deadline_ms=60_000)
                       for _ in range(10)]
            assert len([t.result(timeout=60.0) for t in tickets]) == 10
            assert fleet.live_replicas() == 1
            # before the cooldown: no probe
            fleet.maintenance_tick(now=fleet.replicas[0].probe_at - 0.01)
            fleet.join_probes(60.0)
            assert fleet.live_replicas() == 1
            # past it: probe + resurrect
            fleet.maintenance_tick(now=fleet.replicas[0].probe_at)
            fleet.join_probes(60.0)
            assert fleet.live_replicas() == 2
            tickets = [svc.submit(img, deadline_ms=60_000)
                       for _ in range(8)]
            for t in tickets:
                t.result(timeout=60.0)
        assert len(events.of("fleet.resurrect")) == 1
        probes = events.of("fleet.probe")
        assert len(probes) == 1 and probes[0]["ok"]
        res = events.of("fleet.resurrect")[0]
        assert res["aot_hits"] == 0
        # the fresh incarnation ran the probe and the menu's 2 signatures
        assert fleet.replicas[0].engine.compile_count == 2
        st = svc.stats()
        assert st["rejected"] == 0
        assert st["replicas"]["0"]["quarantined"] == 0  # active again
        assert fleet.replicas[0].engine.name == "serve_predict_r0i1"

    def test_resurrection_joins_current_generation(self, params, params2):
        fleet, svc = make_fleet_service(params, probe_cooldown_s=0.1)
        fleet.replicas[0].engine.predict_batch = boom
        img = make_image()
        with svc:
            svc.submit(img, deadline_ms=60_000).result(timeout=60.0)
            assert fleet.replicas[0].state == "quarantined"
            fleet.rollout(params2)
            h = fleet.healthz()
            rows = {r["replica"]: r for r in h["replicas"]}
            assert rows[1]["generation"] == 1  # flipped
            assert rows[0]["generation"] == 0  # quarantined: skipped
            assert not h["mixed_generations"]  # r0 isn't SERVING stale
            fleet.maintenance_tick(now=fleet._clock() + 1.0)
            fleet.join_probes(60.0)
            assert fleet.live_replicas() == 2
            rows = {r["replica"]: r for r in fleet.healthz()["replicas"]}
            assert rows[0]["generation"] == 1  # resurrected at CURRENT
            fleet.replicas[1].state = "quarantined"  # r0 must serve
            got = svc.predict(img, deadline_ms=60_000).count
        ref = ServeEngine(params2, device="cpu")
        assert got == float(ref.predict_batch(one_batch(img))[0][0])


# --- probe backoff + paging ---------------------------------------------
def quarantine_directly(fleet, index=0):
    img = np.zeros((64, 64, 3), np.float32)
    r = ServeRequest(img, deadline_s=None)
    fleet._quarantine(fleet.replicas[index],
                      _WorkItem((64, 64), one_batch(img), [r]),
                      RuntimeError("induced death"))
    assert fleet.replicas[index].state == "quarantined"


def sick(index, device):
    raise RuntimeError("device still sick")


class TestProbeBackoff:
    def _quarantined_fleet(self, params, **kw):
        fleet, _ = make_fleet_service(params, probe_cooldown_s=1.0,
                                      probe_jitter=0.0, **kw)
        quarantine_directly(fleet)
        return fleet

    def test_backoff_escalates_and_caps(self, params):
        fleet = self._quarantined_fleet(params, probe_backoff_max_s=3.0)
        r = fleet.replicas[0]
        assert r.backoff_s == 1.0  # fresh quarantine: the cooldown
        fleet._build_replica_engine = sick
        for want in (2.0, 3.0, 3.0):  # x2, then capped
            now = r.probe_at
            fleet.maintenance_tick(now=now)
            fleet.join_probes(30.0)
            assert r.state == "quarantined"
            assert r.backoff_s == want
            assert r.probe_at == now + want  # jitter=0: exact

    def test_transient_failure_absorbed(self, params):
        pages = []
        tel = Events()
        tel.incidents = type("I", (), {
            "trigger": lambda self, reason, **kw: pages.append(reason)})()
        fleet, _ = make_fleet_service(params, telemetry=tel,
                                      probe_cooldown_s=0.1,
                                      probe_jitter=0.0, page_after_probes=3)
        quarantine_directly(fleet)
        build = fleet._build_replica_engine
        calls = [0]

        def flaky(index, device):
            calls[0] += 1
            if calls[0] == 1:
                raise RuntimeError("transient")
            return build(index, device)

        fleet._build_replica_engine = flaky
        r = fleet.replicas[0]
        fleet.maintenance_tick(now=r.probe_at)
        fleet.join_probes(30.0)
        assert fleet.live_replicas() == 1  # transient absorbed
        fleet.maintenance_tick(now=r.probe_at)
        fleet.join_probes(60.0)
        assert fleet.live_replicas() == 2  # healed
        assert pages == []  # transient never paged

    def test_persistent_failure_pages_past_threshold(self, params):
        """Past ``page_after_probes`` every failed probe triggers the
        incident layer once, with the reason and the replica; the
        manager's once-per-cooldown is ROADMAP Queue 1 item 5's."""
        pages = []
        tel = Events()
        tel.incidents = type("I", (), {
            "trigger": lambda self, reason, detail=None: pages.append(
                (reason, detail["replica"], detail["probe_failures"]))})()
        fleet, _ = make_fleet_service(params, telemetry=tel,
                                      probe_cooldown_s=0.1,
                                      probe_jitter=0.0, page_after_probes=2)
        quarantine_directly(fleet)
        fleet._build_replica_engine = sick
        r = fleet.replicas[0]
        for _ in range(4):
            fleet.maintenance_tick(now=r.probe_at)
            fleet.join_probes(30.0)
        assert r.probe_failures == 4
        assert pages == [("fleet_probe_failed", 0, n) for n in (2, 3, 4)]


class TestProbeIsolation:
    def test_hung_probe_never_blocks_maintenance(self, params):
        fleet, _ = make_fleet_service(params, probe_cooldown_s=1.0,
                                      probe_jitter=0.0)
        fleet.probe_timeout_s = 5.0
        quarantine_directly(fleet)
        r = fleet.replicas[0]
        release = threading.Event()
        build = fleet._build_replica_engine

        def hung_build(index, device):
            release.wait(2.0)  # a launch that does not return
            return build(index, device)

        fleet._build_replica_engine = hung_build
        t0 = time.perf_counter()
        fleet.maintenance_tick(now=r.probe_at)  # spawns the probe
        assert time.perf_counter() - t0 < 1.0  # the tick did NOT block
        assert r.probing is not None
        token_before = r.probe_token
        assert fleet.healthz()["live"] == 1
        fleet.maintenance_tick(now=r.probe_at + 10.0)
        assert r.probing is None
        assert r.probe_failures == 1
        assert r.backoff_s == 2.0
        assert r.probe_token == token_before + 1
        release.set()
        fleet.join_probes(30.0)
        assert fleet.live_replicas() == 1
        assert fleet.replicas[0] is r  # never replaced by a stale probe

    def test_mid_probe_rollout_discards_stale_staging(self, params,
                                                      params2):
        fleet, _ = make_fleet_service(params, probe_cooldown_s=0.1,
                                      probe_jitter=0.0)
        quarantine_directly(fleet)
        r = fleet.replicas[0]
        build = fleet._build_replica_engine
        gate = threading.Event()

        def slow_build(index, device):
            eng = build(index, device)
            gate.wait(2.0)  # hold the probe while the rollout lands
            return eng

        fleet._build_replica_engine = slow_build
        fleet.maintenance_tick(now=r.probe_at)  # probe staging begins
        fleet.rollout(params2)                  # generation 0 -> 1
        gate.set()
        fleet.join_probes(60.0)
        assert fleet.live_replicas() == 1  # stale staging discarded
        assert r.probe_at is not None      # rescheduled promptly
        fleet._build_replica_engine = build
        fleet.maintenance_tick(now=fleet._clock() + 1.0)
        fleet.join_probes(60.0)
        assert fleet.live_replicas() == 2
        assert fleet.replicas[0].generation == 1


def test_probation_schedule_equals_jax(he, params):
    """Scripted probe failures on both fleets, one fake clock: every
    ``probe_at`` and ``backoff_s`` (seeded jitter, escalation, the cap)
    equal JAX's to the float."""
    jf = JaxFleetEngine(jax.tree.map(np.asarray, he), replicas=2,
                        devices=jax.devices()[:2], self_heal=False,
                        telemetry=obs.Telemetry(), probe_backoff_max_s=6.0)
    pf = FleetEngine(params, replicas=2, devices=[CPU] * 2,
                     self_heal=False, probe_backoff_max_s=6.0)
    spec = ([(64, 64)], 2, (np.float32,), (2, 1))
    img = np.zeros((64, 64, 3), np.float32)
    dm = np.zeros((8, 8, 1), np.float32)
    schedules = []
    for fl, item in (
            (jf, lambda: jfleet_mod._WorkItem(
                (64, 64), jbatching.pad_batch([(img, dm)], (64, 64), 1,
                                              [True], 8),
                [JaxServeRequest(img, deadline_s=None)])),
            (pf, lambda: _WorkItem((64, 64), one_batch(img),
                                   [ServeRequest(img, deadline_s=None)]))):
        fl._warmup_spec = spec
        fl._clock = lambda: 100.0
        fl._build_replica_engine = sick
        fl._quarantine(fl.replicas[0], item(), RuntimeError("a"))
        fl._clock = lambda: 100.25
        fl._quarantine(fl.replicas[1], item(), RuntimeError("b"))
        rows = []
        for _ in range(8):
            now = min(r.probe_at for r in fl.replicas)
            fl.maintenance_tick(now=now)
            fl.join_probes(30.0)
            rows.append(tuple((r.probe_at, r.backoff_s, r.probe_failures)
                              for r in fl.replicas))
        schedules.append(rows)
    assert schedules[0] == schedules[1]
    assert max(r[1] for row in schedules[1] for r in row) == 6.0  # capped


class TestDrainingWatchdog:
    def test_hang_during_scale_down_is_wedged_not_stranded(self, params):
        fleet, svc = make_fleet_service(params)
        img = np.zeros((64, 64, 3), np.float32)
        item = _WorkItem((64, 64), one_batch(img, 2),
                         [ServeRequest(img, deadline_s=None)])
        r = fleet.replicas[0]
        r.state = REPLICA_DRAINING
        with fleet._cond:
            r.inflight = (item, fleet._clock(), 0.5)
        fleet.maintenance_tick(now=fleet._clock() + 100.0)
        assert r.state == "wedged"
        assert r.probe_at is None  # remove_replica owns the teardown
        with fleet._cond:
            assert len(fleet._queue) == 1  # batch re-dispatched
            assert item.redispatches == 1


# --- autoscaler ----------------------------------------------------------
class FakeFleet:
    def __init__(self, live=2):
        self.live = live
        self._queue = []
        self.actions = []

    def live_replicas(self):
        return self.live

    def add_replica(self, *, reason):
        self.live += 1
        self.actions.append(("up", reason))
        return {"direction": "up"}

    def remove_replica(self, *, reason):
        self.live -= 1
        self.actions.append(("down", reason))
        return {"direction": "down"}


class FakeScaleService:
    def __init__(self, fleet):
        self._fleet = fleet
        self.signals = {"outstanding": 0, "p99_s": None}

    @property
    def queue(self):
        svc = self

        class Q:
            def outstanding(self_q):
                return svc.signals["outstanding"]
        return Q()

    def latency_percentile(self, q):
        return self.signals["p99_s"]


def make_autoscaler(live=2, cls=Autoscaler, policy_cls=AutoscalePolicy,
                    **policy_kw):
    policy_kw.setdefault("min_replicas", 1)
    policy_kw.setdefault("max_replicas", 4)
    policy_kw.setdefault("up_consecutive", 2)
    policy_kw.setdefault("down_consecutive", 3)
    policy_kw.setdefault("cooldown_s", 10.0)
    fleet = FakeFleet(live)
    svc = FakeScaleService(fleet)
    clock = [0.0]
    auto = cls(svc, policy_cls(**policy_kw), clock=lambda: clock[0])
    return auto, fleet, svc, clock


class TestAutoscalerUnit:
    def test_policy_validation(self):
        with pytest.raises(ValueError, match="hysteresis"):
            AutoscalePolicy(queue_high=2.0, queue_low=2.0)
        with pytest.raises(ValueError, match="max_replicas"):
            AutoscalePolicy(min_replicas=3, max_replicas=2)

    def test_decide_thresholds(self):
        pol = AutoscalePolicy(queue_high=4.0, queue_low=1.0,
                              p99_high_s=2.0)
        up = {"live": 2, "outstanding": 10, "queue_depth": 3,
              "p99_s": 0.1, "slo_alerting": False}
        assert decide(up, pol) == "up"
        lat = {"live": 2, "outstanding": 1, "queue_depth": 0,
               "p99_s": 3.0, "slo_alerting": False}
        assert decide(lat, pol) == "up"
        slo = {"live": 2, "outstanding": 0, "queue_depth": 0,
               "p99_s": None, "slo_alerting": True}
        assert decide(slo, pol) == "up"
        idle = {"live": 2, "outstanding": 0, "queue_depth": 0,
                "p99_s": 0.1, "slo_alerting": False}
        assert decide(idle, pol) == "down"
        hold = {"live": 2, "outstanding": 4, "queue_depth": 1,
                "p99_s": 0.1, "slo_alerting": False}
        assert decide(hold, pol) is None

    def test_idle_overrides_stale_p99(self):
        pol = AutoscalePolicy(queue_high=4.0, queue_low=1.0,
                              p99_high_s=2.0)
        stale_idle = {"live": 3, "outstanding": 0, "queue_depth": 0,
                      "p99_s": 30.0, "slo_alerting": False}
        assert decide(stale_idle, pol) == "down"
        stale_loaded = {"live": 3, "outstanding": 1, "queue_depth": 0,
                        "p99_s": 30.0, "slo_alerting": False}
        assert decide(stale_loaded, pol) == "up"

    def test_add_replica_refuses_stale_staging_after_rollout(
            self, params, params2):
        fleet, _ = make_fleet_service(params)
        build = fleet._build_replica_engine

        def build_and_roll(index, device):
            eng = build(index, device)
            fleet.rollout(params2)  # lands mid-staging
            return eng

        fleet._build_replica_engine = build_and_roll
        with pytest.raises(RuntimeError, match="rolled out during"):
            fleet.add_replica(reason="test")
        assert fleet.live_replicas() == 2  # nothing stale admitted
        fleet._build_replica_engine = build
        rep = fleet.add_replica(reason="retry")
        assert rep["generation"] == 1  # the retry stages gen-1 weights

    def test_up_needs_consecutive_evals(self):
        auto, fleet, svc, clock = make_autoscaler()
        svc.signals["outstanding"] = 100
        assert auto.tick() is None  # streak 1 < 2
        assert auto.tick() == "up"
        assert fleet.live == 3

    def test_spike_does_not_scale(self):
        auto, fleet, svc, clock = make_autoscaler()
        svc.signals["outstanding"] = 100
        assert auto.tick() is None
        svc.signals["outstanding"] = 0
        svc.signals["p99_s"] = 0.0
        auto.tick()  # streak broken
        svc.signals["outstanding"] = 100
        assert auto.tick() is None  # must re-earn the streak
        assert fleet.actions == []

    def test_cooldown_blocks_flapping_on_step_change(self):
        auto, fleet, svc, clock = make_autoscaler(cooldown_s=100.0)
        svc.signals["outstanding"] = 100
        auto.tick()
        auto.tick()
        assert fleet.live == 3
        for _ in range(10):
            clock[0] += 1.0
            assert auto.tick() is None  # in cooldown
        clock[0] += 200.0
        assert auto.tick() == "up"  # cooldown over, signal sustained
        assert fleet.live == 4

    def test_down_requires_sustained_idle_and_floor(self):
        auto, fleet, svc, clock = make_autoscaler(
            live=2, min_replicas=2, down_consecutive=2)
        svc.signals["outstanding"] = 0
        svc.signals["p99_s"] = 0.0
        for _ in range(5):
            assert auto.tick() is None  # at the floor: never below min
        auto2, fleet2, svc2, clock2 = make_autoscaler(
            live=3, min_replicas=2, down_consecutive=2)
        svc2.signals["outstanding"] = 0
        svc2.signals["p99_s"] = 0.0
        assert auto2.tick() is None
        assert auto2.tick() == "down"
        assert fleet2.live == 2

    def test_max_bound_holds(self):
        auto, fleet, svc, clock = make_autoscaler(
            live=4, max_replicas=4, up_consecutive=1)
        svc.signals["outstanding"] = 1000
        assert auto.tick() is None
        assert fleet.live == 4

    def test_needs_fleet_service(self):
        with pytest.raises(ValueError, match="fleet"):
            Autoscaler(object(), AutoscalePolicy())


def signal_grid(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"live": int(rng.integers(0, 6)),
               "outstanding": float(rng.choice([0, rng.integers(0, 60)])),
               "queue_depth": int(rng.choice([0, rng.integers(0, 8)])),
               "p99_s": rng.choice([None, float(rng.uniform(0, 5))]),
               "slo_alerting": bool(rng.integers(0, 6) == 0)}


POLICIES = ({}, {"queue_high": 4.0, "queue_low": 1.0, "p99_high_s": 2.0},
            {"queue_high": 2.0, "queue_low": 0.5, "p99_high_s": 0.25},
            {"min_replicas": 2, "max_replicas": 5, "queue_high": 16.0,
             "queue_low": 4.0})


@pytest.mark.parametrize("pol", range(len(POLICIES)))
def test_decide_equals_jax_over_a_signal_grid(pol):
    mine = AutoscalePolicy(**POLICIES[pol])
    theirs = jautoscale.AutoscalePolicy(**POLICIES[pol])
    verdicts = [(decide(s, mine), jautoscale.decide(s, theirs))
                for s in signal_grid(pol, 500)]
    assert all(a == b for a, b in verdicts)
    assert {v for v, _ in verdicts} == {"up", "down", None}


@pytest.mark.parametrize("pol", range(len(POLICIES)))
def test_tick_sequences_equal_jax(pol):
    """One scripted signal sequence and fake clock through both
    autoscalers (the FakeFleet / FakeScaleService of
    tests/test_autoscale.py): the same actions, tick for tick."""
    kw = {"up_consecutive": 2, "down_consecutive": 3, "cooldown_s": 5.0,
          **POLICIES[pol]}
    runs = []
    for cls, pcls in ((Autoscaler, AutoscalePolicy),
                      (jautoscale.Autoscaler, jautoscale.AutoscalePolicy)):
        rng = np.random.default_rng(100 + pol)
        auto, fleet, svc, clock = make_autoscaler(
            live=kw.get("min_replicas", 2), cls=cls, policy_cls=pcls, **kw)
        out = []
        for _ in range(300):
            clock[0] += float(rng.uniform(0.1, 2.0))
            svc.signals["outstanding"] = float(
                rng.choice([0, rng.integers(0, 80)]))
            svc.signals["p99_s"] = rng.choice([None,
                                               float(rng.uniform(0, 4))])
            out.append((auto.tick(), fleet.live))
        runs.append((out, fleet.actions, auto.stats()))
    assert runs[0] == runs[1]
    assert {a for a, _ in runs[0][0]} >= {"up", "down"}


class TestAutoscalerLive:
    def test_scale_transitions_drop_zero_requests(self, params):
        events = Events()
        fleet, svc = make_fleet_service(params, telemetry=events)
        auto = Autoscaler(
            svc, AutoscalePolicy(min_replicas=2, max_replicas=3,
                                 up_consecutive=1, down_consecutive=1,
                                 cooldown_s=0.0),
            clock=lambda: 0.0)
        img = make_image()
        stop = threading.Event()
        resolved, errors = [], []

        def client():
            while not stop.is_set():
                try:
                    resolved.append(svc.predict(img, deadline_ms=60_000,
                                                timeout=60.0).count)
                except Exception as e:  # noqa: BLE001 — the assert
                    errors.append(e)

        with svc:
            threads = [threading.Thread(target=client) for _ in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.3)
            auto.observe = lambda: {"live": fleet.live_replicas(),
                                    "outstanding": 1000,
                                    "queue_depth": 5, "p99_s": None,
                                    "slo_alerting": False}
            assert auto.tick() == "up"
            assert fleet.live_replicas() == 3
            added = fleet.replicas[-1]
            # the added replica serves: work steered to it, the others'
            # dispatch locks held
            steered = serve_on(fleet, svc, added.index, img)
            time.sleep(0.3)  # traffic through the grown fleet
            auto.observe = lambda: {"live": fleet.live_replicas(),
                                    "outstanding": 0,
                                    "queue_depth": 0, "p99_s": 0.0,
                                    "slo_alerting": False}
            assert auto.tick() == "down"
            assert fleet.live_replicas() == 2
            time.sleep(0.3)
            stop.set()
            for t in threads:
                t.join(timeout=30.0)
                assert not t.is_alive()
        assert not errors, errors[:3]
        assert len(resolved) > 0
        assert svc.stats()["rejected"] == 0
        assert [p["direction"] for p in events.of("fleet.scale")] == [
            "up", "down"]
        up, down = events.of("fleet.scale")
        assert up["time_to_first_ready_s"] > 0 and up["aot_hits"] == 0
        assert up["replica"] == down["replica"] == added.index
        assert added.batches >= 1
        assert all(np.isfinite(r.count) for r in steered)

    def test_remove_replica_refuses_last_live(self, params):
        fleet, svc = make_fleet_service(params)
        fleet.replicas[0].state = "quarantined"
        with pytest.raises(RuntimeError, match="below 1"):
            fleet.remove_replica(reason="test")


# --- chaos (the acceptance run) -----------------------------------------
class TestChaos:
    def _with_faults(self, monkeypatch, schedule):
        monkeypatch.setenv(faults.FAULTS_ENV, json.dumps(schedule))
        # the injector caches per spec value; force a fresh parse
        monkeypatch.setattr(faults, "_CACHED", None)
        monkeypatch.setattr(faults, "_CACHED_SPEC", None)

    def test_seeded_crash_quarantine_probe_resurrect_zero_lost(
            self, params, monkeypatch):
        """Sustained load, a seeded replica_crash on 1 of 2 replicas ->
        quarantine -> probe -> resurrection at the current generation,
        zero lost admitted requests, live back to 2.  Real maintenance
        thread, real worker threads, the env trigger."""
        self._with_faults(monkeypatch, {"faults": [
            {"kind": "replica_crash", "replica": 0, "batch": 1}]})
        events = Events()
        fleet, svc = make_fleet_service(
            params, telemetry=events, self_heal=True,
            probe_cooldown_s=0.3, maintain_interval_s=0.05)
        img = make_image()
        with svc:
            tickets = [svc.submit(img, deadline_ms=120_000)
                       for _ in range(16)]
            assert len([t.result(timeout=120.0) for t in tickets]) == 16
            t0 = time.time()
            while fleet.live_replicas() < 2 and time.time() - t0 < 30:
                time.sleep(0.05)
            assert fleet.live_replicas() == 2  # healed
            tickets = [svc.submit(img, deadline_ms=120_000)
                       for _ in range(8)]
            for t in tickets:
                t.result(timeout=120.0)
        assert svc.stats()["rejected"] == 0
        assert len(faults.active_injector().fired) == 1  # fired once
        assert len(events.of("fleet.resurrect")) == 1
        assert events.of("fleet.resurrect")[0]["generation"] == \
            fleet.generation
        rows = {r["replica"]: r for r in fleet.healthz()["replicas"]}
        assert all(r["state"] == "active" for r in rows.values())

    def test_seeded_hang_watchdog_within_priced_deadline(
            self, params, monkeypatch):
        """A seeded replica_hang (replica 0, twice the watchdog deadline)
        is wedged and its batch completes on the SURVIVING replica before
        the hang would have returned.

        The deadline follows the host: WATCHDOG_LAUNCHES times the slowest
        of a few warm full-batch launches timed on the survivor just
        before (at least 1 s), and the hang twice that.  A survivor
        launch past the deadline would be wedged too and the batch
        rejected, and the hung batch's detour takes the deadline plus a
        few launches, so a fixed deadline held only on a quiet host."""
        events = Events()
        fleet, svc = make_fleet_service(
            params, telemetry=events, self_heal=True,
            probe_cooldown_s=0.3, maintain_interval_s=0.05)
        img = make_image()
        survivor = fleet.replicas[1]
        batch = one_batch(img, n=2)  # the service's max_batch
        launches = []
        with survivor.lock:  # the workers are not started yet; be explicit
            for _ in range(3):
                t0 = time.perf_counter()
                survivor.engine.predict_batch(batch)
                launches.append(time.perf_counter() - t0)
        watchdog_s = max(1.0, WATCHDOG_LAUNCHES * max(launches))
        hang_s = 2.0 * watchdog_s
        fleet.watchdog_default_s = watchdog_s
        self._with_faults(monkeypatch, {"faults": [
            {"kind": "replica_hang", "replica": 0, "batch": 1,
             "delay_s": hang_s}]})
        inj = faults.active_injector()
        with svc:
            tickets = []
            # stream requests until replica 0 takes one (work stealing
            # decides who pulls; the seeded fault fires on ITS first)
            while not inj.fired and len(tickets) < 20:
                tickets.append(svc.submit(img, deadline_ms=120_000))
                time.sleep(0.05)
            assert inj.fired, "replica 0 never pulled a batch"
            t_seen = time.time()
            tickets.append(svc.submit(img, deadline_ms=120_000))
            results = [t.result(timeout=30.0 + hang_s) for t in tickets]
            dt = time.time() - t_seen
        assert len(results) == len(tickets)  # zero lost, the hung batch too
        assert dt < hang_s, dt  # never waited the hang out
        wedge = [p for p in events.of("fleet.replica")
                 if p["state"] == "wedged"]
        assert len(wedge) == 1 and wedge[0]["replica"] == 0
        assert svc.stats()["rejected"] == 0


# --- CLI flags (tests/test_autoscale.py::TestCLI) -------------------------
def cli_args(tmp_path, argv):
    from can_tpu_torch.cli.serve import parse_args

    pth = tmp_path / "a.pth"
    pth.write_bytes(b"")
    return parse_args(["--torch-pth", str(pth), "--platform", "cpu"] + argv)


class TestCLI:
    def test_parse_healing_flags(self):
        from can_tpu_torch.cli.serve import parse_args

        a = parse_args(["--replicas", "2", "--aot-bundle", "/b",
                        "--aot-bake", "/o", "--autoscale-max", "4",
                        "--autoscale-min", "2",
                        "--probe-cooldown-s", "2.5",
                        "--watchdog-slack", "5",
                        "--watchdog-default-s", "10"])
        assert a.aot_bundle == "/b" and a.aot_bake == "/o"
        assert a.autoscale_max == 4 and a.autoscale_min == 2
        assert a.probe_cooldown_s == 2.5
        assert a.watchdog_slack == 5.0
        assert a.watchdog_default_s == 10.0
        d = parse_args([])
        assert d.autoscale_max == 0 and d.aot_bundle == ""

    def test_fleet_only_flags_refused_single_engine(self, tmp_path):
        from can_tpu_torch.cli.serve import build_service

        for flags in (["--aot-bundle", "/b"], ["--aot-bake", "/o"],
                      ["--autoscale-max", "2"]):
            with pytest.raises(SystemExit, match="fleet mode"):
                build_service(cli_args(tmp_path, flags))

    def test_autoscale_max_must_exceed_replicas(self, tmp_path):
        from can_tpu_torch.cli.serve import build_service

        with pytest.raises(SystemExit, match="autoscale-max"):
            build_service(cli_args(tmp_path, ["--replicas", "2",
                                              "--autoscale-max", "2"]))

    def test_autoscale_min_validated_before_load(self, tmp_path):
        from can_tpu_torch.cli.serve import build_service

        for bad in ("0", "5"):
            with pytest.raises(SystemExit, match="autoscale-min"):
                build_service(cli_args(tmp_path, ["--replicas", "2",
                                                  "--autoscale-max", "3",
                                                  "--autoscale-min", bad]))
