"""can_tpu_torch.serve.fleet on the CPU: a 2-replica port fleet serves
JAX's ``FleetEngine`` counts for the same weights and images, before and
after a rollout (model tolerance, rtol 1e-3 / atol 1e-4 f32,
tests/test_model.py:98); then the behaviour of tests/test_fleet.py's
TestFleetServing, TestRollout, TestFleetHTTP and TestFleetCLI, by name,
on ``devices=[cpu] * k`` (the scale universe is a list of slots); then
what the port adds: the device guard around every replica body, the
release of a dead replica's tensors, stream pins over live replicas, no
CPU fallback without ``devices=``, AOT refusals (no bundle, a bake before warmup),
and launch counters that keep every increment across threads.

Full-width CANNet, He-scaled weights from a numpy seed (the JAX tree
carried over by ``utils.torch_import``), a 64 px ladder, ``max_batch`` 2.
"""

import contextlib
import gc
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import jax
import numpy as np
import pytest
import torch

from can_tpu import obs
from can_tpu.serve import CountService as JaxCountService
from can_tpu.serve import FleetEngine as JaxFleetEngine
from can_tpu_torch.data import pad_batch
from can_tpu_torch.device import NoCudaDeviceError
from can_tpu_torch.models import random_state_dict
from can_tpu_torch.serve import (
    REJECT_DEADLINE,
    REJECT_ERROR,
    CountService,
    FleetEngine,
    RejectedError,
    ServeEngine,
    ServeRequest,
    prepare_image,
    serve_http,
)
from can_tpu_torch.serve import fleet as fleet_mod
from can_tpu_torch.serve.fleet import _WorkItem
from can_tpu_torch.testing import serve_on
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from tests.test_torch_model import jax_params

CPU = torch.device("cpu")
RTOL, ATOL = 1e-3, 1e-4  # tests/test_model.py:98


@pytest.fixture(scope="module")
def he():
    return jax_params("he")


@pytest.fixture(scope="module")
def he2():
    return jax_params("he", seed=1)


@pytest.fixture(scope="module")
def params(he):
    return state_dict_from_jax_params(he)


@pytest.fixture(scope="module")
def params2(he2):
    return state_dict_from_jax_params(he2)


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


def make_fleet_service(params, *, replicas=2, serve_dtype="f32",
                       ladder=((64,), (64,)), max_batch=2, slots=4,
                       run_config=None, telemetry=None, fleet_kw=None, **kw):
    fleet = FleetEngine(params, replicas=replicas, serve_dtype=serve_dtype,
                        devices=[CPU] * slots, telemetry=telemetry,
                        run_config=run_config, **(fleet_kw or {}))
    svc = CountService(fleet, max_batch=max_batch, max_wait_ms=1.0,
                       queue_capacity=256, bucket_ladder=ladder, **kw)
    svc.warmup([(h, w) for h in ladder[0] for w in ladder[1]])
    return fleet, svc


def one_batch(img, n=1):
    dm = np.zeros((img.shape[0] // 8, img.shape[1] // 8, 1), np.float32)
    return pad_batch([(img, dm)] * n, img.shape[:2], n, [True] * n, 8)


def fresh_count(state_dict, img) -> float:
    """What a fresh single engine serves for a lone request (the 1-slot
    menu launch)."""
    eng = ServeEngine(state_dict, device="cpu")
    return float(eng.predict_batch(one_batch(img))[0][0])


# --- parity with JAX's FleetEngine --------------------------------------
IMAGE_SHAPES = ((64, 64), (61, 60), (96, 64), (72, 56), (64, 64), (90, 61))


@pytest.fixture(scope="module")
def fleet_counts(he, he2, params, params2):
    """Both fleets (2 replicas each; JAX's on 2 of the conftest's 8 host
    devices) serve the same images, roll out to the second weight set,
    and serve them again."""
    rng = np.random.default_rng(3)
    images = [prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in IMAGE_SHAPES]
    ladder = ((64, 96), (64,))
    grid = [(h, w) for h in ladder[0] for w in ladder[1]]

    def serve(svc, rollout):
        with svc:
            before = [t.result(timeout=120).count for t in
                      [svc.submit(x, deadline_ms=120_000) for x in images]]
            report = rollout()
            after = [t.result(timeout=120).count for t in
                     [svc.submit(x, deadline_ms=120_000) for x in images]]
        return before, after, report

    jfleet = JaxFleetEngine(jax.tree.map(np.asarray, he), replicas=2,
                            devices=jax.devices()[:2], self_heal=False,
                            telemetry=obs.Telemetry())
    jsvc = JaxCountService(jfleet, max_batch=2, max_wait_ms=1.0,
                           queue_capacity=256, bucket_ladder=ladder)
    jsvc.warmup(grid)
    want = serve(jsvc, lambda: jfleet.rollout(jax.tree.map(np.asarray, he2)))
    fleet = FleetEngine(params, replicas=2, devices=[CPU] * 2,
                        self_heal=False)
    svc = CountService(fleet, max_batch=2, max_wait_ms=1.0,
                       queue_capacity=256, bucket_ladder=ladder)
    svc.warmup(grid)
    got = serve(svc, lambda: fleet.rollout(params2))
    return got, want


def test_counts_equal_jax_fleet(fleet_counts):
    (got, _, _), (want, _, _) = fleet_counts
    assert np.abs(want).max() > 1.0  # He-scaled weights: real counts
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_counts_after_rollout_equal_jax_fleet(fleet_counts):
    (before, got, rep), (_, want, jrep) = fleet_counts
    assert rep["generation"] == jrep["generation"] == 1
    assert rep["flipped"] == jrep["flipped"] == [0, 1]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not np.allclose(got, before, rtol=1e-2)  # the weights changed


# --- fleet serving (tests/test_fleet.py::TestFleetServing) ---------------
class TestFleetServing:
    def test_replica_count_validation(self, params):
        with pytest.raises(ValueError, match="exceeds the 3 available"):
            FleetEngine(params, replicas=4, devices=[CPU] * 3)
        with pytest.raises(ValueError, match="replicas"):
            FleetEngine(params, replicas=0, devices=[CPU] * 3)

    def test_mixed_traffic_zero_new_compiles_and_no_starvation(self,
                                                               params):
        """2 replicas, mixed resolutions, every request resolves, no new
        signature after warmup, and BOTH replicas execute batches under a
        skewed bucket mix (work stealing)."""
        fleet, svc = make_fleet_service(
            params, ladder=((64, 96), (64,)), max_batch=2)
        compiles_after_warmup = fleet.compile_count
        sizes = [(64, 64)] * 9 + [(96, 64)]
        imgs = {s: make_image(*s, seed=s[0]) for s in set(sizes)}
        with svc:
            tickets = [svc.submit(imgs[sizes[i % len(sizes)]],
                                  deadline_ms=60_000) for i in range(40)]
            results = [t.result(timeout=120.0) for t in tickets]
        assert len(results) == 40
        assert fleet.compile_count == compiles_after_warmup
        st = svc.stats()
        assert st["completed"] == 40 and st["rejected"] == 0
        per_replica = {k: v["batches"] for k, v in st["replicas"].items()}
        assert set(per_replica) == {"0", "1"}
        assert all(b > 0 for b in per_replica.values()), per_replica
        assert st["live_replicas"] == 2 and st["generation"] == 0

    def test_replica_death_redispatches_once_and_quarantines(self, params):
        events = Events()
        fleet, svc = make_fleet_service(params, telemetry=events)
        calls = [0]

        def boom(batch, want_density=False):
            calls[0] += 1
            raise RuntimeError("induced replica death")

        fleet.replicas[0].engine.predict_batch = boom
        img = make_image()
        with svc:
            tickets = [svc.submit(img, deadline_ms=60_000)
                       for _ in range(12)]
            results = [t.result(timeout=60.0) for t in tickets]
        assert len(results) == 12  # zero lost admitted requests
        assert calls[0] == 1      # the batch was NOT retried on the corpse
        assert svc.stats()["rejected"] == 0
        h = fleet.healthz()
        assert h["ok"] and h["live"] == 1
        states = {r["replica"]: r for r in h["replicas"]}
        assert states[0]["state"] == "quarantined"
        assert "induced replica death" in states[0]["error"]
        assert states[1]["state"] == "active"
        st = svc.stats()
        assert st["replicas"]["0"]["quarantined"] == 1
        assert st["replicas"]["0"]["failures"] == 1
        fr = events.of("fleet.replica")
        assert fr and fr[0]["state"] == "quarantined"

    def test_batch_failing_on_two_replicas_is_rejected_error(self, params):
        fleet, svc = make_fleet_service(params)

        def boom(batch, want_density=False):
            raise RuntimeError("poison batch")

        for r in fleet.replicas:
            r.engine.predict_batch = boom
        with svc:
            t = svc.submit(make_image(), deadline_ms=60_000)
            with pytest.raises(RejectedError) as ei:
                t.result(timeout=60.0)
        assert ei.value.reason == REJECT_ERROR
        assert fleet.live_replicas() == 1
        assert fleet.healthz()["ok"]
        states = sorted(r["state"] for r in fleet.healthz()["replicas"])
        assert states == ["active", "quarantined"]
        assert sum(r.failures for r in fleet.replicas) == 2

    def test_last_replica_death_fails_queued_work(self, params):
        fleet = FleetEngine(params, replicas=2, devices=[CPU] * 2)
        img = make_image()

        def mk():
            return ServeRequest(img, deadline_s=None), one_batch(img)

        queued = []
        for _ in range(3):  # workers never started: items stay queued
            r, b = mk()
            fleet.submit_work((64, 64), b, [r])
            queued.append(r)
        fleet.replicas[1].state = "quarantined"
        inflight, b = mk()
        fleet._quarantine(fleet.replicas[0],
                          _WorkItem((64, 64), b, [inflight]),
                          RuntimeError("last replica down"))
        assert fleet.live_replicas() == 0
        for r in [inflight] + queued:
            with pytest.raises(RejectedError):
                r.wait(timeout=5.0)

    def test_first_failure_during_close_still_redispatches(self, params):
        fleet = FleetEngine(params, replicas=2, devices=[CPU] * 2)
        fleet._closed = True  # mid-close: live workers still draining
        img = make_image()
        r = ServeRequest(img, deadline_s=None)
        fleet._quarantine(fleet.replicas[0],
                          _WorkItem((64, 64), one_batch(img), [r]),
                          RuntimeError("transient"))
        assert not r.done and len(fleet._queue) == 1  # re-dispatched
        assert fleet.live_replicas() == 1
        fleet._swept = True  # post-sweep straggler: fail, never strand
        r2 = ServeRequest(img, deadline_s=None)
        fleet.replicas[0].state = "active"  # fresh first failure
        fleet._quarantine(fleet.replicas[0],
                          _WorkItem((64, 64), one_batch(img), [r2]),
                          RuntimeError("transient"))
        with pytest.raises(RejectedError):
            r2.wait(timeout=5.0)

    def test_rollout_loader_imported_source_not_poisoned_by_base_dir(
            self, tmp_path):
        from can_tpu_torch.cli.serve import make_rollout_loader, parse_args

        loader = make_rollout_loader(
            parse_args(["--checkpoint-dir", str(tmp_path)]))
        with pytest.raises((ValueError, FileNotFoundError)) as ei:
            loader({"torch_pth": str(tmp_path / "nope.pth")})
        # the failure is the missing FILE, not the dir/source conflict
        assert "ignored" not in str(ei.value)
        assert "nope.pth" in str(ei.value)

    def test_zombie_batch_shed_behind_work_queue(self, params):
        fleet, svc = make_fleet_service(params)
        img = make_image()
        dm = np.zeros((8, 8, 1), np.float32)

        def batch_for(reqs):
            return pad_batch([(r.image, dm) for r in reqs], (64, 64),
                             len(reqs), [True] * len(reqs), 8)

        with svc:
            dead = [ServeRequest(img, deadline_s=-1.0) for _ in range(2)]
            fleet.submit_work((64, 64), batch_for(dead), dead)
            for r in dead:
                with pytest.raises(RejectedError) as ei:
                    r.wait(timeout=30.0)
                assert ei.value.reason == REJECT_DEADLINE
            assert sum(r.batches for r in fleet.replicas) == 0
            assert svc.stats()["rejected"] == 2
            live = ServeRequest(img, deadline_s=None)
            mixed = [ServeRequest(img, deadline_s=-1.0), live]
            fleet.submit_work((64, 64), batch_for(mixed), mixed)
            assert live.wait(timeout=60.0).count is not None
            assert sum(r.batches for r in fleet.replicas) == 1

    def test_submit_with_no_live_replicas_rejects_not_hangs(self, params):
        fleet, svc = make_fleet_service(params)
        for r in fleet.replicas:
            r.state = "quarantined"
        with svc:
            t = svc.submit(make_image(), deadline_ms=5_000)
            with pytest.raises(RejectedError):
                t.result(timeout=30.0)


# --- rollout (tests/test_fleet.py::TestRollout) --------------------------
class TestRollout:
    def test_rollout_under_load_zero_rejects(self, params, params2):
        fleet, svc = make_fleet_service(
            params, run_config={"syncBN": False, "bf16": False})
        img = make_image()
        with svc:
            before = svc.predict(img, timeout=60.0).count
            stop = threading.Event()
            rejected = []

            def load():
                while not stop.is_set():
                    try:
                        svc.predict(img, timeout=60.0)
                    except RejectedError as e:  # pragma: no cover
                        rejected.append(e)

            threads = [threading.Thread(target=load) for _ in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.3)
            traffic_compiles = fleet.compile_count
            report = fleet.rollout(
                params2, run_config={"syncBN": False, "bf16": False})
            time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join(timeout=60.0)
                assert not t.is_alive()
            after = svc.predict(img, timeout=60.0).count
        assert rejected == [] and svc.stats()["rejected"] == 0
        assert report["generation"] == 1
        assert report["flipped"] == [0, 1] and report["skipped"] == []
        assert report["staging_compiles"] >= 1
        # live replicas ran no new signature for the flip
        assert fleet.compile_count == traffic_compiles
        assert all(r.generation == 1 for r in fleet.replicas)
        # the fleet now serves the NEW checkpoint bit for bit
        assert after == fresh_count(params2, img)
        assert after != before

    def test_rollout_drift_guard_and_structure_guard(self, params,
                                                     params2):
        from can_tpu_torch.utils.checkpoint import ConfigDriftError

        fleet, svc = make_fleet_service(
            params, run_config={"syncBN": False, "bf16": False})
        with pytest.raises(ConfigDriftError, match="syncBN"):
            fleet.rollout(params2, run_config={"syncBN": True,
                                               "bf16": False})
        rep = fleet.rollout(params2, run_config={"syncBN": False,
                                                 "bf16": False,
                                                 "lr": 123.0})
        assert rep["generation"] == 1
        rep2 = fleet.rollout(params, run_config={"syncBN": False,
                                                 "bf16": True},
                             allow_config_change=True)
        assert rep2["config_drift"] == ["bf16"]
        bn = {k: torch.from_numpy(v) for k, v in
              random_state_dict(2, batch_norm=True).items()}
        with pytest.raises(ValueError, match="structure"):
            fleet.rollout(bn)

    def test_rollout_before_warmup_raises(self, params, params2):
        fleet = FleetEngine(params, replicas=2, devices=[CPU] * 2)
        with pytest.raises(RuntimeError, match="warmup"):
            fleet.rollout(params2)

    def test_rollout_skips_quarantined_replica(self, params, params2):
        fleet, svc = make_fleet_service(params)
        fleet.replicas[0].state = "quarantined"
        rep = fleet.rollout(params2)
        assert rep["flipped"] == [1] and rep["skipped"] == [0]
        assert fleet.replicas[0].generation == 0
        assert fleet.replicas[1].generation == 1


# --- HTTP front end (tests/test_fleet.py::TestFleetHTTP) -----------------
@contextlib.contextmanager
def http_server(svc):
    httpd = serve_http(svc, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def http_code(req) -> tuple:
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestFleetHTTP:
    def test_healthz_and_rollout_endpoint(self, params, params2):
        fleet, svc = make_fleet_service(
            params, run_config={"syncBN": False, "bf16": False})
        calls = []

        def loader(spec):
            calls.append(spec)
            return params2, {"syncBN": False, "bf16": False}

        svc.rollout_loader = loader
        with svc, http_server(svc) as base:
            code, health = http_code(f"{base}/healthz")
            assert code == 200 and health["ok"] and health["live"] == 2
            assert [x["state"] for x in health["replicas"]] == [
                "active", "active"]
            req = urllib.request.Request(
                f"{base}/rollout", method="POST",
                data=json.dumps({"checkpoint_dir": "ignored"}).encode())
            code, report = http_code(req)
            assert code == 200 and report["generation"] == 1
            assert calls == [{"checkpoint_dir": "ignored"}]
            # quarantined state surfaces on /healthz with ok still true
            fleet.replicas[0].state = "quarantined"
            code, health = http_code(f"{base}/healthz")
            assert code == 200 and health["ok"] and health["live"] == 1
            assert health["replicas"][0]["state"] == "quarantined"
            # zero live replicas: 503, the orchestrator's restart signal
            fleet.replicas[1].state = "quarantined"
            code, health = http_code(f"{base}/healthz")
            assert code == 503 and not health["ok"]

    def test_rollout_bad_spec_is_409_not_dead_socket(self, params,
                                                     tmp_path):
        from can_tpu_torch.cli.serve import make_rollout_loader, parse_args

        fleet, svc = make_fleet_service(params)
        svc.rollout_loader = make_rollout_loader(parse_args([]))
        corrupt = tmp_path / "corrupt.npz"
        corrupt.write_bytes(b"not an npz archive")
        with svc, http_server(svc) as base:
            for body in ({"torch_pth": "a.pth", "params_npz": "b.npz"},
                         {"params_npz": str(corrupt)}):
                req = urllib.request.Request(
                    f"{base}/rollout", method="POST",
                    data=json.dumps(body).encode())
                code, payload = http_code(req)
                assert code == 409, (body, code)
                assert "error" in payload

            def crash(spec):
                raise KeyError("unexpected loader bug")

            svc.rollout_loader = crash
            code, payload = http_code(urllib.request.Request(
                f"{base}/rollout", method="POST", data=b"{}"))
            assert code == 500 and "KeyError" in payload["error"]
        assert fleet.generation == 0  # the serving fleet is untouched

    def test_rollout_without_loader_is_501(self, params):
        fleet, svc = make_fleet_service(params)
        with svc, http_server(svc) as base:
            code, _ = http_code(urllib.request.Request(
                f"{base}/rollout", method="POST", data=b"{}"))
            assert code == 501


# --- CLI flags (tests/test_fleet.py::TestFleetCLI) ------------------------
def cli_args(tmp_path, argv):
    from can_tpu_torch.cli.serve import parse_args

    pth = tmp_path / "a.pth"
    pth.write_bytes(b"")
    return parse_args(["--torch-pth", str(pth), "--platform", "cpu"] + argv)


class TestFleetCLI:
    def test_parse_fleet_flags(self):
        from can_tpu_torch.cli.serve import parse_args

        args = parse_args(["--replicas", "4", "--serve-dtype", "int8"])
        assert args.replicas == 4 and args.serve_dtype == "int8"
        assert parse_args([]).replicas == 1
        assert parse_args([]).serve_dtype == "f32"

    def test_legacy_bf16_conflicts_with_serve_dtype(self, tmp_path):
        from can_tpu_torch.cli.serve import build_service

        with pytest.raises(SystemExit, match="legacy"):
            build_service(cli_args(tmp_path, ["--bf16", "--serve-dtype",
                                              "bf16"]))

    def test_replicas_validated(self, tmp_path):
        from can_tpu_torch.cli.serve import build_service

        with pytest.raises(SystemExit, match="replicas"):
            build_service(cli_args(tmp_path, ["--replicas", "0"]))


# --- what the port adds -------------------------------------------------
def test_no_devices_and_no_gpu_raises_never_falls_back(params,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="no CUDA device"):
        FleetEngine(params, replicas=2)


def test_aot_refused_naming_item_3c(params, tmp_path):
    """AOT bundles are ported (tests/test_torch_aot.py); what is refused
    now is what JAX refuses: a directory without a bundle, and a bake
    before warmup."""
    from can_tpu_torch.serve import AotStaleError

    with pytest.raises(AotStaleError) as e:
        FleetEngine(params, replicas=2, devices=[CPU] * 2,
                    aot_bundle=str(tmp_path / "bundle"))
    assert e.value.axis == "manifest"
    fleet = FleetEngine(params, replicas=2, devices=[CPU] * 2)
    with pytest.raises(RuntimeError, match="before warmup"):
        fleet.bake_aot(str(tmp_path / "x"))
    with pytest.raises(AotStaleError, match="absent or torn"):
        fleet.load_aot(str(tmp_path / "x"))


def test_spare_slots_count_a_repeated_device_per_slot(params):
    fleet = FleetEngine(params, replicas=2, devices=[CPU] * 3)
    assert fleet.spare_devices() == [CPU]  # JAX's `in` test would see none
    assert [r.slot for r in fleet.replicas] == [0, 1]


def test_serve_on_steers_a_batch_to_each_replica(params):
    """Work steered to a replica (the others' dispatch locks held) is
    served there, whatever split the queue would take, and every count is
    a fresh engine's.  (What the others serve is not bounded: each serves
    the batch it held once released, and may take lone requests that were
    submitted while the target was still busy.)"""
    fleet, svc = make_fleet_service(params)
    img = make_image()
    want = fresh_count(params, img)
    with svc:
        for k in (0, 1):
            before = [r.batches for r in fleet.replicas]
            results = serve_on(fleet, svc, k, img)
            after = [r.batches for r in fleet.replicas]
            assert after[k] > before[k]
            np.testing.assert_allclose([r.count for r in results],
                                       want, rtol=RTOL, atol=ATOL)
    st = svc.stats()
    assert st["rejected"] == 0
    assert all(v["batches"] >= 1 for v in st["replicas"].values())


class GuardRecorder:
    """Stands in for the fleet's device guard: records who entered it for
    which device, and whether the calling thread is inside one now."""

    def __init__(self):
        self.entered = []
        self._depth = threading.local()

    def inside(self) -> bool:
        return getattr(self._depth, "n", 0) > 0

    def __call__(self, device):
        @contextlib.contextmanager
        def guard():
            self.entered.append((threading.current_thread().name,
                                 str(device)))
            self._depth.n = getattr(self._depth, "n", 0) + 1
            try:
                yield
            finally:
                self._depth.n -= 1
        return guard()


def test_worker_probe_and_staging_run_inside_the_device_guard(
        params, params2, monkeypatch):
    """Every body that does device work — the replica workers, a probe,
    rollout's staging and flips, scale-up, every release — runs inside
    the fleet's device guard (on the card: ``torch.cuda.device``, since
    the current device is per thread and a new thread starts on 0)."""
    rec = GuardRecorder()
    monkeypatch.setattr(fleet_mod, "_device_guard", rec)
    outside = []
    for meth in ("predict_batch", "warmup", "release_buffers",
                 "swap_params"):
        orig = getattr(ServeEngine, meth)

        def checked(self, *a, _orig=orig, _meth=meth, **kw):
            if not rec.inside():
                outside.append((_meth, threading.current_thread().name))
            return _orig(self, *a, **kw)

        monkeypatch.setattr(ServeEngine, meth, checked)
    fleet, svc = make_fleet_service(params, fleet_kw={"self_heal": False})
    img = make_image()
    with svc:
        for t in [svc.submit(img, deadline_ms=60_000) for _ in range(6)]:
            t.result(timeout=60.0)
        fleet._quarantine(fleet.replicas[0],
                          _WorkItem((64, 64), one_batch(img), []),
                          RuntimeError("induced"))
        fleet.maintenance_tick(now=fleet.replicas[0].probe_at)
        fleet.join_probes(60.0)
        assert fleet.live_replicas() == 2
        fleet.rollout(params2)
        fleet.add_replica(reason="test")
        fleet.remove_replica(reason="test")
        svc.predict(img, timeout=60.0)
    assert outside == []
    threads = {name for name, _ in rec.entered}
    assert {"can-tpu-fleet-r0", "can-tpu-fleet-r1",
            "can-tpu-fleet-probe-r0"} <= threads
    assert {dev for _, dev in rec.entered} == {"cpu"}


def replica_tensors(engine, host_tree) -> list:
    """The engine's own weight tensors (not the host tree's storage,
    which CPU placement may share)."""
    host = {id(t) for v in host_tree.values()
            for t in (v.values() if isinstance(v, dict) else (v,))}
    out = []
    for v in engine.params.values():
        for t in (v.values() if isinstance(v, dict) else (v,)):
            if id(t) not in host:
                out.append(t)
    return out


def test_quarantine_and_scale_down_leave_no_tensor_of_the_replica(params):
    """After ``_quarantine`` and after ``remove_replica`` nothing in the
    fleet — replica list, work item, staging — holds a weight tensor of
    the replica that left."""
    fleet, svc = make_fleet_service(params, fleet_kw={"self_heal": False})
    total = sum(t.numel() * t.element_size()
                for t in replica_tensors(fleet.replicas[0].engine, {}))
    refs = {}
    for r in fleet.replicas:
        mine = replica_tensors(r.engine, fleet._host_q)
        # the 4-D convolution weights, channels_last copies: the bulk
        assert sum(t.numel() * t.element_size() for t in mine) > 0.99 * total
        refs[r.index] = [weakref.ref(t) for t in mine]
        del mine
    img = make_image()
    with svc:
        item = _WorkItem((64, 64), one_batch(img),
                         [ServeRequest(img, deadline_s=None)])
        fleet._quarantine(fleet.replicas[0], item, RuntimeError("induced"))
        gc.collect()
        assert all(w() is None for w in refs[0])
        assert all(w() is not None for w in refs[1])
        fleet.add_replica(reason="test")
        new = fleet.replicas[-1]
        new_refs = [weakref.ref(t)
                    for t in replica_tensors(new.engine, fleet._host_q)]
        fleet.remove_replica(reason="test")
        gc.collect()
        assert new not in fleet.replicas
        assert all(w() is None for w in new_refs)
        assert item.requests[0].wait(timeout=60).count is not None


def test_rollout_staging_engine_is_released(params, params2, monkeypatch):
    fleet, svc = make_fleet_service(params)
    staged = []
    build = fleet._engine

    def spy(device, name, tree=None):
        eng = build(device, name, tree)
        if "staging" in name:
            staged.append([weakref.ref(t) for t in replica_tensors(eng, {})
                           if t.dim() == 4])
        return eng

    monkeypatch.setattr(fleet, "_engine", spy)
    fleet.rollout(params2)
    gc.collect()
    assert len(staged) == 1 and staged[0]
    assert all(w() is None for w in staged[0])


def test_stream_pins_follow_live_replicas(params):
    """A stream's first completion pins it to the serving replica's
    incarnation; after that replica leaves dispatch the next batch is
    re-pinned to a live one before it queues."""
    events = Events()
    fleet, svc = make_fleet_service(params, telemetry=events,
                                    degrade_policy="off")
    img = make_image()
    with svc:
        svc.predict(img, stream_id="cam1", frame_seq=1, timeout=60.0)
        idx, token = svc.streams.get("cam1").pin
        assert fleet.live_tokens()[idx] == token == f"serve_predict_r{idx}"
        fleet.replicas[idx].state = "quarantined"
        svc.predict(img, stream_id="cam1", frame_seq=2, timeout=60.0)
        new_idx, new_token = svc.streams.get("cam1").pin
    assert new_idx == 1 - idx and new_token == f"serve_predict_r{new_idx}"
    repins = events.of("stream.repin")
    assert [(p["from_replica"], p["to_replica"]) for p in repins] == [
        (idx, new_idx)]


def test_launch_counters_keep_every_increment_across_threads():
    """Fleet replicas launch the context kernel from several threads: the
    counters' increments hold a lock (a thread that bumps while another
    holds it waits), and 8 threads' bumps all land."""
    from can_tpu_torch.ops import cuda_bn as cb
    from can_tpu_torch.ops import cuda_context as cc

    with cc._launches_lock:
        t = threading.Thread(target=cc._count_launch)
        before = cc.LAUNCHES
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and cc.LAUNCHES == before  # waits on the lock
    t.join(timeout=30.0)
    assert not t.is_alive() and cc.LAUNCHES == before + 1

    n = 5000
    start = (cc.LAUNCHES, cb.LAUNCHES, cb.BACKWARD_LAUNCHES)

    def bump():
        for _ in range(n):
            cc._count_launch()
            cb._count_launch()
            cb._count_launch(backward=True)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert (cc.LAUNCHES, cb.LAUNCHES, cb.BACKWARD_LAUNCHES) == tuple(
        s + 8 * n for s in start)


def test_cli_builds_the_fleet_where_the_universe_allows(tmp_path, he, he2,
                                                         params2,
                                                         monkeypatch):
    """``--replicas 2`` with a two-slot universe (the one CPU listed twice
    in place of two GPUs): the CLI builds the fleet with its flags, arms
    the autoscaler with the request deadline as its p99 bound, and wires
    ``/rollout`` through the eval CLI's loader."""
    from can_tpu.utils.torch_import import export_state_dict
    from can_tpu_torch.cli import serve as cli

    paths = []
    for i, p in enumerate((he, he2)):
        paths.append(tmp_path / f"w{i}.pth")
        torch.save({k: torch.from_numpy(np.copy(v))
                    for k, v in export_state_dict(p).items()}, paths[-1])
    monkeypatch.setattr(cli, "fleet_devices", lambda platform: [CPU] * 3)
    args = cli.parse_args([
        "--torch-pth", str(paths[0]), "--platform", "cpu", "--replicas", "2",
        "--bucket-shapes", "64x64", "--max-batch", "2",
        "--dispatch-order", "fifo", "--probe-cooldown-s", "0.5",
        "--watchdog-default-s", "7", "--deadline-ms", "900",
        "--autoscale-max", "3", "--autoscale-interval-s", "0.2"])
    svc = cli.build_service(args)
    fleet = svc.engine
    assert isinstance(fleet, FleetEngine) and fleet.live_replicas() == 2
    assert (fleet.dispatch_order, fleet.probe_cooldown_s,
            fleet.watchdog_default_s) == ("fifo", 0.5, 7.0)
    assert fleet.compile_count == 2 * len(svc.sched.menu)
    pol = svc.autoscaler.policy
    assert (pol.min_replicas, pol.max_replicas, pol.p99_high_s,
            pol.interval_s) == (2, 3, 0.9, 0.2)
    img = make_image()
    with svc:
        before = svc.predict(img, timeout=60.0).count
        sd, run_config = svc.rollout_loader({"torch_pth": str(paths[1])})
        assert run_config is None  # an imported .pth carries none
        assert svc.rollout(sd, run_config=run_config)["generation"] == 1
        after = svc.predict(img, timeout=60.0).count
    assert after == fresh_count(params2, img) and after != before
    assert svc.autoscaler._thread is None  # stopped with the service
