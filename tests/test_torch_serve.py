"""can_tpu_torch.serve on the CPU: engine counts against the JAX
ServeEngine, host-side helpers against their JAX counterparts, the
queue/batcher contract (a mirror of tests/test_serve.py's TestQueue and
TestBatcherFlush cases), and an HTTP round trip through the CLI path.
"""

import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from can_tpu.data import batching as jbatching
from can_tpu.serve import ServeEngine as JaxServeEngine
from can_tpu.serve import prepare_image as jax_prepare_image
from can_tpu.train import loss as jloss
from can_tpu.train.steps import normalize_on_device as jax_normalize_on_device
from can_tpu.utils.torch_import import export_state_dict
from can_tpu_torch.cli import serve as cli
from can_tpu_torch.data import pad_batch, snap_to_bucket
from can_tpu_torch.serve import (
    REJECT_BACKPRESSURE,
    REJECT_DEADLINE,
    REJECT_ERROR,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    BoundedRequestQueue,
    MicroBatcher,
    RejectedError,
    ServeEngine,
    ServeRequest,
    ServeResult,
    prepare_image,
    quantize_tree,
    serve_http,
)
from can_tpu_torch.train import density_counts, masked_mse_sum, normalize_on_device
from can_tpu_torch.utils.profiling import StepTimer
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from tests.test_torch_model import jax_params

DS = 8


@pytest.fixture(scope="module")
def he_params():
    return jax_params("he")


@pytest.fixture(scope="module")
def engines(he_params):
    port = ServeEngine(state_dict_from_jax_params(he_params), device="cpu")
    jaxe = JaxServeEngine(jax.tree.map(np.asarray, he_params))
    return port, jaxe


def _batch(dtype, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for h, w in [(64, 64), (56, 40), (48, 64)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if dtype == "f32":
            img = prepare_image(img)
        items.append((img, np.zeros((h // DS, w // DS, 1), np.float32)))
    return pad_batch(items, (64, 64), 4, [True] * 3, DS)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_engine_counts_match_jax_engine(engines, dtype):
    port, jaxe = engines
    batch = _batch(dtype)
    got, dens = port.predict_batch(batch, want_density=True)
    want, wdens = jaxe.predict_batch(batch, want_density=True)
    assert got.shape == (4,) and got[3] == 0.0  # the fill slot counts zero
    assert np.abs(want).max() > 1.0  # He-scaled weights: real counts
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dens, wdens, rtol=1e-3, atol=1e-4)


def test_engine_warmup_signatures_and_release(he_params):
    eng = ServeEngine(state_dict_from_jax_params(he_params), device="cpu")
    rep = eng.warmup([(64, 64), (64, 96)], 2, dtypes=(np.float32, np.uint8))
    assert rep["shapes"] == 2 and rep["compiles"] == 4 == eng.compile_count
    assert eng.warmup([(64, 64)], 2)["compiles"] == 0
    eng.release_buffers()
    with pytest.raises(RuntimeError, match="released"):
        eng.predict_batch(_batch("f32"))


@pytest.fixture(scope="module")
def bf16_engines(he_params):
    port = ServeEngine(state_dict_from_jax_params(he_params), device="cpu",
                       serve_dtype="bf16")
    jaxe = JaxServeEngine(jax.tree.map(np.asarray, he_params),
                          serve_dtype="bf16")
    return port, jaxe


BF16_U = 2.0 ** -8  # bf16 unit roundoff; the bf16 tolerances are multiples


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_bf16_engine_matches_jax_bf16_engine(engines, bf16_engines, dtype):
    """The port's bf16 serving path (bf16 weights and activations, f32
    accumulation) against the JAX ServeEngine's bf16 mode on one batch.

    Two bf16 pipelines round at slightly different points (XLA on the CPU
    folds some of the bf16 round trips away) and the one-ulp differences
    compound over 17 layers, so they agree to a few bf16 roundings, not to
    f32 noise.  The last check is the one an engine computing in f32
    fails: the port's f32 engine departs from the f32 answer about 2e-4
    times as far as the JAX bf16 engine does."""
    _, jax32 = engines
    port16, jax16 = bf16_engines
    assert all(p.dtype == torch.bfloat16 for p in port16.model.parameters())
    batch = _batch(dtype)
    got, dens = port16.predict_batch(batch, want_density=True)
    want, wdens = jax16.predict_batch(batch, want_density=True)
    _, f32 = jax32.predict_batch(batch, want_density=True)
    scale = np.abs(f32).max()
    mass = np.abs(wdens).reshape(len(want), -1).sum(1)  # each count's scale
    assert scale > 1e-2 and np.abs(want).max() > 1.0  # not vacuous
    assert np.all(np.abs(got - want) <= 4 * BF16_U * mass)
    assert np.abs(dens - wdens).max() <= 8 * BF16_U * scale
    assert np.abs(dens - wdens).mean() <= BF16_U * scale
    ratio = np.abs(dens - f32).mean() / np.abs(wdens - f32).mean()
    assert 0.5 <= ratio <= 2.0, ratio


def test_bf16_engine_tracks_f32(engines, bf16_engines):
    """Port against port, beside the JAX check above: the bf16 counts stay
    within two bf16 roundings of the f32 ones on each count's scale (the
    sum of |map|: a count is a cancelling sum, so relative to a small
    count the same error looks large), the map within one on average —
    and the bf16 map really was rounded: it is not the f32 one."""
    port, _ = engines
    bf, _ = bf16_engines
    batch = _batch("u8")
    want, wdens = port.predict_batch(batch, want_density=True)
    got, dens = bf.predict_batch(batch, want_density=True)
    mass = np.abs(wdens).reshape(len(want), -1).sum(1)
    assert np.all(np.abs(got - want) <= 2 * BF16_U * mass)
    dev = np.abs(dens - wdens).mean() / np.abs(wdens).max()
    assert 0.1 * BF16_U <= dev <= BF16_U, dev / BF16_U


def test_quant_modes():
    sd = {"w": torch.ones(2, 2), "n": torch.arange(3)}
    assert quantize_tree(sd, "f32")["w"].dtype == torch.float32
    q = quantize_tree(sd, "bf16")
    assert q["w"].dtype == torch.bfloat16 and q["n"].dtype == torch.int64
    # int8 is a real mode: the 2-D weight becomes an int8 leaf with one
    # f32 scale per output channel; the integer tensor stays as it is
    q8 = quantize_tree(sd, "int8")
    assert q8["w"]["q"].dtype == torch.int8 and q8["w"]["q"].tolist() == [
        [127, 127], [127, 127]]
    np.testing.assert_array_equal(q8["w"]["scale"].numpy(),
                                  np.full(2, np.float32(1) / np.float32(127)))
    assert q8["n"].dtype == torch.int64
    with pytest.raises(ValueError):
        quantize_tree(sd, "fp8")


def test_normalize_losses_match_jax():
    rng = np.random.default_rng(4)
    batch = _batch("u8", seed=4)
    got = normalize_on_device(torch.from_numpy(batch.image),
                              torch.from_numpy(batch.pixel_mask))
    want = jax_normalize_on_device(batch.image, batch.pixel_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    pred = rng.standard_normal(batch.dmap.shape).astype(np.float32)
    dmap = rng.random(batch.dmap.shape).astype(np.float32)
    tb = {"dmap": torch.from_numpy(dmap),
          "pixel_mask": torch.from_numpy(batch.pixel_mask),
          "sample_mask": torch.from_numpy(batch.sample_mask)}
    jb = {"dmap": dmap, "pixel_mask": batch.pixel_mask,
          "sample_mask": batch.sample_mask}
    et, gt = density_counts(torch.from_numpy(pred), tb)
    jet, jgt = jloss.density_counts(pred, jb)
    np.testing.assert_allclose(et.numpy(), np.asarray(jet), rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=1e-6)
    np.testing.assert_allclose(float(masked_mse_sum(torch.from_numpy(pred), tb)),
                               float(jloss.masked_mse_sum(pred, jb)), rtol=1e-6)


def test_snap_to_bucket_and_pad_batch_match_jax():
    ladder = ((384, 512, 768), (512, 768, 1024))
    for h in range(8, 1100, 24):
        for w in range(8, 1300, 40):
            for kw in ({"ladder": ladder}, {"pad_multiple": (64, 32)},
                       {"ladder": ladder, "min_bucket_h": 512}, {}):
                assert (snap_to_bucket((h, w), **kw)
                        == jbatching.snap_to_bucket((h, w), **kw)), (h, w, kw)
    rng = np.random.default_rng(5)
    items = [(rng.random((h, w, 3)).astype(np.float32),
              rng.random((h // DS, w // DS, 1)).astype(np.float32))
             for h, w in [(64, 48), (32, 64)]]
    got = pad_batch(items, (64, 64), 3, [True, False], DS)
    want = jbatching.pad_batch(items, (64, 64), 3, [True, False], DS)
    for f in ("image", "dmap", "pixel_mask", "sample_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("hw", [(61, 90), (100, 77), (64, 96), (9, 17)])
def test_prepare_image_matches_cv2_path(hw):
    """The numpy resize stands in for cv2.resize (absent on the card's
    machine): within one u8 level, and f32 within float noise."""
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = prepare_image(img, normalize=False)
    want = jax_prepare_image(img, normalize=False)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    f32 = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(prepare_image(f32, normalize=False),
                               jax_prepare_image(f32, normalize=False),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prepare_image(img), jax_prepare_image(img),
                               atol=1.01 / 255 / 0.224)


def test_step_timer_reservoir():
    assert StepTimer().percentiles()["n"] == 0
    # skip_first=0: the serving reservoir's setting (the default skips two
    # samples, as the JAX package's StepTimer does)
    t = StepTimer(skip_first=0, reservoir=3)
    for dt in (9.0, 1.0, 2.0, 3.0):  # the oldest sample falls out
        t.record(dt)
    p = t.percentiles()
    assert p["n"] == 3 and p["p50_s"] == 2.0 and p["max_s"] == 3.0


# -- mirror of tests/test_serve.py TestQueue / TestBatcherFlush -----------
class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def req(h=64, w=64, deadline_s=None, clock=None, dtype=np.float32):
    return ServeRequest(np.zeros((h, w, 3), dtype), deadline_s=deadline_s,
                        clock=clock or (lambda: 0.0))


def _result():
    return ServeResult(count=0.0, density=None, bucket_hw=(64, 64),
                       batch_fill=1.0, latency_s=0.0)


class TestQueue:
    def test_fifo_admit_and_drain(self):
        q = BoundedRequestQueue(4)
        rs = [req(), req()]
        assert all(q.offer(r) is None for r in rs)
        assert q.depth() == 2
        live, expired = q.drain()
        assert live == rs and expired == []
        assert q.depth() == 0

    def test_capacity_rejects_queue_full(self):
        q = BoundedRequestQueue(2)
        assert q.offer(req()) is None
        assert q.offer(req()) is None
        r = req()
        assert q.offer(r) == REJECT_QUEUE_FULL
        assert r.done
        with pytest.raises(RejectedError) as e:
            r.wait(0)
        assert e.value.reason == REJECT_QUEUE_FULL

    def test_backpressure_hysteresis_on_outstanding(self):
        q = BoundedRequestQueue(16, high_water=4, low_water=2)
        admitted = [req() for _ in range(4)]
        for r in admitted:
            assert q.offer(r) is None
        assert q.outstanding() == 4
        assert q.offer(req()) == REJECT_BACKPRESSURE
        assert q.shedding
        live, _ = q.drain()
        assert len(live) == 4 and q.depth() == 0
        assert q.shedding
        assert q.offer(req()) == REJECT_BACKPRESSURE
        admitted[0].resolve(_result())
        assert q.outstanding() == 3
        assert q.offer(req()) == REJECT_BACKPRESSURE
        admitted[1].resolve(_result())
        assert q.outstanding() == 2
        assert not q.shedding
        assert q.offer(req()) is None

    def test_drain_splits_expired(self):
        clock = FakeClock()
        q = BoundedRequestQueue(8, clock=clock)
        fresh = req(deadline_s=10.0, clock=clock)
        stale = req(deadline_s=0.5, clock=clock)
        q.offer(fresh)
        q.offer(stale)
        clock.t = 1.0
        live, expired = q.drain()
        assert live == [fresh] and expired == [stale]

    def test_close_stops_admission(self):
        q = BoundedRequestQueue(4)
        q.offer(req())
        assert len(q.close()) == 1
        assert q.offer(req()) == REJECT_SHUTDOWN

    def test_wait_timeout_is_typed_not_hang(self):
        with pytest.raises(RejectedError):
            req().wait(0.01)


class CollectDispatch:
    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def __call__(self, bucket_hw, batch, requests):
        if self.fail:
            raise RuntimeError("boom")
        self.calls.append((bucket_hw, batch, requests))
        for r in requests:
            r.resolve(_result())


class TestBatcherFlush:
    def make(self, dispatch, *, max_batch=4, max_wait_ms=100.0, ladder=None):
        clock = FakeClock()
        q = BoundedRequestQueue(64, clock=clock)
        b = MicroBatcher(q, dispatch, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, bucket_ladder=ladder,
                         clock=clock)
        return q, b, clock

    def test_flush_on_max_batch_is_immediate(self):
        d = CollectDispatch()
        q, b, clock = self.make(d, max_batch=3)
        for _ in range(3):
            q.offer(req(64, 64, clock=clock))
        assert b.intake() == 1
        (bucket, batch, _), = d.calls
        assert bucket == (64, 64)
        assert batch.image.shape == (3, 64, 64, 3)
        assert batch.sample_mask.tolist() == [1.0, 1.0, 1.0]

    def test_partial_batch_waits_then_flushes_on_max_wait(self):
        d = CollectDispatch()
        q, b, clock = self.make(d, max_batch=4, max_wait_ms=100.0)
        q.offer(req(64, 64, clock=clock))
        q.offer(req(64, 64, clock=clock))
        b.intake()
        assert b.poll(clock.t) == 0 and not d.calls
        clock.t = 0.099
        assert b.poll(clock.t) == 0
        clock.t = 0.1
        assert b.poll(clock.t) == 1
        (_, batch, requests), = d.calls
        assert batch.image.shape == (4, 64, 64, 3)
        assert batch.sample_mask.tolist() == [1.0, 1.0, 0.0, 0.0]
        assert len(requests) == 2

    def test_mixed_buckets_group_independently(self):
        d = CollectDispatch()
        q, b, clock = self.make(d, max_batch=2, ladder=((64, 96), (64, 96)))
        q.offer(req(64, 64, clock=clock))
        q.offer(req(96, 96, clock=clock))
        q.offer(req(60, 60, clock=clock))
        assert b.intake() == 1
        assert d.calls[0][0] == (64, 64)
        assert b.pending_count() == 1
        clock.t = 1.0
        assert b.poll(clock.t) == 1
        assert d.calls[1][0] == (96, 96)

    def test_dtype_never_mixes_in_one_batch(self):
        d = CollectDispatch()
        q, b, clock = self.make(d, max_batch=2)
        q.offer(req(64, 64, clock=clock, dtype=np.float32))
        q.offer(req(64, 64, clock=clock, dtype=np.uint8))
        b.intake()
        assert not d.calls
        clock.t = 1.0
        assert b.poll(clock.t) == 2
        assert {c[1].image.dtype for c in d.calls} == {np.dtype(np.float32),
                                                       np.dtype(np.uint8)}

    def test_expired_request_rejected_never_dispatched(self):
        d = CollectDispatch()
        q, b, clock = self.make(d, max_batch=2, max_wait_ms=50.0)
        doomed = req(64, 64, deadline_s=0.01, clock=clock)
        q.offer(doomed)
        b.intake()
        clock.t = 0.02
        assert b.poll(clock.t) == 0
        assert doomed.done and not d.calls
        with pytest.raises(RejectedError) as e:
            doomed.wait(0)
        assert e.value.reason == REJECT_DEADLINE

    def test_dispatch_error_rejects_requests_keeps_batcher(self):
        d = CollectDispatch(fail=True)
        q, b, clock = self.make(d, max_batch=1)
        r = req(64, 64, clock=clock)
        q.offer(r)
        b.intake()
        with pytest.raises(RejectedError) as e:
            r.wait(0)
        assert e.value.reason == REJECT_ERROR
        d.fail = False
        r2 = req(64, 64, clock=clock)
        q.offer(r2)
        b.intake()
        assert r2.done and r2.wait(0).count == 0.0

    def test_bucket_mapping_matches_snap_to_bucket(self):
        ladder = ((64, 128), (96, 160))
        b = MicroBatcher(BoundedRequestQueue(4), lambda *a: None,
                         bucket_ladder=ladder)
        for hw in [(64, 96), (65, 96), (128, 160), (200, 300), (8, 8)]:
            assert b.bucket_of(hw) == jbatching.snap_to_bucket(hw, ladder=ladder)

    def test_flush_all_drains_pending(self):
        d = CollectDispatch()
        q, b, clock = self.make(d, max_batch=8)
        q.offer(req(64, 64, clock=clock))
        q.offer(req(96, 96, clock=clock))
        b.intake()
        assert b.flush_all() == 2
        assert b.pending_count() == 0


# -- HTTP round trip through the CLI path on --platform cpu ---------------
def _post(port, arr, query=""):
    buf = io.BytesIO()
    np.save(buf, arr)
    rq = urllib.request.Request(f"http://127.0.0.1:{port}/predict?{query}",
                                data=buf.getvalue(), method="POST")
    try:
        with urllib.request.urlopen(rq, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def test_http_round_trip_cpu(tmp_path, he_params, engines):
    pth = tmp_path / "ref.pth"
    torch.save({k: torch.from_numpy(np.copy(v))
                for k, v in export_state_dict(he_params).items()}, pth)
    args = cli.parse_args(["--torch-pth", str(pth), "--platform", "cpu",
                           "--bucket-shapes", "64x64,64x96", "--max-batch", "2",
                           "--max-wait-ms", "1", "--u8-warmup", "--port", "0",
                           "--max-body-mb", "0.5"])
    service = cli.build_service(args)
    menu = service.sched.menu
    assert menu == (2, 1)  # the priced menu at --max-batch 2
    # 2 buckets x 2 menu sizes x (f32, u8)
    assert service.engine.compile_count == 2 * len(menu) * 2 == 8
    img = np.random.default_rng(6).integers(0, 256, (61, 90, 3), dtype=np.uint8)
    with service:
        httpd = serve_http(service, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            assert _get(port, "/healthz") == (200, {"ok": True})
            code, res = _post(port, img, "density=1")
            assert code == 200, res
            assert res["bucket"] == [64, 96] and res["trace_id"]
            assert np.array(res["density"]).shape == (7, 11)
            code, raw = _post(port, img, "raw=1")
            assert code == 200
            np.testing.assert_allclose(raw["count"], res["count"], rtol=1e-5)
            # the served count is the JAX engine's for the same image
            x = prepare_image(img)
            batch = pad_batch([(x, np.zeros((7, 11, 1), np.float32))],
                              (64, 96), 2, [True], DS)
            want = engines[1].predict_batch(batch)[0][0]
            np.testing.assert_allclose(res["count"], want, rtol=1e-3, atol=1e-4)
            code, st = _post(port, img, "stream_id=cam1")  # a session
            assert code == 200 and st["degraded"] is False
            assert _post(port, img.astype(np.float32), "raw=1")[0] == 400
            # over the 0.5 MiB cap: refused from the header, body unread
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Length", str(2 ** 20))
            conn.endheaders()
            assert conn.getresponse().status == 413
            conn.close()
            big = np.zeros((400, 400, 3), np.uint8)  # ~0.46 MiB of npy + hdr
            assert _post(port, big)[0] == 400  # exceeds the largest bucket
            code, stats = _get(port, "/stats")
            assert code == 200 and stats["completed"] == 3
            assert stats["compile_count"] == 8  # traffic added none
            assert stats["sched"]["cost_mismatches"] == 0
        finally:
            httpd.shutdown()
            httpd.server_close()


@pytest.mark.parametrize("argv,match", [
    # int8 serves now (test_int8_cli_serves); its one refusal is the
    # legacy --bf16 beside it
    pytest.param(["--serve-dtype", "int8", "--bf16"], "--bf16 is the legacy",
                 id="argv0-int8"),
    (["--checkpoint-dir", "/nonexistent"], "checkpoint-dir is ignored"),
    (["--params-npz", "x.npz"], "OR"),
    ([], None),
])
def test_cli_refusals(tmp_path, argv, match):
    pth = tmp_path / "a.pth"
    pth.write_bytes(b"")
    base = [] if argv == [] else ["--torch-pth", str(pth)]
    args = cli.parse_args(base + argv + ["--platform", "cpu"])
    with pytest.raises(SystemExit) as e:
        cli.build_service(args)
    if match is not None:
        assert match in str(e.value)


# -- the scheduling core in the service (priced menu and flush) ----------
class Events:
    """A telemetry stand-in: records ``emit(kind, **payload)``."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))


def _image(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_menu_warmup_compile_count(engines):
    """Warmup runs every (bucket, menu size, dtype); traffic at every flush
    size then adds no signature."""
    from can_tpu.sched import default_serve_menu as jax_menu
    from can_tpu_torch.serve import CountService

    eng = ServeEngine(engines[0].params, device="cpu")
    svc = CountService(eng, max_batch=4, max_wait_ms=1.0,
                       bucket_ladder=((64,), (64, 96)))
    menu = svc.sched.menu
    assert menu == jax_menu(4)
    rep = svc.warmup([(64, 64), (64, 96)], dtypes=(np.float32, np.uint8))
    assert rep["sizes"] == len(menu)
    assert eng.compile_count == rep["compiles"] == 2 * len(menu) * 2
    for n in range(1, 5):  # one flush of each size, by hand
        for i in range(n):
            svc.submit(_image(seed=i))
        svc.batcher.intake()
        svc.batcher.flush_all()
    assert eng.compile_count == 2 * len(menu) * 2
    assert not eng.last_batch_compiled
    svc.queue.close()


def test_predicted_equals_realized_per_batch(engines):
    """Every launch of a flush of n requests is the core's cover: its size
    is ``cover_one(valid)``, and predicted cost == realized cost on every
    serve.batch record."""
    from can_tpu_torch.sched import costs_match
    from can_tpu_torch.serve import CountService

    tel = Events()
    svc = CountService(engines[0], max_batch=8, max_wait_ms=1.0,
                       bucket_ladder=((64,), (64,)), telemetry=tel)
    for n in range(1, 12):
        tickets = [svc.submit(_image(seed=i)) for i in range(n)]
        svc.batcher.intake()
        svc.batcher.flush_all()
        assert all(t.done for t in tickets)
    batches = [p for k, p in tel.events if k == "serve.batch"]
    assert sum(b["valid"] for b in batches) == sum(range(1, 12))
    for b in batches:
        assert b["size"] == svc.sched.cover_one(b["valid"]) in svc.sched.menu
        assert costs_match(b["predicted_cost_px"], b["realized_cost_px"])
    st = svc.stats()["sched"]
    assert st["cost_mismatches"] == 0 and st["priced"]
    assert st["predicted_cost_px_per_batch"] == st["realized_cost_px_per_batch"]
    assert sum(st["launches_by_size"].values()) == len(batches)
    assert set(st["launches_by_size"]) > {"8"}  # not every launch is full
    svc.queue.close()


def test_budget1_timer_is_the_service_without_the_core(engines):
    """``menu_budget=1, flush_policy="timer"`` runs no core: every launch
    pads to max_batch and flushes on the fixed timer — the same launches,
    at the same times, as JAX's batcher without a core, and counts equal
    to one max_batch-slot batch of the engine."""
    from can_tpu.serve import BoundedRequestQueue as JQ
    from can_tpu.serve import MicroBatcher as JB
    from can_tpu.serve import ServeRequest as JR
    from can_tpu_torch.serve import CountService

    svc = CountService(engines[0], max_batch=4, max_wait_ms=5.0,
                       bucket_ladder=((64,), (64,)), menu_budget=1,
                       flush_policy="timer")
    assert svc.sched is None and svc.batcher.sched is None
    assert svc.stats()["sched"]["menu"] == [4]
    assert CountService(engines[0], menu_budget=1).sched.menu == (8,)
    assert svc.warmup([(64, 64)])["compiles"] in (0, 1)
    img = _image(seed=9)
    t = svc.submit(img)
    svc.batcher.intake()
    svc.batcher.flush_all()
    got = t.result(timeout=5.0)
    batch = pad_batch([(img, np.zeros((8, 8, 1), np.float32))], (64, 64), 4,
                      [True], DS)
    assert got.count == float(engines[0].predict_batch(batch)[0][0])
    assert got.batch_fill == 0.25
    svc.queue.close()

    def run(batcher_cls, queue_cls, request_cls):
        clock = FakeClock()
        launches = []

        def dispatch(bucket, batch, reqs):
            launches.append((clock.t, batch.image.shape[0], len(reqs)))

        q = queue_cls(64, clock=clock)
        b = batcher_cls(q, dispatch, max_batch=4, max_wait_ms=5.0,
                        clock=clock)
        for step in range(40):
            clock.t = round(clock.t + (0.001 if step % 7 else 0.02), 6)
            for _ in range(step % 3):
                q.offer(request_cls(np.zeros((64, 64, 3), np.float32),
                                    deadline_s=None, clock=clock))
            b.intake()
            b.poll(clock.t)
        b.flush_all()
        return launches

    mine = run(MicroBatcher, BoundedRequestQueue, ServeRequest)
    assert mine == run(JB, JQ, JR)
    assert {size for _, size, _ in mine} == {4}


def test_swap_params_flips_weights_without_new_signatures(he_params):
    from tests.test_torch_model import jax_params

    eng = ServeEngine(state_dict_from_jax_params(he_params), device="cpu")
    eng.warmup([(64, 64)], 4)
    n = eng.compile_count
    sd2 = state_dict_from_jax_params(jax_params("he", seed=1))
    batch = _batch("f32", seed=2)
    before = eng.predict_batch(batch)[0]
    eng.swap_params(sd2)
    assert eng.compile_count == n and not eng.last_batch_compiled
    got = eng.predict_batch(batch)[0]
    fresh = ServeEngine(sd2, device="cpu").predict_batch(batch)[0]
    np.testing.assert_array_equal(got, fresh)
    assert not np.allclose(got, before)
    assert eng.compile_count == n  # the warmed shape served the new weights
    # another dtype, or another layout, is refused and serves on unchanged
    for bad, quantized in ((quantize_tree(sd2, "bf16"), True),
                           ({k: v for k, v in sd2.items() if k != "conv1_1.weight"},
                            False)):
        with pytest.raises(ValueError, match="swap_params structure mismatch"):
            eng.swap_params(bad, quantized=quantized)
    np.testing.assert_array_equal(eng.predict_batch(batch)[0], got)


def test_int8_cli_serves(tmp_path, he_params, engines):
    """--serve-dtype int8 builds a service whose engine keeps int8 weights
    and whose counts stay near f32's."""
    pth = tmp_path / "ref.pth"
    torch.save({k: torch.from_numpy(np.copy(v))
                for k, v in export_state_dict(he_params).items()}, pth)
    args = cli.parse_args(["--torch-pth", str(pth), "--platform", "cpu",
                           "--bucket-shapes", "64x64", "--max-batch", "2",
                           "--serve-dtype", "int8"])
    svc = cli.build_service(args)
    assert svc.engine.params["frontend.0.weight"]["q"].dtype == torch.int8
    with svc:
        got = svc.predict(_image(seed=4), timeout=60.0)
    want = engines[0].predict_batch(pad_batch(
        [(_image(seed=4), np.zeros((8, 8, 1), np.float32))], (64, 64), 1,
        [True], DS))[0][0]
    assert abs(got.count - want) <= 0.1 * max(abs(want), 1.0)


JAX_CLI_CASES = [
    ["--bf16", "--serve-dtype", "bf16"],
    ["--replicas", "0"],
    ["--menu-budget", "9"],
    ["--menu-budget", "0"],
    ["--stream-ttl-s", "0"],
    ["--max-body-mb", "-1"],
    ["--aot-bake", "/tmp/x"],
    ["--aot-bundle", "/tmp/x"],
    ["--autoscale-max", "3"],
    ["--replicas", "2", "--autoscale-max", "2"],
    ["--replicas", "2", "--autoscale-max", "4", "--autoscale-min", "5"],
]


@pytest.mark.parametrize("argv", JAX_CLI_CASES,
                         ids=lambda a: "_".join(x.strip("-") for x in a))
def test_cli_validation_messages_equal_jax(tmp_path, argv):
    """The serve CLI refuses each bad flag combination with the JAX CLI's
    own message, before any weights load."""
    from can_tpu.cli import serve as jcli

    pth = tmp_path / "a.pth"
    pth.write_bytes(b"")
    base = ["--torch-pth", str(pth), "--platform", "cpu"]
    with pytest.raises(SystemExit) as want:
        jcli.build_service(jcli.parse_args(base + argv))
    with pytest.raises(SystemExit) as got:
        cli.build_service(cli.parse_args(base + argv))
    assert str(got.value) == str(want.value) and str(got.value)


@pytest.mark.parametrize("argv,match", [
    # the fleet is ported: on the CPU its universe is the one CPU, so two
    # replicas are refused by the device count, before any weights load
    pytest.param(["--replicas", "2"],
                 "replicas=2 exceeds the 1 available devices", id="argv0"),
    # with an AOT bake too: the device count refuses it first
    pytest.param(["--replicas", "4", "--aot-bake", "/tmp/x",
                  "--autoscale-max", "6"], "replicas=4 exceeds the 1 available devices",
                 id="argv1")])
def test_replicas_refused_naming_item_3b(tmp_path, argv, match):
    pth = tmp_path / "a.pth"
    pth.write_bytes(b"")
    args = cli.parse_args(["--torch-pth", str(pth), "--platform", "cpu"]
                          + argv)
    with pytest.raises(SystemExit) as e:
        cli.build_service(args)
    assert match in str(e.value)


def test_cli_defaults_equal_jax():
    """At its defaults the port's serve CLI runs the JAX CLI's policy: the
    priced menu and flush, and every shared flag's default is JAX's."""
    from can_tpu.cli import serve as jcli

    mine = vars(cli.parse_args([]))
    theirs = vars(jcli.parse_args([]))
    # the telemetry flags are shared since the obs slice, the compile
    # cache since the cold-start slice
    assert set(theirs) - set(mine) == set()
    for k in set(mine) & set(theirs):
        assert mine[k] == theirs[k], k
    assert mine["flush_policy"] == "priced" and mine["menu_budget"] is None


def test_http_rollout_answers_as_jax_single_engine(engines):
    from can_tpu_torch.serve import CountService

    svc = CountService(engines[0], max_batch=2, bucket_ladder=((64,), (64,)),
                       max_body_mb=0.001)
    with pytest.raises(RuntimeError, match="needs a FleetEngine"):
        svc.rollout({})
    httpd = serve_http(svc, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        for body, code in ((b"{}", 501), (b"x" * 2048, 413)):
            rq = urllib.request.Request(f"http://127.0.0.1:{port}/rollout",
                                        data=body, method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(rq, timeout=30)
            assert e.value.code == code
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_legacy_bf16_flag_is_f32_weights_with_bf16_compute(tmp_path, he_params,
                                                           bf16_engines):
    """--bf16 (legacy): f32 weights on the device, the forward in bf16 —
    close to the bf16 mode's counts, and not the f32 engine's."""
    pth = tmp_path / "ref.pth"
    torch.save({k: torch.from_numpy(np.copy(v))
                for k, v in export_state_dict(he_params).items()}, pth)
    args = cli.parse_args(["--torch-pth", str(pth), "--platform", "cpu",
                           "--bucket-shapes", "64x64", "--max-batch", "4",
                           "--bf16"])
    svc = cli.build_service(args)
    eng = svc.engine
    assert eng.serve_dtype == "f32" and eng.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in eng.model.parameters())
    batch = _batch("f32", seed=5)
    got = eng.predict_batch(batch)[0]
    want = bf16_engines[0].predict_batch(batch)[0]
    f32 = ServeEngine(eng.params, device="cpu").predict_batch(batch)[0]
    mass = np.abs(f32).max()
    assert np.abs(got - want).max() <= 4 * BF16_U * mass
    assert np.abs(got - f32).max() > 0  # really computed in bf16
