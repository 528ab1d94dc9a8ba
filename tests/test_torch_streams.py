"""can_tpu_torch.serve.streams against can_tpu.serve.streams on the CPU:
the two registries driven by one script (admissions, completions,
bursts, idle gaps, TTL, ``policy="off"``) must make equal decisions —
kinds, rungs, counts, staleness, evictions — and emit equal events; then
the port's ``CountService`` stream path, in process and over HTTP (409
on a stale frame, labelled degraded answers that launch nothing,
``rollback_seq`` after a queue refusal), with counts against JAX's
``CountService`` at the model tolerance (rtol 1e-3 / atol 1e-4).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import can_tpu.sched as jsched
import can_tpu.serve.streams as jstreams
import can_tpu_torch.sched as tsched
import can_tpu_torch.serve.streams as tstreams
from can_tpu.serve import CountService as JaxCountService
from can_tpu.serve import ServeEngine as JaxServeEngine
from can_tpu_torch.serve import (
    REJECT_STALE_FRAME,
    STREAM_RUNG_SKIP,
    CountService,
    RejectedError,
    ServeEngine,
    prepare_image,
    serve_http,
)
from can_tpu_torch.utils.torch_import import state_dict_from_jax_params
from tests.test_torch_model import jax_params


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class Events:
    """A telemetry stand-in: records ``emit(kind, **payload)``."""

    def __init__(self):
        self.events = []

    def emit(self, kind, **payload):
        self.events.append((kind, payload))


class FakeRequest:
    """What ``note_admitted`` reads: a stream id and a done hook."""

    def __init__(self, stream_id):
        self.stream_id = stream_id
        self._hooks = []

    def add_done_hook(self, hook):
        self._hooks.append(hook)

    def finish(self):
        for h in self._hooks:
            h(self)


def _decision(d):
    return (d.kind, d.count, d.staleness_s, d.detail, d.rung, d.prior_seq,
            None if d.density is None else np.asarray(d.density).tolist())


def _pair(policy="priced", **kw):
    clocks = (FakeClock(), FakeClock())
    tels = (Events(), Events())
    t = tstreams.StreamSessionRegistry(
        clock=clocks[0], telemetry=tels[0], policy=policy,
        sched=tsched.ServeSched(4, max_wait_s=0.005), **kw)
    j = jstreams.StreamSessionRegistry(
        clock=clocks[1], telemetry=tels[1], policy=policy,
        sched=jsched.ServeSched(4, max_wait_s=0.005), **kw)
    return (t, j), clocks, tels


def _assert_same(regs, tels):
    t, j = regs
    assert t.stats() == j.stats()
    assert sorted(t._sessions) == sorted(j._sessions)
    for sid in t._sessions:
        assert t.get(sid).snapshot() == j.get(sid).snapshot()
        for f in ("gap_ewma", "gap_n", "last_served_ts", "rung_since",
                  "bucket_hw"):
            assert getattr(t.get(sid), f) == getattr(j.get(sid), f), f
    assert tels[0].events == tels[1].events


@pytest.mark.parametrize("policy", ["priced", "off"])
@pytest.mark.parametrize("seed", range(4))
def test_registry_scripted_equal(policy, seed):
    """One random script through both registries: bursts faster than the
    measured drain, completions, queue-refusal fallbacks, rollbacks,
    retransmits and idle gaps past the TTL."""
    regs, clocks, tels = _pair(policy, ttl_s=2.0, cooldown_s=0.05,
                               outstanding_high=3)
    rng = np.random.default_rng(seed)
    seqs = {"a": 0, "b": 0, "c": 0}
    inflight = []
    kinds_seen = set()
    for step in range(400):
        r = rng.random()
        dt = float(rng.choice([0.0005, 0.002, 0.01, 0.05, 0.3, 2.5],
                              p=[0.45, 0.25, 0.12, 0.1, 0.06, 0.02]))
        for c in clocks:
            c.t += dt
        sid = str(rng.choice(list(seqs)))
        bucket = (64, 64) if sid != "c" else (64, 96)
        if r < 0.55:
            seq = seqs[sid] + 1 if rng.random() > 0.1 else seqs[sid]
            outs = [reg.admit(sid, seq, bucket_hw=bucket) for reg in regs]
            assert _decision(outs[0]) == _decision(outs[1]), step
            kinds_seen.add(outs[0].kind)
            if outs[0].kind in ("serve", "degrade"):
                seqs[sid] = max(seqs[sid], seq)
            if outs[0].kind == "serve":
                if rng.random() < 0.1:  # the queue refused it
                    fbs = [reg.degrade_fallback(sid) for reg in regs]
                    if fbs[0] is None:
                        assert fbs[1] is None
                        for reg, o in zip(regs, outs):
                            reg.rollback_seq(sid, seq, o.prior_seq)
                        seqs[sid] = regs[0].get(sid).seq or 0
                    else:
                        assert _decision(fbs[0]) == _decision(fbs[1])
                    continue
                reqs = [FakeRequest(sid), FakeRequest(sid)]
                for reg, q in zip(regs, reqs):
                    reg.note_admitted(q)
                inflight.append((sid, bucket, reqs))
        elif r < 0.85 and inflight:
            sid, bucket, reqs = inflight.pop(0)
            count = float(rng.uniform(0, 50))
            dens = (rng.random((8, 8, 1)).astype(np.float32)
                    if rng.random() < 0.3 else None)
            execute_s = float(rng.choice([0.004, 0.02, 0.06]))
            slots = int(rng.choice([1, 2, 4]))
            for reg, q in zip(regs, reqs):
                reg.note_completed(sid, count, dens, bucket)
                reg.observe_batch(bucket, execute_s, slots)
                q.finish()
        elif r < 0.9:
            assert regs[0].evict_idle() == regs[1].evict_idle()
        else:
            for reg in regs:
                reg.observe_batch(bucket, 0.03, 4)
            assert (regs[0].expected_cost_s(bucket)
                    == regs[1].expected_cost_s(bucket))
        _assert_same(regs, tels)
    kinds = {e[0] for e in tels[0].events}
    assert "stream.session" in kinds
    if policy == "priced":
        # the ladder was hit: skipped frames and rung transitions
        assert {"serve", "degrade", "stale"} <= kinds_seen
        assert "stream.degrade" in kinds
    else:
        assert "degrade" not in kinds_seen


def test_registry_refusals_match():
    for kw in ({"policy": "sometimes"}, {"skip_enter": 0.4},
               {"outstanding_high": 0}):
        with pytest.raises(ValueError) as a:
            tstreams.StreamSessionRegistry(**kw)
        with pytest.raises(ValueError) as b:
            jstreams.StreamSessionRegistry(**kw)
        assert str(a.value) == str(b.value)


def test_pins_and_repin_equal():
    for sid in ("cam1", "cam2", "lobby", "x" * 40):
        for live in ([0], [2, 0, 1], [3, 5]):
            assert (tstreams.repin_target(sid, live)
                    == jstreams.repin_target(sid, live))
    regs, clocks, tels = _pair()
    for reg in regs:
        for sid, rep in (("a", 0), ("b", 1), ("c", 1)):
            reg.admit(sid, 1, bucket_hw=(64, 64))
            reg.note_completed(sid, 3.0, None, (64, 64), replica=rep,
                               token=f"inc{rep}")
    batch = [FakeRequest("a"), FakeRequest("b"), FakeRequest("c"),
             FakeRequest(None)]
    for live in ({0: "inc0", 1: "inc1"}, {0: "inc0"}, {1: "new1", 2: "inc2"},
                 {}):
        assert (regs[0].pin_for(batch, live) == regs[1].pin_for(batch, live))
        _assert_same(regs, tels)


# -- the port's CountService stream path -----------------------------------
@pytest.fixture(scope="module")
def he_params():
    return jax_params("he")


@pytest.fixture(scope="module")
def engine(he_params):
    return ServeEngine(state_dict_from_jax_params(he_params), device="cpu")


def make_image(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return prepare_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def make_service(engine, **kw):
    tel = Events()
    kw.setdefault("queue_capacity", 64)
    svc = CountService(engine, max_batch=2, max_wait_ms=2.0,
                       bucket_ladder=((64,), (64,)), telemetry=tel, **kw)
    return svc, tel.events


def test_stream_round_trip_matches_jax_counts(he_params, engine):
    svc, _ = make_service(engine)
    svc.warmup([(64, 64)])
    jsvc = JaxCountService(JaxServeEngine(jax.tree.map(np.asarray, he_params)),
                           max_batch=2, max_wait_ms=2.0,
                           bucket_ladder=((64,), (64,)))
    jsvc.warmup([(64, 64)])
    got, want = [], []
    with svc, jsvc:
        for i in range(3):
            img = make_image(seed=i)
            got.append(svc.predict(img, stream_id="cam", frame_seq=i + 1,
                                   deadline_ms=60_000, timeout=60.0))
            want.append(jsvc.predict(img, stream_id="cam", frame_seq=i + 1,
                                     deadline_ms=60_000, timeout=60.0))
    assert all(not r.degraded and r.stream_id == "cam" for r in got)
    assert max(abs(r.count) for r in want) > 1.0  # He weights: real counts
    np.testing.assert_allclose([r.count for r in got],
                               [r.count for r in want], rtol=1e-3, atol=1e-4)
    sess, jsess = svc.streams.get("cam"), jsvc.streams.get("cam")
    assert sess.served == jsess.served == 3 and sess.seq == jsess.seq == 3
    np.testing.assert_allclose(sess.count_ewma, jsess.count_ewma, rtol=1e-3)
    st = svc.stats()["streams"]
    assert st["sessions"] == 1 and st["served_total"] == 3
    assert set(st) == set(jsvc.stats()["streams"])


def test_duplicate_frame_rejected_typed(engine):
    svc, events = make_service(engine)
    svc.warmup([(64, 64)])
    img = make_image()
    with svc:
        svc.predict(img, stream_id="cam", frame_seq=3, deadline_ms=60_000,
                    timeout=60.0)
        with pytest.raises(RejectedError) as e:
            svc.predict(img, stream_id="cam", frame_seq=3,
                        deadline_ms=60_000, timeout=60.0)
    assert e.value.reason == REJECT_STALE_FRAME
    assert svc.stats()["rejected"] == 1
    rejects = [p for k, p in events if k == "serve.reject"]
    assert rejects[-1]["reason"] == REJECT_STALE_FRAME


def test_skip_rung_serves_labelled_ewma_without_launch(engine):
    svc, events = make_service(engine)
    svc.warmup([(64, 64)])
    img = make_image()
    with svc:
        fresh = svc.predict(img, stream_id="cam", frame_seq=1,
                            deadline_ms=60_000, timeout=60.0)
        sess = svc.streams.get("cam")
        sess.rung = STREAM_RUNG_SKIP
        sess.rung_since = svc._clock()  # the cooldown holds the rung
        batches = svc.stats()["batches"]
        deg = svc.predict(img, stream_id="cam", frame_seq=2,
                          deadline_ms=60_000, timeout=60.0)
    assert deg.degraded and not fresh.degraded
    assert deg.count == pytest.approx(sess.count_ewma)
    assert deg.staleness_s is not None and deg.staleness_s >= 0
    assert svc.stats()["batches"] == batches  # no launch
    assert svc.stats()["degraded"] == 1
    assert svc.latency.percentiles()["n"] == 1  # kept out of the reservoir
    ev = [p for k, p in events if k == "serve.request" and p.get("degraded")]
    assert len(ev) == 1 and ev[0]["stream"] == "cam"


def test_queue_refusal_degrades_instead_of_rejecting(engine):
    svc, events = make_service(engine, queue_capacity=2)
    svc.streams.admit("cam", 1, bucket_hw=(64, 64))
    svc.streams.note_completed("cam", 33.0, None, (64, 64))
    img = make_image()
    t1 = svc.submit(img, stream_id="cam", frame_seq=2)
    t2 = svc.submit(img, stream_id="cam", frame_seq=3)
    assert not t1.done and not t2.done  # queued: the batcher is not running
    res = svc.submit(img, stream_id="cam", frame_seq=4).result(timeout=1.0)
    assert res.degraded and res.count == pytest.approx(33.0)
    ev = [p for k, p in events if k == "serve.request" and p.get("degraded")]
    assert ev and ev[0]["fallback"] == "queue_full"
    with pytest.raises(RejectedError):
        svc.submit(img).result(timeout=1.0)  # stateless: the plain reject
    svc.queue.close()


def test_queue_reject_without_ewma_rolls_back_the_seq(engine):
    svc, _ = make_service(engine, queue_capacity=1)
    img = make_image()
    svc.submit(img, stream_id="cam", frame_seq=1)
    t = svc.submit(img, stream_id="cam", frame_seq=2)
    with pytest.raises(RejectedError) as e:
        t.result(timeout=1.0)
    assert e.value.reason == "queue_full"
    assert svc.streams.get("cam").seq == 1  # frame 2 un-committed
    retry = svc.submit(img, stream_id="cam", frame_seq=2)
    assert (retry._request._reject is None
            or retry._request._reject.reason != REJECT_STALE_FRAME)
    svc.queue.close()


def test_degrade_policy_off_keeps_rejects(engine):
    svc, _ = make_service(engine, queue_capacity=2, degrade_policy="off")
    svc.streams.admit("cam", 1, bucket_hw=(64, 64))
    svc.streams.note_completed("cam", 33.0, None, (64, 64))
    img = make_image()
    svc.submit(img, stream_id="cam", frame_seq=2)
    svc.submit(img, stream_id="cam", frame_seq=3)
    with pytest.raises(RejectedError) as e:
        svc.submit(img, stream_id="cam", frame_seq=4).result(timeout=1.0)
    assert e.value.reason == "queue_full"
    with pytest.raises(ValueError, match="stream_id"):
        svc.submit(img, frame_seq=3)
    svc.queue.close()


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


def test_http_stream_409_and_degraded_labels(engine):
    svc, _ = make_service(engine)
    svc.warmup([(64, 64)])
    img = np.random.default_rng(2).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    with svc:
        httpd = serve_http(svc, host="127.0.0.1", port=0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            code, fresh = _post(port, img, "stream_id=cam1&frame_seq=5")
            assert code == 200 and fresh["degraded"] is False
            assert "staleness_s" not in fresh
            code, stale = _post(port, img, "stream_id=cam1&frame_seq=5")
            assert code == 409 and stale["reason"] == REJECT_STALE_FRAME
            code, _ = _post(port, img, "stream_id=cam1&frame_seq=4")
            assert code == 409  # out of order
            sess = svc.streams.get("cam1")
            sess.rung = STREAM_RUNG_SKIP
            sess.rung_since = svc._clock()
            batches = svc.stats()["batches"]
            code, deg = _post(port, img, "stream_id=cam1&frame_seq=6")
            assert code == 200 and deg["degraded"] is True
            assert deg["staleness_s"] >= 0
            assert deg["count"] == pytest.approx(sess.count_ewma)
            assert svc.stats()["batches"] == batches
            assert _post(port, img, "frame_seq=7")[0] == 400  # no stream_id
            code, plain = _post(port, img)
            assert code == 200 and "degraded" not in plain
        finally:
            httpd.shutdown()
            httpd.server_close()
    st = svc.stats()
    assert st["streams"]["stale_rejects_total"] == 2
    assert st["degraded"] == 1 and st["rejected"] == 2
