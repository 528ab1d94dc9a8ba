"""CountService: the serving front door, programmatic and over HTTP
(counterpart of ``can_tpu/serve/service.py``: ``prepare_image`` :63,
``CountService`` :120, ``make_http_handler`` :724, ``serve_http`` :943)::

    client -> submit() -> [stream session: admit / degrade]
                       -> BoundedRequestQueue -> MicroBatcher (thread)
                       -> ServeEngine.predict_batch -> resolve ServeRequests

The engine may be a single ``ServeEngine`` (dispatch executes inline on
the batcher thread) or a ``FleetEngine`` (``serve/fleet.py``): dispatch
then ENQUEUES the assembled batch with its stream pin and returns, and
the replica worker threads call ``_complete`` (or ``_fail_batch``) back
on this service — one resolution path either way.  Fleet services add
per-replica rows to ``stats()`` and ``healthz()``, ``rollout()`` and
``POST /rollout``, and an optional ``autoscaler`` attribute
(``serve/autoscale.py``) that starts and stops with the service.

The scheduling core (``can_tpu_torch/sched``) prices the batcher's launch
sizes and flush deadlines; ``menu_budget=1`` with ``flush_policy="timer"``
is the service without it (every launch padded to ``max_batch``, flushed
on the ``max_wait_ms`` timer).  ``telemetry``: an object with
``emit(kind, **payload)`` that receives JAX's ``serve.request`` /
``serve.batch`` / ``serve.reject`` events, or None; with a cost ledger
on it (``Telemetry.ledger``) every steady-state batch's fenced execute
time feeds the ledger, and ``perf.summary`` is emitted at warmup, every
``perf_summary_every`` batches and at close.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from can_tpu_torch.data.dataset import normalize_host
from can_tpu_torch.data.imageio import resize_linear
from can_tpu_torch.sched import DEFAULT_MENU_BUDGET, ServeSched, costs_match
from can_tpu_torch.serve.batcher import MicroBatcher
from can_tpu_torch.serve.engine import ServeEngine
from can_tpu_torch.serve.queue import (
    REJECT_BACKPRESSURE,
    REJECT_DEADLINE,
    REJECT_ERROR,
    REJECT_QUEUE_FULL,
    REJECT_SHUTDOWN,
    REJECT_STALE_FRAME,
    REJECT_STREAM_OVERLOAD,
    BoundedRequestQueue,
    RejectedError,
    ServeRequest,
    ServeResult,
)
from can_tpu_torch.serve.streams import StreamSessionRegistry
from can_tpu_torch.utils.profiling import StepTimer


def prepare_image(image: np.ndarray, *, ds: int = 8,
                  normalize: bool = True) -> np.ndarray:
    """Snap an HWC RGB image down to the nearest /ds multiple (bilinear,
    half-pixel centres, as the offline dataset's ``cv2.resize``), then
    ImageNet-normalise (u8 input with normalize=False keeps the bytes for
    normalisation on the device)."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected HWC RGB image, got shape {image.shape}")
    h, w = image.shape[:2]
    rows, cols = h // ds, w // ds
    if rows == 0 or cols == 0:
        raise ValueError(f"image {h}x{w} is smaller than one {ds}px "
                         f"density cell")
    if (rows * ds, cols * ds) != (h, w):
        image = resize_linear(image, rows * ds, cols * ds)
    if normalize:
        image = normalize_host(np.asarray(image))
        if image.dtype != np.float32:
            raise ValueError("normalize=True needs uint8 or already "
                             f"normalised float32 pixels, got {image.dtype}")
    return image


class ServeTicket:
    """Handle returned by ``submit()``; ``result()`` blocks for the
    outcome, raising ``RejectedError`` on any rejection (the wait is
    bounded by the deadline plus a grace window — never a hang)."""

    def __init__(self, request: ServeRequest, service: "CountService"):
        self._request = request
        self._service = service
        self.id = request.id

    @property
    def done(self) -> bool:
        return self._request.done

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if timeout is None:
            if self._request.deadline_ts is not None:
                # deadline_ts is on the service clock: "now" must be too
                timeout = (self._request.deadline_ts
                           - self._service._clock()
                           + self._service.grace_s)
            else:
                timeout = self._service.default_result_timeout_s
        return self._request.wait(max(timeout, 0.0))


class CountService:
    """Owns the queue, the batcher thread, the engine and the stream
    sessions.  Call ``warmup()`` before traffic.

    menu_budget: launch sizes per (bucket, dtype) in the priced menu
    (None = ``sched.DEFAULT_MENU_BUDGET``); flush_policy: "priced" or
    "timer".  ``menu_budget=1`` with ``"timer"`` runs without the core.
    stream_ttl_s / degrade_policy: the stream registry's TTL and ladder
    ("priced" | "off").  perf_summary_every: batches per periodic
    ``perf.summary`` with a cost ledger on the bus (<= 0: none between
    the warmup's and the close's).
    """

    def __init__(self, engine: ServeEngine, *, max_batch: int = 8,
                 max_wait_ms: float = 5.0, queue_capacity: int = 64,
                 high_water: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 bucket_ladder=None, pad_multiple=None,
                 min_bucket_h: Optional[int] = None,
                 telemetry=None, clock=time.monotonic,
                 perf_summary_every: int = 32,
                 menu_budget: Optional[int] = None,
                 flush_policy: str = "priced",
                 stream_ttl_s: float = 300.0,
                 degrade_policy: str = "priced",
                 max_body_mb: float = 64.0):
        if flush_policy not in ("priced", "timer"):
            raise ValueError(f"unknown flush_policy {flush_policy!r} "
                             f"(priced | timer)")
        if max_body_mb <= 0:
            raise ValueError(f"max_body_mb must be positive, got "
                             f"{max_body_mb}")
        self.engine = engine
        # fleet mode: dispatch enqueues instead of executing inline, and
        # replica workers call _complete/_fail_batch back on this service
        self._fleet = engine if hasattr(engine, "submit_work") else None
        if self._fleet is not None:
            self._fleet.bind(on_complete=self._complete,
                             on_fail=self._fail_batch,
                             on_reject=self._note_reject, clock=clock)
            if telemetry is None:
                telemetry = self._fleet.telemetry
        self._replica_stats: dict = {}
        budget = (DEFAULT_MENU_BUDGET if menu_budget is None
                  else int(menu_budget))
        if budget == 1 and flush_policy == "timer":
            self.sched = None
        else:
            self.sched = ServeSched(int(max_batch),
                                    max_wait_s=float(max_wait_ms) / 1e3,
                                    menu_budget=budget,
                                    priced_flush=flush_policy == "priced")
        self.flush_policy = flush_policy
        self.telemetry = telemetry
        self.max_batch = int(max_batch)
        self.default_deadline_s = (None if default_deadline_ms is None
                                   else float(default_deadline_ms) / 1e3)
        self.grace_s = max(1.0, 4 * float(max_wait_ms) / 1e3)
        self.default_result_timeout_s = 120.0
        self.max_body_bytes = int(float(max_body_mb) * 2 ** 20)
        self._clock = clock
        self.queue = BoundedRequestQueue(queue_capacity,
                                         high_water=high_water, clock=clock)
        self.batcher = MicroBatcher(self.queue, self._dispatch,
                                    max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    bucket_ladder=bucket_ladder,
                                    pad_multiple=pad_multiple,
                                    min_bucket_h=min_bucket_h,
                                    ds=engine.ds, telemetry=telemetry,
                                    clock=clock, on_reject=self._note_reject,
                                    sched=self.sched)
        # request latency reservoir (skip_first=0: warmup() keeps first
        # calls off the request path); read by HTTP threads while the
        # batcher thread records, hence under _lock
        self.latency = StepTimer(skip_first=0)
        self._lock = threading.Lock()
        self._stats = {"submitted": 0, "completed": 0, "rejected": 0,
                       "degraded": 0,
                       "batches": 0, "batch_slots": 0, "batch_valid": 0}
        # the core's economics per launch: predicted vs realized cost
        # (pixel units) and the launches per size
        self._cost = {"predicted_cost_px": 0.0, "realized_cost_px": 0.0,
                      "cost_mismatches": 0}
        self._sizes: dict = {}
        # stream sessions: HOST-side per-stream state (EWMAs, sequence
        # gate, degradation ladder); requests without a stream_id never
        # touch it
        self.streams = StreamSessionRegistry(
            ttl_s=stream_ttl_s, clock=clock, telemetry=telemetry,
            sched=self.sched, policy=degrade_policy)
        self._started = False
        self._closed = False
        # image dtypes warmup() has run — the HTTP raw=1 gate
        self.warmed_dtypes: set = set()
        # with a cost ledger on the bus (Telemetry.ledger): one
        # perf.summary per this many batches keeps the can_tpu_mfu_*
        # gauges live (0 or less: only the warmup's and the close's)
        self.perf_summary_every = int(perf_summary_every)
        self._perf_batches = 0
        self._trace_prefix = f"req-{os.getpid():x}{os.urandom(2).hex()}"

    def _emit(self, kind: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(kind, **payload)

    # -- lifecycle -------------------------------------------------------
    def warmup(self, bucket_shapes: Sequence[Tuple[int, int]],
               dtypes=(np.float32,)) -> dict:
        """Warm every (bucket, menu size, dtype): traffic then runs no new
        signature."""
        report = self.engine.warmup(
            bucket_shapes, self.max_batch, dtypes=dtypes,
            sizes=self.sched.menu if self.sched is not None else None)
        self.warmed_dtypes.update(np.dtype(dt) for dt in dtypes)
        ledger = getattr(self.telemetry, "ledger", None)
        if ledger is not None:
            # every warmed program's flops/bytes (so its roofline class)
            # is known now: published before traffic, MFU joins later
            ledger.emit_summary(self.telemetry, phase="serve_warmup")
        return report

    def start(self) -> "CountService":
        if not self._started:
            if self._fleet is not None:
                self._fleet.start()
            self.batcher.start()
            auto = getattr(self, "autoscaler", None)
            if auto is not None:
                # wired by cli/serve.py (or tests): the scale loop lives
                # and dies with the service
                auto.start()
            inc = getattr(self.telemetry, "incidents", None)
            if inc is not None:
                # an incident bundle dumped while this service is alive
                # (replica quarantine, SLO burn, SIGTERM) carries the
                # live serving stats in its manifest (obs/incidents.py)
                inc.add_info_source("serve_stats", self.stats)
            self._started = True
        return self

    def close(self) -> None:
        """Stop admissions, drain in-flight work, reject the rest."""
        if self._closed:
            return
        self._closed = True
        auto = getattr(self, "autoscaler", None)
        if auto is not None:
            # BEFORE the drain: a scale decision mid-teardown would race
            # the fleet's close choreography
            auto.close()
        for r in self.queue.close():
            r.reject(REJECT_SHUTDOWN, "service closing")
            self._count_reject(REJECT_SHUTDOWN)
        self.batcher.close()  # flushes pending groups through the engine
        if self._fleet is not None:
            # after the batcher: its shutdown flush enqueues final work,
            # which the replicas drain before their threads stop
            self._fleet.close()
        ledger = getattr(self.telemetry, "ledger", None)
        if ledger is not None:
            ledger.emit_summary(self.telemetry, phase="serve_close")
        self._started = False

    def __enter__(self) -> "CountService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the programmatic API --------------------------------------------
    def submit(self, image: np.ndarray, *,
               deadline_ms: Optional[float] = None,
               want_density: bool = False,
               stream_id: Optional[str] = None,
               frame_seq: Optional[int] = None,
               trace_id: Optional[str] = None) -> ServeTicket:
        """Enqueue one prepared image (see ``prepare_image``).  Returns a
        ticket; an immediate rejection (full queue, shedding, shutdown,
        stale frame) is stored on it.

        ``stream_id`` opts the request into a per-stream session
        (``serve/streams.py``): the sequence gate on ``frame_seq`` and the
        degradation ladder — under overload the frame may be answered
        from the stream's EWMA (``degraded`` + ``staleness_s`` on the
        result) instead of launched or rejected.  Without a stream_id the
        request takes the stateless path."""
        if frame_seq is not None and stream_id is None:
            raise ValueError("frame_seq needs a stream_id (the sequence "
                             "gate is per-stream)")
        deadline_s = (float(deadline_ms) / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        req = ServeRequest(np.asarray(image), deadline_s=deadline_s,
                           want_density=want_density, clock=self._clock,
                           stream_id=stream_id, frame_seq=frame_seq)
        req.trace_id = trace_id or f"{self._trace_prefix}-{req.id}"
        ds = self.engine.ds
        if req.shape[0] % ds or req.shape[1] % ds:
            raise ValueError(
                f"image shape {req.shape} is not snapped to the /{ds} "
                f"density grid — call prepare_image first")
        bucket = self.batcher.bucket_of(req.shape)
        if bucket[0] < req.shape[0] or bucket[1] < req.shape[1]:
            raise ValueError(
                f"image {req.shape[0]}x{req.shape[1]} exceeds the largest "
                f"bucket {bucket[0]}x{bucket[1]} — resize it or serve with "
                f"a bigger bucket ladder")
        with self._lock:
            self._stats["submitted"] += 1
        if self._closed:
            req.reject(REJECT_SHUTDOWN, "service closed")
            self._count_reject(REJECT_SHUTDOWN)
            return ServeTicket(req, self)
        if stream_id is None:
            reason = self.queue.offer(req)
            if reason is not None:
                self._count_reject(reason)
            return ServeTicket(req, self)
        return self._submit_stream(req, bucket)

    def _submit_stream(self, req: ServeRequest, bucket) -> ServeTicket:
        """The stream admission path: the registry decides first (sequence
        gate, degradation ladder), then the queue — and a queue refusal
        degrades to the EWMA when one exists instead of rejecting."""
        now = self._clock()
        dec = self.streams.admit(req.stream_id, req.frame_seq, now, bucket)
        if dec.kind == "stale":
            req.reject(REJECT_STALE_FRAME, dec.detail)
            self._count_reject(REJECT_STALE_FRAME)
            return ServeTicket(req, self)
        if dec.kind == "overload":
            req.reject(REJECT_STREAM_OVERLOAD, dec.detail)
            self._count_reject(REJECT_STREAM_OVERLOAD)
            return ServeTicket(req, self)
        if dec.kind == "degrade":
            self._resolve_degraded(req, bucket, dec)
            return ServeTicket(req, self)
        self.streams.note_admitted(req)
        reason = self.queue.offer(req, reject=False)
        if reason is not None:
            fb = self.streams.degrade_fallback(req.stream_id, now)
            if fb is not None:
                self._resolve_degraded(req, bucket, fb, fallback=reason)
            else:
                # refused with nothing to degrade to: un-commit the
                # frame's sequence so the camera's retry passes the gate
                self.streams.rollback_seq(req.stream_id, req.frame_seq,
                                          dec.prior_seq)
                req.reject(reason, f"outstanding {self.queue.outstanding()}")
                self._count_reject(reason)
        return ServeTicket(req, self)

    def _resolve_degraded(self, req: ServeRequest, bucket, dec,
                          fallback: Optional[str] = None) -> None:
        """Answer a stream frame from its session EWMA — no queue, no
        batch, no launch.  Labelled ``degraded`` with its staleness, and
        kept out of the latency reservoir (an instant EWMA answer in the
        tail would make overload look like a latency win)."""
        now = self._clock()
        dens = None
        if req.want_density and dec.density is not None:
            h, w = req.shape
            if dec.density.shape[:2] == (h // self.engine.ds,
                                         w // self.engine.ds):
                dens = dec.density
        res = ServeResult(count=float(dec.count), density=dens,
                          bucket_hw=tuple(bucket), batch_fill=0.0,
                          latency_s=now - req.t_submit,
                          queue_wait_s=0.0, device_s=0.0,
                          trace_id=req.trace_id, degraded=True,
                          staleness_s=dec.staleness_s,
                          stream_id=req.stream_id)
        req.resolve(res)
        with self._lock:
            self._stats["completed"] += 1
            self._stats["degraded"] += 1
        payload = {"request_id": req.id,
                   "latency_s": round(res.latency_s, 6),
                   "bucket": list(bucket), "ok": True,
                   "trace_id": req.trace_id, "degraded": True,
                   "stream": req.stream_id}
        if dec.staleness_s is not None:
            payload["staleness_s"] = dec.staleness_s
        if fallback is not None:
            payload["fallback"] = fallback
        self._emit("serve.request", **payload)

    def predict(self, image: np.ndarray, *,
                deadline_ms: Optional[float] = None,
                want_density: bool = False,
                timeout: Optional[float] = None,
                stream_id: Optional[str] = None,
                frame_seq: Optional[int] = None,
                trace_id: Optional[str] = None) -> ServeResult:
        """submit + result in one call."""
        return self.submit(image, deadline_ms=deadline_ms,
                           want_density=want_density, stream_id=stream_id,
                           frame_seq=frame_seq,
                           trace_id=trace_id).result(timeout)

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            lat = self.latency.percentiles()
            cost = dict(self._cost)
            sizes = dict(self._sizes)
            rep_counts = {k: dict(v) for k, v in self._replica_stats.items()}
        slots = max(s["batch_slots"], 1)
        batches = max(s["batches"], 1)
        out = {**s,
              "queue_depth": self.queue.depth(),
              "shedding": self.queue.shedding,
              "mean_batch_fill": round(s["batch_valid"] / slots, 4),
              "latency_p50_s": lat["p50_s"],
              "latency_p95_s": lat["p95_s"],
              "latency_max_s": lat["max_s"],
              "compile_count": self.engine.compile_count,
              # the scheduling core: its menu and flush policy, the
              # launches per size, and predicted vs realized cost per
              # batch (equal on every batch: cost_mismatches 0)
              "sched": {
                  "menu": (list(self.sched.menu) if self.sched is not None
                           else [self.max_batch]),
                  "flush_policy": self.flush_policy,
                  "priced": self.sched is not None,
                  "launches_by_size": {str(k): v for k, v in
                                       sorted(sizes.items())},
                  "predicted_cost_px_per_batch": round(
                      cost["predicted_cost_px"] / batches, 3),
                  "realized_cost_px_per_batch": round(
                      cost["realized_cost_px"] / batches, 3),
                  "cost_mismatches": cost["cost_mismatches"]},
              # per-stream sessions: the degradation ladder's view
              "streams": self.streams.stats()}
        if self._fleet is not None:
            # per-replica rows: service-side work counters joined with the
            # fleet's health snapshot
            fh = self._fleet.healthz()
            health = {r["replica"]: r for r in fh["replicas"]}
            out["replicas"] = {
                str(k): {**rep_counts.get(k, {"batches": 0,
                                              "completed": 0}),
                         "quarantined": int(h["state"] != "active"),
                         "failures": h["failures"],
                         "generation": h["generation"]}
                for k, h in health.items()}
            out["live_replicas"] = fh["live"]
            out["generation"] = fh["generation"]
            # a fleet serving two checkpoints at once says so
            out["mixed_generations"] = bool(fh.get("mixed_generations"))
        return out

    def latency_percentile(self, q: float):
        """One request-latency percentile under the service lock — the
        autoscaler's p99 signal."""
        with self._lock:
            return self.latency.percentile(q)

    def healthz(self) -> dict:
        """Liveness; a fleet adds its per-replica rows and reports
        ok=False with zero live replicas (the /healthz 503)."""
        if self._fleet is None:
            return {"ok": not self._closed}
        return self._fleet.healthz()

    def rollout(self, state_dict, *, run_config=None,
                allow_config_change: bool = False) -> dict:
        """Blue/green checkpoint flip (fleet engines only): see
        ``FleetEngine.rollout``.  A single-engine service has no second
        engine to stage on: restart it, or call ``engine.swap_params``
        between launches."""
        if self._fleet is None:
            raise RuntimeError("rollout needs a FleetEngine "
                               "(serve with --replicas >= 2 fleet mode)")
        return self._fleet.rollout(state_dict, run_config=run_config,
                                   allow_config_change=allow_config_change)

    # -- batcher dispatch (runs on the batcher thread) -------------------
    def _dispatch(self, bucket_hw, batch, requests) -> None:
        if self._fleet is not None:
            # hand the batch to whichever replica frees up first; stream
            # batches carry their sticky pin, validated against the LIVE
            # replica set here — a pin to a quarantined, wedged or
            # replaced incarnation is re-pinned before it can queue
            pin = None
            if self.streams.active_count():
                pin = self.streams.pin_for(requests,
                                           self._fleet.live_tokens())
            self._fleet.submit_work(bucket_hw, batch, requests, pin=pin)
            return
        t_exec0 = self._clock()  # the device span's start, service clock
        t0 = time.perf_counter()
        counts, density = self.engine.predict_batch(
            batch, want_density=any(r.want_density for r in requests))
        # wall time on perf_counter even under a test's fake clock
        execute_s = time.perf_counter() - t0
        self._complete(bucket_hw, batch, requests, counts, density,
                       execute_s, self.engine.last_batch_compiled,
                       t_exec0=t_exec0)

    def _complete(self, bucket_hw, batch, requests, counts, density,
                  execute_s, compiled, replica=None,
                  program: str = "serve_predict", t_exec0=None) -> None:
        """Resolve a launched batch: on the batcher thread, or on a fleet
        replica's worker thread (``replica`` its index, ``program`` its
        engine's incarnation name, the stream pin's token).

        With a span tracer on the bus each request emits the reference's
        span tree: a ``request`` root with ``queue_wait``,
        ``batch_assembly``, ``device`` and ``respond`` children, on the
        service clock.  The per-slot respond spans tile the time after
        the launch back to back, so a late slot's span shows its own
        resolve cost, not its siblings'."""
        t_exec1 = self._clock()
        if t_exec0 is None:
            # fleet path: the worker measured execute_s on perf_counter;
            # anchor the device span by subtracting it on the service clock
            t_exec0 = t_exec1 - execute_s
        now = self._clock()
        spans = getattr(self.telemetry, "spans", None)
        t_resp0 = t_exec1
        slots = batch.image.shape[0]
        fill = len(requests) / slots
        ds = self.engine.ds
        for slot, req in enumerate(requests):
            h, w = req.shape
            dens = (np.asarray(density[slot, : h // ds, : w // ds])
                    if req.want_density else None)
            latency = now - req.t_submit
            t_asm = req.t_assembly if req.t_assembly is not None else now
            t_ready = req.t_ready if req.t_ready is not None else now
            queue_wait = max(t_asm - req.t_submit, 0.0)
            if req.stream_id is not None:
                # fold the fresh count into the session BEFORE resolving:
                # a degraded answer racing this completion serves it
                self.streams.note_completed(
                    req.stream_id, float(counts[slot]), dens, bucket_hw,
                    now=now, replica=replica,
                    token=None if replica is None else program)
            req.resolve(ServeResult(
                count=float(counts[slot]), density=dens,
                bucket_hw=tuple(bucket_hw), batch_fill=fill,
                latency_s=latency, queue_wait_s=round(queue_wait, 6),
                device_s=round(execute_s, 6), trace_id=req.trace_id,
                stream_id=req.stream_id))
            with self._lock:
                self.latency.record(latency)
            self._emit("serve.request", request_id=req.id,
                       latency_s=round(latency, 6), bucket=list(bucket_hw),
                       ok=True, trace_id=req.trace_id,
                       queue_wait_s=round(queue_wait, 6),
                       assembly_s=round(max(t_ready - t_asm, 0.0), 6),
                       device_s=round(execute_s, 6))
            if spans is not None:
                t_done = self._clock()
                root = spans.emit(trace_id=req.trace_id, name="request",
                                  start=req.t_submit, end=t_done,
                                  bucket=list(bucket_hw), ok=True)
                spans.emit(trace_id=req.trace_id, name="queue_wait",
                           start=req.t_submit, end=t_asm, parent_id=root)
                spans.emit(trace_id=req.trace_id, name="batch_assembly",
                           start=t_asm, end=t_ready, parent_id=root)
                spans.emit(trace_id=req.trace_id, name="device",
                           start=t_exec0, end=t_exec0 + execute_s,
                           parent_id=root, compiled=compiled)
                spans.emit(trace_id=req.trace_id, name="respond",
                           start=t_resp0, end=t_done, parent_id=root)
                t_resp0 = t_done
        # every completed batch feeds the stream ladder's drain pricing
        self.streams.observe_batch(bucket_hw, execute_s, slots)
        # the core's economics: predicted from the valid count alone
        # (cover_one), realized from the launch that ran — equal unless
        # the batcher launched a size the core would not; the service
        # without a core pads every launch to max_batch
        area = float(bucket_hw[0] * bucket_hw[1])
        if self.sched is not None:
            predicted = self.sched.predicted_cost_px(area, len(requests))
            realized = self.sched.realized_cost_px(area, slots)
        else:
            predicted = area * self.max_batch
            realized = area * slots
        with self._lock:
            self._stats["completed"] += len(requests)
            self._stats["batches"] += 1
            self._stats["batch_slots"] += slots
            self._stats["batch_valid"] += len(requests)
            self._sizes[slots] = self._sizes.get(slots, 0) + 1
            self._cost["predicted_cost_px"] += predicted
            self._cost["realized_cost_px"] += realized
            self._cost["cost_mismatches"] += not costs_match(predicted,
                                                             realized)
            if replica is not None:
                rs = self._replica_stats.setdefault(
                    replica, {"batches": 0, "completed": 0})
                rs["batches"] += 1
                rs["completed"] += len(requests)
        extra = {} if replica is None else {"replica": replica}
        self._emit("serve.batch", bucket=list(bucket_hw), size=slots,
                   valid=len(requests), fill=round(fill, 4),
                   fill_pct=round(100.0 * fill, 2),
                   padded_slots=slots - len(requests),
                   predicted_cost_px=round(predicted, 1),
                   realized_cost_px=round(realized, 1),
                   execute_s=round(execute_s, 6), compiled=compiled,
                   queue_depth=self.queue.depth(), **extra)
        ledger = getattr(self.telemetry, "ledger", None)
        if ledger is not None:
            if not compiled:
                # the steady-state (fenced) launch time of this program;
                # a first call is the compile event's bill.  Fleet
                # batches bill their replica's own program name
                ledger.observe(program, tuple(batch.image.shape),
                               execute_s, dtype=str(batch.image.dtype))
            # under _lock: fleet workers complete concurrently
            with self._lock:
                self._perf_batches += 1
                due = 0 < self.perf_summary_every <= self._perf_batches
                if due:
                    self._perf_batches = 0
            if due:
                ledger.emit_summary(self.telemetry, phase="serve")

    def _note_reject(self, reason: str, count: int = 1) -> None:
        """Count a rejection whose event (if any) was emitted already —
        stats() agrees with the RejectedErrors clients saw."""
        with self._lock:
            self._stats["rejected"] += count

    def _count_reject(self, reason: str) -> None:
        self._note_reject(reason)
        self._emit("serve.reject", reason=reason, count=1,
                   queue_depth=self.queue.depth())

    def _fail_batch(self, requests, exc) -> None:
        """Fleet failure sink: a batch that failed on two replicas (or
        outlived every replica) rejects its requests with ``error``."""
        n = 0
        for r in requests:
            if not r.done:
                r.reject(REJECT_ERROR, f"{type(exc).__name__}: {exc}")
                n += 1
        if n:
            self._note_reject(REJECT_ERROR, n)
            self._emit("serve.reject", reason=REJECT_ERROR, count=n,
                       detail=f"{type(exc).__name__}: {exc}")


# -- HTTP front end -----------------------------------------------------
def make_http_handler(service: CountService):
    """Request handler class bound to ``service``.

    POST /predict   body: .npy bytes (np.save of an HWC uint8/float32
                    image); query: ?deadline_ms=&density=1&raw=1 (raw=1
                    keeps uint8 pixels and normalises on the device; needs
                    the u8 batches warmed, cli --u8-warmup);
                    ?stream_id=cam1&frame_seq=17 opts into a per-stream
                    session (sequence gate, degradation ladder)
                    -> 200 {"count", "latency_ms", "bucket", "batch_fill",
                            "trace_id", "queue_wait_ms"[, "density"]};
                       stream requests add {"degraded"[, "staleness_s"]}
                    -> 408/503 {"error", "reason"} on deadline/shedding;
                       409 on a stale or duplicate frame_seq; 400 on a bad
                       request; 413 when the body exceeds the cap
                    The X-CanTpu-Trace-Id header, when given, is the
                    request's trace_id and is echoed back.
    POST /rollout   (fleet) body: JSON checkpoint source — the CLI's
                    keys ({"checkpoint_dir", "epoch", "params_npz",
                    "torch_pth", "syncBN", "allow_config_change"}) —
                    loaded by ``service.rollout_loader(spec) ->
                    (state_dict, run_config)`` (wired by cli/serve.py),
                    then blue/green-flipped; synchronous, traffic keeps
                    flowing -> 200 the rollout report; 409 when the drift
                    or structure guard refuses or the source is bad; 500
                    on an unexpected loader failure; 501 without a loader;
                    413 over the body cap
    GET  /healthz   -> 200 {"ok": true, ...}; a fleet adds per-replica
                    state, live count and generation, and answers 503
                    when no replica is live
    GET  /stats     -> 200 stats() JSON
    """
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    status_of = {REJECT_DEADLINE: 408, REJECT_QUEUE_FULL: 503,
                 REJECT_BACKPRESSURE: 503, REJECT_SHUTDOWN: 503,
                 # a stale/duplicate stream frame is the client's ordering
                 # problem (409), not server load (503)
                 REJECT_STALE_FRAME: 409, REJECT_STREAM_OVERLOAD: 503}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict,
                  headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _body_capped(self) -> Optional[int]:
            """Content-Length, or None after answering 400/413: an
            oversized body is refused before it is read."""
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n < 0:
                    raise ValueError(f"negative Content-Length {n}")
            except ValueError as e:
                self._send(400, {"error": f"bad request: {e}"})
                return None
            if n > service.max_body_bytes:
                self._send(413, {
                    "error": f"request body {n} bytes exceeds the "
                             f"{service.max_body_bytes} byte cap "
                             f"(--max-body-mb="
                             f"{service.max_body_bytes / 2 ** 20:g})"})
                return None
            return n

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                health = service.healthz()
                self._send(200 if health.get("ok") else 503, health)
            elif path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"no such path: {path}"})

        def _do_rollout(self):
            # the body cap first, whatever the wiring
            n = self._body_capped()
            if n is None:
                return
            loader = getattr(service, "rollout_loader", None)
            if loader is None:
                self._send(501, {"error": "rollout is not wired on this "
                                          "server (no rollout_loader; "
                                          "fleet CLI serves wire it)"})
                return
            try:
                spec = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(spec, dict):
                    raise ValueError("rollout body must be a JSON object")
            except Exception as e:  # noqa: BLE001 — client error
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                allow = bool(spec.pop("allow_config_change", False))
                state_dict, run_config = loader(spec)
                report = service.rollout(state_dict, run_config=run_config,
                                         allow_config_change=allow)
            except (ValueError, RuntimeError, FileNotFoundError) as e:
                # drift guard / structure guard / bad source: refused,
                # the serving fleet is untouched
                self._send(409, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — a corrupt file or a
                # loader bug must answer the client, never drop the socket
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, report)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/rollout":
                self._do_rollout()
                return
            if url.path != "/predict":
                self._send(404, {"error": f"no such path: {url.path}"})
                return
            n = self._body_capped()
            if n is None:
                return
            try:
                arr = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                q = parse_qs(url.query)
                deadline_ms = (float(q["deadline_ms"][0])
                               if "deadline_ms" in q else None)
                want_density = q.get("density", ["0"])[0] not in ("0", "")
                raw = q.get("raw", ["0"])[0] not in ("0", "")
                stream_id = q.get("stream_id", [None])[0] or None
                frame_seq = (int(q["frame_seq"][0])
                             if "frame_seq" in q else None)
                trace_in = self.headers.get("X-CanTpu-Trace-Id") or None
                if frame_seq is not None and stream_id is None:
                    raise ValueError("frame_seq needs a stream_id")
                if raw and arr.dtype != np.uint8:
                    raise ValueError("raw=1 needs uint8 pixels")
                if raw and np.dtype(np.uint8) not in service.warmed_dtypes:
                    raise ValueError("raw=1 (uint8) programs are not warmed "
                                     "on this server; start it with "
                                     "--u8-warmup")
                image = prepare_image(arr, ds=service.engine.ds,
                                      normalize=not raw)
            except Exception as e:  # noqa: BLE001 — client error, not ours
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                res = service.predict(image, deadline_ms=deadline_ms,
                                      want_density=want_density,
                                      stream_id=stream_id,
                                      frame_seq=frame_seq, trace_id=trace_in)
            except ValueError as e:  # submit-side validation: client error
                self._send(400, {"error": f"bad request: {e}"})
                return
            except RejectedError as e:
                self._send(status_of.get(e.reason, 503),
                           {"error": str(e), "reason": e.reason})
                return
            payload = {"count": res.count,
                       "latency_ms": round(res.latency_s * 1e3, 3),
                       "bucket": list(res.bucket_hw),
                       "batch_fill": res.batch_fill,
                       "trace_id": res.trace_id,
                       "queue_wait_ms": round(res.queue_wait_s * 1e3, 3)}
            if stream_id is not None:
                # stream answers are labelled: a fresh inference or the
                # session's EWMA
                payload["degraded"] = bool(res.degraded)
                if res.staleness_s is not None:
                    payload["staleness_s"] = round(res.staleness_s, 6)
            if res.density is not None:
                payload["density"] = res.density[..., 0].tolist()
            self._send(200, payload,
                       headers={"X-CanTpu-Trace-Id": res.trace_id})

    return Handler


def serve_http(service: CountService, *, host: str = "127.0.0.1",
               port: int = 8000):
    """A ``ThreadingHTTPServer`` for ``service`` (the caller runs
    ``serve_forever()``): one thread per client connection; the batcher
    thread (one engine) or the replica threads (a fleet) own the
    devices."""
    from http.server import ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 resets connections
        # when a burst of clients connects at once
        request_queue_size = 128

    return Server((host, port), make_http_handler(service))
