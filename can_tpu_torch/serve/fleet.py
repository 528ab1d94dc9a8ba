"""FleetEngine: N replica ServeEngines behind one work-stealing dispatcher
(counterpart of ``can_tpu/serve/fleet.py``; the JAX fleet's defaults,
event kinds and payloads).

* **Placement** — the weights are quantized ONCE on the host
  (``serve/quant.py``); the fleet keeps that host tree (``host_tree``) as
  the CURRENT generation, and each replica's ``ServeEngine`` puts it on
  its own device.  ``devices=`` is the scale universe, a list of SLOTS:
  a replica owns a slot index, not a device, so one device may be listed
  several times (the CPU tests list ``cpu`` a few times; the one-card
  smoke lists ``cuda:0`` a few times — replicas then time-slice that
  card, a correctness check and nothing more).  With no ``devices=``
  the universe is every visible GPU, ``cuda:0..n-1``, one replica per
  card; with no GPU the fleet raises ``device.NoCudaDeviceError`` and
  never falls back to the CPU.

* **Work stealing** — one shared queue of assembled micro-batches; every
  idle replica thread pulls the next item (``sched.pick_work``: urgent
  deadline-pressured work first, the rest cheapest-first, age-promoted
  against starvation, stream pins as an affinity preference; or FIFO).
  A replica is only ever idle when the queue is empty.  The batcher
  keeps its single assembly thread; ``CountService`` routes its dispatch
  here instead of executing inline.

* **Failure containment** — a replica whose predict raises is
  QUARANTINED (out of dispatch, visible on ``/healthz`` and as a
  ``fleet.replica`` event) and its in-flight batch is re-dispatched
  exactly once to a healthy replica.  A batch that fails on a SECOND
  replica is rejected with ``error`` and that replica stays in service
  (a poison input, not a dead replica).  When the last replica
  quarantines, queued work is failed instead of hanging.

* **Blue/green rollout** — ``rollout(state_dict)`` ships a new
  checkpoint with zero rejected or dropped requests: the serve-config
  drift guard, a structure guard against the host tree's signature, a
  STAGING engine on the last replica's device that runs every warmed
  (bucket, size, dtype) batch with the new weights while traffic
  continues, then each live replica flipped in turn under its dispatch
  lock through ``ServeEngine.swap_params`` (same signature, so no new
  one).  Quarantined replicas are skipped: they rejoin at the current
  generation when resurrected.

* **Self healing** — a quarantined replica releases its device weights
  at once and enters probation: after a backoff-with-jitter cooldown the
  maintenance thread starts a probe thread that builds a fresh engine
  from the host tree of the CURRENT generation, runs one warm-bucket
  predict off-path, warms the grid, and swaps a fresh ``ReplicaState``
  (same index and slot, a fresh incarnation name) into dispatch.  A
  failed probe escalates the backoff.  ``add_replica`` /
  ``remove_replica`` grow and drain the fleet with the same zero-drop
  choreography (``serve/autoscale.py`` drives them).

* **The watchdog** — every launch carries a deadline
  (``priced_deadline_s``: the cost ledger's measured time x slack when
  the telemetry has a ``ledger`` — the CLIs arm one with any telemetry
  flag, and each replica's engine registers its programs there under its
  incarnation name, ``serve_predict_r{k}``, the prefix the fleet's own
  ``name`` looks up; without one, or before a program has a reliable
  timing, ``watchdog_default_s`` for a warmed signature and
  ``watchdog_compile_s`` for an unwarmed one, as the JAX fleet does).  An
  overdue replica is marked ``wedged``, its batch re-dispatched under the
  redispatch-once rule, and the replica sent to probation; its thread is
  abandoned, never waited on.  On a GPU this contains a stalled HOST
  thread (what ``replica_hang`` injects: the worker sleeps inside the
  launch).  It cannot contain a CUDA kernel that really hangs: the
  kernel keeps its context busy, abandoning the Python thread frees
  nothing on the card, and every other replica on that card stalls
  behind it (ROADMAP Queue 3 lists this as an open difference).

* **Threads and the CUDA current device** — it is per thread, and a new
  thread starts on device 0.  Every worker, probe and staging body, and
  every ``release_buffers`` (``torch.cuda.empty_cache`` acts on the
  current device), runs inside ``_device_guard(device)``.

* **AOT bundles** (``serve/aot.py``) — ``aot_bundle=`` (a path or an
  ``AotBundle``) is checked at construction and again at ``warmup``
  against the bucket grid, ``max_batch`` and the size menu (a bundle that
  does not cover the grid is refused, never partly used); every replica
  engine, resurrected and scaled-up ones included, takes its device's
  signature table and the bundle's kernel libraries, and the resurrection
  and scale reports carry its ``aot_hits``.  ``bake_aot(out_dir,
  devices=)`` writes a bundle for every device of the scale universe;
  ``load_aot(bundle)`` attaches one to a running fleet.

``telemetry``: an object with ``emit(kind, **payload)``, or None.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from can_tpu_torch.data.batching import pad_batch
from can_tpu_torch.device import NoCudaDeviceError
from can_tpu_torch.obs import supervised_loop
from can_tpu_torch.sched import normalize_sizes, pick_work
from can_tpu_torch.serve.aot import bake_aot_bundle, load_aot_bundle, signature_sha
from can_tpu_torch.serve.engine import ServeEngine, tree_signature
from can_tpu_torch.serve.quant import host_tree, quantize_tree
from can_tpu_torch.serve.queue import REJECT_DEADLINE, REJECT_ERROR
from can_tpu_torch.testing.faults import active_injector

REPLICA_ACTIVE = "active"
REPLICA_QUARANTINED = "quarantined"
REPLICA_WEDGED = "wedged"        # watchdog-declared hung launch
REPLICA_DRAINING = "draining"    # scale-down: finish in-flight, exit

# JAX's constructor defaults, fixed here until a caller needs another
# value: the age past which queued work is served regardless of cost, the
# deadline margin that makes work urgent, the probation backoff's growth
# per failed probe, and the least priced watchdog deadline (the cost
# ledger prices the deadline above it, ``priced_deadline_s``)
STARVATION_AGE_S = 2.0
DEADLINE_PRESSURE_S = 0.5
PROBE_BACKOFF_FACTOR = 2.0
WATCHDOG_FLOOR_S = 1.0

class FleetClosedError(RuntimeError):
    """Work submitted after the fleet shut down."""


class ReplicaWedgedError(RuntimeError):
    """A launch blew through its priced watchdog deadline."""


def priced_deadline_s(ledger, name_prefix: str, shape, *,
                      slack: float, floor_s: float,
                      default_s: float, dtype=None) -> float:
    """Watchdog deadline for one launch: the cost ledger's measured
    mean execute time for this exact image (shape, dtype) — max over
    this fleet's replica programs, timing-reliable rows only — x
    ``slack``, floored at ``floor_s``.  Falls back to ``default_s``
    when no ledger is armed or no reliable timing exists yet (first
    batches after warmup, or a backend whose cost analysis never
    reported) — a fixed bound beats an unbounded hang, and the priced
    bound takes over as launches accumulate.  ``dtype`` matters: a u8
    batch is a DIFFERENT program than the same-shape f32 one, and
    pricing it off the f32 rows would set a deadline the u8 program
    never agreed to (rows with unknown dtype still match)."""
    if ledger is None:
        return default_s
    try:
        rows = [r for r in ledger.rows()
                if r["name"].startswith(name_prefix)
                and tuple(r["shape"]) == tuple(shape)
                and (dtype is None or r.get("dtype") in (dtype, "?"))
                and r["timing_reliable"] and r["mean_s"]]
    # pricing must never kill dispatch; the fixed default is the degrade
    except Exception:
        return default_s
    if not rows:
        return default_s
    return max(max(r["mean_s"] for r in rows) * slack, floor_s)


def default_devices() -> List[torch.device]:
    """Every visible GPU, ``cuda:0..n-1`` — one replica per card.  Raises
    ``NoCudaDeviceError`` without one: a fleet never falls back to the
    CPU unless the caller lists it."""
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "a serving fleet puts one replica on each GPU — pass devices= "
            "(or --platform cpu) to run on the CPU instead")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def check_replicas(replicas: int, devices: Sequence) -> None:
    """One replica per slot: more replicas than slots is refused (the
    serve CLI asks this before the weights load)."""
    if replicas > len(devices):
        raise ValueError(
            f"replicas={replicas} exceeds the {len(devices)} available "
            f"devices — a replica without its own device just time-"
            f"slices another's, add chips or lower --replicas")


def _device_guard(device: torch.device):
    """This thread's CUDA current device set to ``device`` for the body;
    nothing to set for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _WorkItem:
    __slots__ = ("bucket_hw", "batch", "requests", "redispatches",
                 "t_enqueue", "seq", "cost_px", "min_deadline", "pin")

    def __init__(self, bucket_hw, batch, requests, *,
                 t_enqueue: float = 0.0, seq: int = 0,
                 pin: Optional[int] = None):
        self.bucket_hw = bucket_hw
        self.batch = batch
        self.requests = requests
        self.redispatches = 0
        # priced-dispatch facts (sched.pick_work): enqueue time + seq for
        # the age/tie rules, model cost (area * slots) for cheapest-first,
        # earliest live deadline for the urgency class
        self.t_enqueue = t_enqueue
        self.seq = seq
        self.cost_px = (float(bucket_hw[0] * bucket_hw[1])
                        * batch.image.shape[0])
        deadlines = [r.deadline_ts for r in requests
                     if r.deadline_ts is not None]
        self.min_deadline = min(deadlines) if deadlines else None
        # sticky stream routing (serve/streams.py): the replica index
        # this batch's streams prefer — a dispatch-ordering PREFERENCE
        # only, validated live by the service before enqueue
        self.pin = pin


class ReplicaState:
    """One replica: engine + slot + device + dispatch lock + health.

    ``inflight`` is ``(item, t_start, deadline_s)`` while the worker is
    inside a launch (guarded by the fleet's ``_cond``): the watchdog's
    whole view of a possibly-hung launch.  ``probe_at`` /
    ``probe_failures`` / ``backoff_s`` drive probation after quarantine.
    Resurrection REPLACES the ReplicaState (same index and slot, fresh
    engine + worker thread), so an abandoned worker holding the old
    object can never serve alongside the new one."""

    def __init__(self, index: int, slot: int, device, engine: ServeEngine):
        self.index = index
        self.slot = slot
        self.device = device
        self.engine = engine
        # held for the duration of each predict AND for a rollout flip —
        # swap_params never races an in-flight batch
        self.lock = threading.Lock()
        self.state = REPLICA_ACTIVE
        self.batches = 0
        self.failures = 0
        self.error: Optional[str] = None
        self.generation = 0
        self.inflight: Optional[Tuple] = None  # guarded by fleet._cond
        self.probe_at: Optional[float] = None
        self.probe_failures = 0
        self.backoff_s: Optional[float] = None
        self.thread: Optional[threading.Thread] = None
        # probation bookkeeping (guarded by fleet._cond): ``probing`` is
        # the start ts of an in-flight probe thread, ``probe_token``
        # invalidates a timed-out/superseded probe so its late result
        # can never swap in
        self.probing: Optional[float] = None
        self.probe_token = 0

    def snapshot(self) -> dict:
        return {"replica": self.index, "device": str(self.device),
                "state": self.state, "batches": self.batches,
                "failures": self.failures, "error": self.error,
                "generation": self.generation,
                "probe_failures": self.probe_failures}


class FleetEngine:
    """N device-pinned replica engines + the shared work queue.

    state_dict: reference-layout f32 weights (BN running statistics
    included for the BN model), on any device.  serve_dtype picks the
    storage/compute mode for EVERY replica (``serve/quant.py``).
    replicas: engine count, one per slot of ``devices`` (default
    ``default_devices()``).  run_config: the checkpoint's saved run
    config (``utils.checkpoint.load_run_config``), kept for the rollout
    drift guard; None skips the config check on rollout.
    """

    def __init__(self, state_dict, *, replicas: int = 2,
                 serve_dtype: str = "f32", compute_dtype=None, ds: int = 8,
                 devices: Optional[Sequence] = None, telemetry=None,
                 run_config: Optional[dict] = None,
                 name: str = "serve_predict", aot_bundle=None,
                 self_heal: bool = True,
                 maintain_interval_s: float = 0.25,
                 probe_cooldown_s: float = 5.0,
                 probe_backoff_max_s: float = 120.0,
                 probe_jitter: float = 0.1,
                 page_after_probes: int = 3,
                 watchdog_slack: float = 10.0,
                 watchdog_default_s: float = 30.0,
                 dispatch_order: str = "priced"):
        if dispatch_order not in ("priced", "fifo"):
            raise ValueError(f"unknown dispatch_order {dispatch_order!r} "
                             f"(priced | fifo)")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        devices = [torch.device(d) for d in (
            devices if devices is not None else default_devices())]
        check_replicas(replicas, devices)
        self.ds = int(ds)
        self.serve_dtype = serve_dtype
        self._compute_dtype = compute_dtype
        self.telemetry = telemetry
        self.run_config = run_config
        self.name = name
        self.generation = 0
        # the scale universe: every slot a replica may ever own —
        # self.devices (below) is just the INITIAL placement
        self._devices_all = devices
        self.devices = devices[:replicas]
        self.self_heal = bool(self_heal)
        self.maintain_interval_s = float(maintain_interval_s)
        self.probe_cooldown_s = float(probe_cooldown_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.probe_jitter = float(probe_jitter)
        self.page_after_probes = int(page_after_probes)
        self.watchdog_slack = float(watchdog_slack)
        self.watchdog_default_s = float(watchdog_default_s)
        # probes run on their OWN daemon threads (a probe predict on a
        # still-sick device can hang exactly like the launch that wedged
        # it); this bounds how long a probe may run before it is
        # declared failed and its thread abandoned
        self.probe_timeout_s = 600.0
        # deadline for a launch of a signature the engine has NOT run
        # yet: a first launch pays cuDNN's per-shape setup, and pricing
        # it like a steady-state launch would wedge a healthy replica
        self.watchdog_compile_s = 900.0
        # jitter is seeded per fleet: chaos tests reproduce bit-exactly
        self._rng = random.Random(0xC0FFEE)
        # shared-queue dispatch ordering (sched.pick_work): "priced" =
        # cheapest-feasible-first under deadline pressure with the
        # starvation age bound; "fifo" = pure FIFO
        self.dispatch_order = dispatch_order
        self._work_seq = 0

        # the CURRENT generation's quantized tree, HOST-side: what every
        # replica, resurrection and scale-up stages from — a dead replica
        # costs zero device memory, not "zero plus a pinned copy"
        self._host_q = host_tree(quantize_tree(state_dict, serve_dtype))
        self._sig_sha = signature_sha(self._host_q)
        if isinstance(aot_bundle, str):
            aot_bundle = load_aot_bundle(aot_bundle)
        if aot_bundle is not None:
            aot_bundle.check(sig_sha=self._sig_sha, serve_dtype=serve_dtype,
                             ds=self.ds, device=devices[0])
        self._aot = aot_bundle
        self.replicas: List[ReplicaState] = []
        for k, dev in enumerate(self.devices):
            with _device_guard(dev):
                engine = self._engine(dev, f"{name}_r{k}",
                                      aot_programs=self._aot_programs(dev))
            self.replicas.append(ReplicaState(k, k, dev, engine))
        # per-slot incarnation counters: a resurrected replica's engine
        # gets a DISTINCT program name (f"{name}_r{k}i{n}"), so its
        # compile_count starts at zero and a stream pin into the old
        # incarnation fails its token match
        self._incarnations = {k: 1 for k in range(replicas)}
        self._next_index = replicas

        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._swept = False  # close()'s leftover sweep has run
        self._started = False
        self._threads: List[threading.Thread] = []
        self._rollout_lock = threading.Lock()
        self._warmup_spec: Optional[Tuple] = None
        self._maint_thread: Optional[threading.Thread] = None
        self._maint_stop = threading.Event()
        self._probe_threads: List[threading.Thread] = []
        # serialises scale transitions against EACH OTHER only — device
        # work (a new replica's warmup, a drain join) must never hold
        # _rollout_lock, or a sick spare device would freeze probes,
        # rollout, and the rest of the healing layer with it
        self._scale_lock = threading.Lock()
        # bound by CountService: completion/failure sinks for executed work
        self._on_complete: Optional[Callable] = None
        self._on_fail: Optional[Callable] = None
        self._on_reject: Optional[Callable] = None
        # deadline checks must read the SAME clock that stamped
        # deadline_ts (the service's, injectable for fake-clock tests)
        self._clock = time.monotonic

    def _engine(self, device, name: str, tree: Optional[dict] = None,
                aot_programs=None) -> ServeEngine:
        return ServeEngine(self._host_q if tree is None else tree,
                           device=device, serve_dtype=self.serve_dtype,
                           compute_dtype=self._compute_dtype, ds=self.ds,
                           quantized=True, name=name, telemetry=self.telemetry,
                           aot_programs=aot_programs)

    def _aot_programs(self, device):
        """The loaded bundle's signature table for ``device`` (replica
        engines take it; staging engines none, as in JAX)."""
        return self._aot.programs_for(device) if self._aot is not None else None

    def _emit(self, kind: str, **payload) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(kind, **payload)

    # -- service binding --------------------------------------------------
    def bind(self, *, on_complete: Callable, on_fail: Callable,
             on_reject: Optional[Callable] = None, clock=None) -> None:
        """``on_complete(bucket_hw, batch, requests, counts, density,
        execute_s, compiled, replica, program)`` after a successful batch;
        ``on_fail(requests, exc)`` after a twice-failed one;
        ``on_reject(reason, count)`` counts rejections the fleet already
        emitted telemetry for (zombie-batch shedding).  Before start()."""
        self._on_complete = on_complete
        self._on_fail = on_fail
        self._on_reject = on_reject
        if clock is not None:
            self._clock = clock

    # -- engine-compatible surface ---------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct launch signatures across live+quarantined replicas
        (staging engines keep their own)."""
        return sum(r.engine.compile_count for r in self.replicas)

    def live_replicas(self) -> int:
        return sum(1 for r in self.replicas if r.state == REPLICA_ACTIVE)

    def warmup(self, bucket_shapes, max_batch: int, *,
               dtypes=(np.float32,), sizes=None) -> dict:
        """Warm EVERY replica's full (bucket, size, dtype) grid — each
        engine pays its own first launches here and none during traffic.
        ``sizes`` is the scheduling core's launch-size menu (None = just
        ``max_batch``).  The spec is remembered: rollout's staging
        warmup, probation and scale-up re-run exactly this grid."""
        sizes = normalize_sizes(max_batch, sizes)
        self._warmup_spec = (sorted(set(map(tuple, bucket_shapes))),
                             int(max_batch), tuple(dtypes), sizes)
        if self._aot is not None:
            # the bundle must cover THIS grid at THIS batch geometry: a
            # partial hit would hide first-seen signatures behind "AOT"
            self._aot.check(sig_sha=self._sig_sha,
                            serve_dtype=self.serve_dtype, ds=self.ds,
                            max_batch=max_batch,
                            bucket_shapes=self._warmup_spec[0],
                            batch_sizes=sizes, device=self._devices_all[0])
        t0 = time.perf_counter()
        shapes = compiles = 0
        for r in self.replicas:
            with r.lock, _device_guard(r.device):
                rep = r.engine.warmup(bucket_shapes, max_batch,
                                      dtypes=dtypes, sizes=sizes)
            shapes = rep["shapes"]
            compiles += rep["compiles"]
        return {"shapes": shapes, "sizes": len(sizes),
                "compiles": compiles,
                "replicas": len(self.replicas),
                "seconds": round(time.perf_counter() - t0, 3)}

    # -- lifecycle --------------------------------------------------------
    def _spawn_worker(self, replica: ReplicaState) -> None:
        t = threading.Thread(target=self._worker, args=(replica,),
                             daemon=True,
                             name=f"can-tpu-fleet-r{replica.index}")
        replica.thread = t
        with self._cond:
            self._threads.append(t)
        t.start()

    def start(self) -> "FleetEngine":
        if self._started:
            return self
        self._started = True
        for r in self.replicas:
            self._spawn_worker(r)
        if self.self_heal and self._maint_thread is None:
            self._maint_stop.clear()
            t = threading.Thread(target=self._maintain_loop, daemon=True,
                                 name="can-tpu-fleet-maint")
            self._maint_thread = t
            t.start()
        return self

    def close(self, *, drain_timeout_s: float = 60.0) -> None:
        """Drain queued work through the replicas, then stop the threads.
        Anything still queued when no live replica remains (or the drain
        times out) is failed, never silently dropped."""
        # maintenance first: a probe mid-close would race the drain
        self._maint_stop.set()
        mt = self._maint_thread
        if mt is not None:
            mt.join(timeout=10.0)
            self._maint_thread = None
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        deadline = time.monotonic() + drain_timeout_s
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
        self._threads = []
        leftovers = []
        with self._cond:
            self._swept = True
            while self._queue:
                leftovers.append(self._queue.popleft())
        for item in leftovers:
            self._fail(item, FleetClosedError("fleet closed with work "
                                              "still queued"))

    # -- dispatch ---------------------------------------------------------
    def live_tokens(self) -> dict:
        """``{replica index: incarnation token}`` of the ACTIVE set —
        what the stream registry validates pins against.  The token is
        the engine's program name: a resurrection REPLACES the engine
        under a fresh name, so a pin into an abandoned incarnation
        fails the token match even though the index came back."""
        with self._cond:
            return {r.index: r.engine.name for r in self.replicas
                    if r.state == REPLICA_ACTIVE}

    def submit_work(self, bucket_hw, batch, requests, *,
                    pin: Optional[int] = None) -> None:
        """Called by the service's dispatch (the batcher thread): enqueue
        one assembled micro-batch for whichever replica frees up first
        (``pin`` biases the priced pick toward that replica — stream
        locality — without ever reserving the item for it)."""
        with self._cond:
            item = _WorkItem(bucket_hw, batch, requests,
                             t_enqueue=self._clock(), seq=self._work_seq,
                             pin=pin)
            self._work_seq += 1
            if not self._closed and self.live_replicas() > 0:
                self._queue.append(item)
                self._cond.notify()
                return
            closed = self._closed
        self._fail(item, FleetClosedError(
            "fleet closed" if closed else "no live replicas"))

    def _pop_next_locked(self, replica: Optional[ReplicaState] = None
                         ) -> _WorkItem:
        """Next work item under ``_cond``: the scheduling core's priced
        order, or plain FIFO when configured.  A redispatched batch sits
        at the queue FRONT and is also urgent-class, so both orders serve
        it first."""
        if self.dispatch_order == "fifo" or len(self._queue) == 1:
            return self._queue.popleft()
        i = pick_work(self._queue, self._clock(),
                      starvation_age_s=STARVATION_AGE_S,
                      pressure_s=DEADLINE_PRESSURE_S,
                      prefer=None if replica is None else replica.index)
        item = self._queue[i]
        del self._queue[i]
        return item

    def _take(self, replica: ReplicaState) -> Optional[_WorkItem]:
        with self._cond:
            while True:
                if replica.state != REPLICA_ACTIVE:
                    return None
                if self._queue:
                    return self._pop_next_locked(replica)
                if self._closed:
                    return None
                self._cond.wait(0.1)

    def _worker(self, replica: ReplicaState) -> None:
        with _device_guard(replica.device):
            self._serve(replica)

    def _serve(self, replica: ReplicaState) -> None:
        while True:
            item = self._take(replica)
            if item is None:
                return
            # zombie-batch shed: a batch whose EVERY request has already
            # expired behind the work queue would burn a launch producing
            # results nobody is waiting for — reject instead.  A batch
            # with ANY live request still runs whole.
            now = self._clock()
            if all(r.done or r.expired(now) for r in item.requests):
                n = 0
                for r in item.requests:
                    if not r.done:
                        r.reject(REJECT_DEADLINE,
                                 "expired behind the fleet work queue")
                        n += 1
                if n:
                    self._emit("serve.reject", reason=REJECT_DEADLINE,
                               count=n)
                    if self._on_reject is not None:
                        self._on_reject(REJECT_DEADLINE, n)
                continue
            # register the launch for the watchdog BEFORE entering it:
            # (item, start, deadline) under _cond is the watchdog's whole
            # view of this replica
            with self._cond:
                replica.inflight = (item, self._clock(),
                                    self._deadline_for(item, replica))
            t0 = time.perf_counter()
            try:
                with replica.lock:
                    inj = active_injector()
                    if inj is not None:
                        # serve chaos hooks (testing/faults.py):
                        # replica_crash raises into the quarantine path,
                        # replica_hang sleeps into the watchdog's arms
                        inj.on_serve_batch(replica=replica.index,
                                           batch_index=replica.batches + 1)
                    want = any(r.want_density for r in item.requests)
                    counts, density = replica.engine.predict_batch(
                        item.batch, want_density=want)
                    compiled = replica.engine.last_batch_compiled
                    replica.batches += 1
            except Exception as e:  # noqa: BLE001 — replica failure path
                # the traceback's frames hold the failed launch's tensors
                # and the replica's module: drop them, or quarantine's
                # release would free nothing until they go
                e.__traceback__ = None
                if self._finish_inflight(replica, item):
                    self._quarantine(replica, item, e)
                # else: the watchdog already wedged us and re-dispatched
                # the batch — nothing left to attribute
                continue
            execute_s = time.perf_counter() - t0
            if not self._finish_inflight(replica, item):
                # wedged mid-launch: the watchdog stole the batch — discard
                # our late results; the next _take retires this thread
                continue
            if self._on_complete is not None:
                self._on_complete(item.bucket_hw, item.batch, item.requests,
                                  counts, density, execute_s, compiled,
                                  replica.index, replica.engine.name)

    def _finish_inflight(self, replica: ReplicaState, item: _WorkItem
                         ) -> bool:
        """Clear the replica's in-flight slot iff it still owns ``item``;
        False means the watchdog stole it (exactly one of the worker and
        the watchdog wins — both mutate under ``_cond``)."""
        with self._cond:
            mine = (replica.inflight is not None
                    and replica.inflight[0] is item)
            if mine:
                replica.inflight = None
            return mine

    def _deadline_for(self, item: _WorkItem,
                      replica: ReplicaState) -> float:
        try:
            warm = replica.engine.is_warm(item.batch)
        # pricing must never kill dispatch; assume warm = the tighter bound
        except Exception:
            warm = True
        if not warm:
            # a legitimate first launch of a signature: give it the
            # first-launch allowance, not the steady-state deadline
            return max(self.watchdog_compile_s, self.watchdog_default_s)
        ledger = getattr(self.telemetry, "ledger", None)
        return priced_deadline_s(ledger, self.name,
                                 item.batch.image.shape,
                                 dtype=str(item.batch.image.dtype),
                                 slack=self.watchdog_slack,
                                 floor_s=WATCHDOG_FLOOR_S,
                                 default_s=self.watchdog_default_s)

    def _quarantine(self, replica: ReplicaState, item: _WorkItem,
                    exc: Exception) -> None:
        replica.failures += 1
        item.redispatches += 1
        if item.redispatches > 1:
            # failed on a SECOND distinct replica (the first was
            # quarantined before the re-dispatch): the batch is the
            # poison, not the fleet — reject it and keep this replica
            # serving
            self._emit("fleet.replica", **replica.snapshot())
            self._fail(item, exc)
            return
        replica.state = REPLICA_QUARANTINED
        replica.error = f"{type(exc).__name__}: {exc}"
        # a dead replica's weights leave the device NOW — probation
        # re-stages from the fleet's host-side current-generation copy
        with _device_guard(replica.device):
            replica.engine.release_buffers()
        self._schedule_probe(replica, self._clock())
        self._emit("fleet.replica", **replica.snapshot())
        self._requeue_or_fail(item, exc)

    def _requeue_or_fail(self, item: _WorkItem, exc: Exception) -> None:
        """The redispatch choreography shared by quarantine and the
        watchdog: requeue to the FRONT while any live worker can drain
        it; fail it (and, after the last replica, everything queued)
        otherwise."""
        stranded = [item]
        with self._cond:
            if self.live_replicas() > 0 and not self._swept:
                # front of the queue: its requests have waited longest.
                # ALSO while close() drains: the remaining live workers
                # still pull, and close()'s leftover sweep fails what they
                # don't reach (_swept guards the post-sweep stragglers)
                self._queue.appendleft(item)
                self._cond.notify()
                return
            if self.live_replicas() == 0:
                # the LAST live replica just died: no worker remains to
                # drain the queue, so everything queued is failed too
                while self._queue:
                    stranded.append(self._queue.popleft())
        for it in stranded:
            self._fail(it, exc)

    def _fail(self, item: _WorkItem, exc: Exception) -> None:
        if self._on_fail is not None:
            self._on_fail(item.requests, exc)
        else:  # unbound fleet (direct tests): reject inline
            for r in item.requests:
                if not r.done:
                    r.reject(REJECT_ERROR, f"{type(exc).__name__}: {exc}")

    # -- self healing: watchdog + probation + resurrection ----------------
    def _maintain_loop(self) -> None:
        supervised_loop(self._maint_stop, self.maintain_interval_s,
                        self.maintenance_tick, "fleet-maintenance")

    def maintenance_tick(self, now: Optional[float] = None) -> None:
        """One supervision pass: wedge overdue launches, probe replicas
        whose cooldown has elapsed.  Runs on the maintenance thread in
        production; tests drive it directly with a fake clock."""
        now = self._clock() if now is None else now
        self._watchdog_sweep(now)
        self._probe_sweep(now)

    def _watchdog_sweep(self, now: float) -> None:
        wedged = []
        with self._cond:
            for r in list(self.replicas):
                # DRAINING replicas are covered too: a launch that hangs
                # during scale-down would otherwise strand its batch
                # behind remove_replica's bounded join
                if (r.state not in (REPLICA_ACTIVE, REPLICA_DRAINING)
                        or r.inflight is None):
                    continue
                item, t0, deadline = r.inflight
                if now - t0 <= deadline:
                    continue
                # overdue: mark the replica wedged (it leaves dispatch the
                # moment its thread next looks), steal the batch, send the
                # replica to probation.  The thread is abandoned, never
                # joined: if the launch ever returns, _finish_inflight
                # tells it the batch is no longer its
                was_draining = r.state == REPLICA_DRAINING
                r.state = REPLICA_WEDGED
                r.failures += 1
                r.error = (f"watchdog: launch exceeded its "
                           f"{deadline:.3f}s priced deadline")
                r.inflight = None
                wedged.append((r, item, was_draining))
        for r, item, was_draining in wedged:
            # drop the engine's own weight refs NOW (same rule as
            # quarantine): the stuck launch's frames keep its working set
            # until it returns, but the engine must not ALSO pin a copy
            with _device_guard(r.device):
                r.engine.release_buffers()
            self._emit("fleet.replica", **r.snapshot())
            exc = ReplicaWedgedError(r.error)
            item.redispatches += 1
            if item.redispatches > 1:
                # second strike: the batch is the poison
                self._fail(item, exc)
            else:
                self._requeue_or_fail(item, exc)
            if not was_draining:
                # a draining victim is leaving anyway: remove_replica
                # owns its teardown
                self._schedule_probe(r, now)

    def _schedule_probe(self, replica: ReplicaState, now: float, *,
                        escalate: bool = False) -> None:
        """Backoff-with-jitter probation: a fresh quarantine starts at
        ``probe_cooldown_s``; each failed probe multiplies by
        ``PROBE_BACKOFF_FACTOR`` up to ``probe_backoff_max_s``.  Jitter
        (seeded) keeps a fleet of replicas from probing in lockstep."""
        if replica.backoff_s is None or not escalate:
            replica.backoff_s = self.probe_cooldown_s
        else:
            replica.backoff_s = min(
                replica.backoff_s * PROBE_BACKOFF_FACTOR,
                self.probe_backoff_max_s)
        jitter = 1.0 + self.probe_jitter * (2.0 * self._rng.random() - 1.0)
        replica.probe_at = now + replica.backoff_s * jitter

    def _probe_sweep(self, now: float) -> None:
        """Launch due probes on their OWN daemon threads and fail probes
        that blew ``probe_timeout_s``.  The maintenance thread never
        blocks on device work: a hung probe costs one abandoned thread —
        not the watchdog, the other probes, rollout, and the
        autoscaler."""
        if self._warmup_spec is None or self._closed:
            return
        due, timed_out = [], []
        with self._cond:
            for r in self.replicas:
                if r.state not in (REPLICA_QUARANTINED, REPLICA_WEDGED):
                    continue
                if r.probing is not None:
                    if now - r.probing > self.probe_timeout_s:
                        r.probe_token += 1  # a late result cannot swap in
                        r.probing = None
                        r.probe_failures += 1
                        timed_out.append(r)
                    continue
                if r.probe_at is not None and now >= r.probe_at:
                    r.probing = now
                    r.probe_token += 1
                    due.append((r, r.probe_token))
        for r in timed_out:
            err = f"probe timed out after {self.probe_timeout_s:g}s"
            self._schedule_probe(r, now, escalate=True)
            self._emit("fleet.probe", replica=r.index, ok=False,
                       probe_failures=r.probe_failures, error=err,
                       next_backoff_s=round(r.backoff_s, 3))
            self._maybe_page(r, err)
        for r, token in due:
            t = threading.Thread(target=self._probe_worker,
                                 args=(r, token), daemon=True,
                                 name=f"can-tpu-fleet-probe-r{r.index}")
            with self._cond:
                self._probe_threads.append(t)
            t.start()

    def join_probes(self, timeout_s: float = 60.0) -> None:
        """Wait (bounded) for in-flight probe threads — the seam
        deterministic tests drive after a ``maintenance_tick``; a hung
        probe makes this return at the timeout, never blocks forever."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            threads = list(self._probe_threads)
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        with self._cond:
            self._probe_threads = [t for t in self._probe_threads
                                   if t.is_alive()]

    def _maybe_page(self, replica: ReplicaState, error: str) -> None:
        if replica.probe_failures < self.page_after_probes:
            return
        inc = getattr(self.telemetry, "incidents", None)
        if inc is not None:
            # the incident manager's per-reason cooldown makes this page
            # exactly once per cooldown, however often the probe fails
            inc.trigger("fleet_probe_failed",
                        detail={"replica": replica.index,
                                "probe_failures": replica.probe_failures,
                                "error": error})

    def _build_replica_engine(self, index: int, device) -> ServeEngine:
        """A fresh engine at the CURRENT generation, staged from the
        host-side quantized tree.  Each incarnation gets a distinct name
        so its compile_count starts at zero — a recovery-path first
        launch is visible, never absorbed by the old engine."""
        with self._cond:
            tree = self._host_q
            n = self._incarnations.get(index, 0)
            self._incarnations[index] = n + 1
        name = (f"{self.name}_r{index}" if n == 0
                else f"{self.name}_r{index}i{n}")
        return self._engine(device, name, tree,
                            aot_programs=self._aot_programs(device))

    def _probe_worker(self, replica: ReplicaState, token: int) -> None:
        """One probation attempt, on its own thread: stage current-
        generation weights on the replica's device, run one warm-bucket
        predict OFF-PATH, warm the full grid, then swap a fresh
        ReplicaState into dispatch.  Device work happens WITHOUT
        ``_rollout_lock``; the swap-in re-checks the generation under it
        (a rollout that landed mid-probe makes the staged weights stale
        — re-probe promptly rather than serve them)."""
        with _device_guard(replica.device):
            self._probe(replica, token)

    def _probe(self, replica: ReplicaState, token: int) -> None:
        gen = self.generation
        shapes, max_batch, dtypes, sizes = self._warmup_spec
        t0 = time.perf_counter()
        try:
            engine = self._build_replica_engine(replica.index,
                                                replica.device)
            # the probe proper: ONE warm-bucket predict, off-path — a
            # sick device/weights fails here, not on live traffic
            bh, bw = min(shapes)
            img = np.zeros((bh, bw, 3), dtypes[0])
            dm = np.zeros((bh // self.ds, bw // self.ds, 1), np.float32)
            engine.predict_batch(pad_batch([(img, dm)], (bh, bw),
                                           max_batch, [False], self.ds))
            rep = engine.warmup(shapes, max_batch, dtypes=dtypes,
                                sizes=sizes)
        except Exception as e:  # noqa: BLE001 — probe failure is data
            with self._cond:
                if replica.probe_token != token:
                    return  # timed out / superseded: stale thread
                started = replica.probing
                replica.probing = None
                replica.probe_failures += 1
            # backoff from the probe's START (the clock that scheduled
            # it): deterministic under fake clocks
            now = started if started is not None else self._clock()
            self._schedule_probe(replica, now, escalate=True)
            self._emit("fleet.probe", replica=replica.index, ok=False,
                       probe_failures=replica.probe_failures,
                       error=f"{type(e).__name__}: {e}",
                       next_backoff_s=round(replica.backoff_s, 3))
            self._maybe_page(replica, f"{type(e).__name__}: {e}")
            return
        with self._rollout_lock:
            if self._closed:
                engine.release_buffers()
                return
            if self.generation != gen:
                # rolled forward mid-probe: discard the stale staging and
                # re-probe promptly at the new generation
                engine.release_buffers()
                with self._cond:
                    if replica.probe_token == token:
                        replica.probing = None
                        replica.probe_at = self._clock()
                return
            fresh = ReplicaState(replica.index, replica.slot,
                                 replica.device, engine)
            fresh.generation = gen
            fresh.failures = replica.failures  # lifetime count survives
            with self._cond:
                if (replica.probe_token != token
                        or replica not in self.replicas):
                    engine.release_buffers()
                    return  # superseded or retired while we probed
                replica.probing = None
                self.replicas[self.replicas.index(replica)] = fresh
                self._cond.notify_all()
            # the old ReplicaState (and any abandoned wedged thread
            # holding it) is now unreachable from dispatch
            if self._started:
                self._spawn_worker(fresh)
            self._emit("fleet.probe", replica=replica.index, ok=True,
                       probe_failures=replica.probe_failures)
            self._emit("fleet.resurrect", replica=fresh.index,
                       generation=gen, live=self.live_replicas(),
                       seconds=round(time.perf_counter() - t0, 3),
                       warmup_compiles=rep["compiles"],
                       aot_hits=engine.aot_hits,
                       probe_failures_before=replica.probe_failures)
            self._emit("fleet.replica", **fresh.snapshot())

    # -- autoscaling surface ----------------------------------------------
    def _spare_slots(self) -> List[int]:
        """Slots of the scale universe no replica owns (quarantined
        replicas keep theirs: probation reuses it)."""
        with self._cond:
            used = {r.slot for r in self.replicas}
        return [s for s in range(len(self._devices_all)) if s not in used]

    def spare_devices(self) -> list:
        """The devices of the spare slots (a device listed twice in the
        universe is spare once per free slot)."""
        return [self._devices_all[s] for s in self._spare_slots()]

    def add_replica(self, *, reason: str = "manual") -> dict:
        """Grow the fleet by one replica on a spare slot, at the current
        generation, warmed before it joins dispatch — zero-drop by
        construction.  Returns the scale report (also emitted as
        ``fleet.scale``, with ``time_to_first_ready_s``).

        The staging warmup runs under ``_scale_lock`` only: probes,
        rollout, and the watchdog stay live.  ``_rollout_lock`` is taken
        briefly for the registration, re-checking the generation: a
        rollout that landed mid-warmup makes the staged weights stale,
        and the call raises for the autoscaler to retry."""
        if self._warmup_spec is None:
            raise RuntimeError("add_replica before warmup(): the fleet "
                               "has no (bucket, dtype) grid to warm")
        with self._scale_lock:
            if self._closed:
                raise FleetClosedError("add_replica on a closed fleet")
            spare = self._spare_slots()
            if not spare:
                raise RuntimeError(
                    f"no spare device: {len(self._devices_all)} device(s) "
                    f"all owned — the scale universe is the device list "
                    f"the fleet was built with")
            slot = spare[0]
            dev = self._devices_all[slot]
            t0 = time.perf_counter()
            shapes, max_batch, dtypes, sizes = self._warmup_spec
            with self._cond:
                index = self._next_index
                self._next_index = index + 1
            gen = self.generation
            with _device_guard(dev):
                engine = self._build_replica_engine(index, dev)
                rep = engine.warmup(shapes, max_batch, dtypes=dtypes,
                                    sizes=sizes)
            with self._rollout_lock:
                if self._closed or self.generation != gen:
                    with _device_guard(dev):
                        engine.release_buffers()
                if self._closed:
                    raise FleetClosedError("fleet closed during scale-up")
                if self.generation != gen:
                    raise RuntimeError(
                        "fleet rolled out during scale-up staging — the "
                        "staged weights are stale; retry add_replica")
                fresh = ReplicaState(index, slot, dev, engine)
                fresh.generation = gen
                with self._cond:
                    self.replicas.append(fresh)
                    self._cond.notify_all()
                if self._started:
                    self._spawn_worker(fresh)
                report = {"direction": "up", "replica": index,
                          "device": str(dev), "reason": reason,
                          "live": self.live_replicas(),
                          "generation": gen,
                          "time_to_first_ready_s":
                              round(time.perf_counter() - t0, 3),
                          "warmup_compiles": rep["compiles"],
                          "aot_hits": engine.aot_hits}
                self._emit("fleet.scale", **report)
                self._emit("fleet.replica", **fresh.snapshot())
                return report

    def remove_replica(self, *, reason: str = "manual",
                       drain_timeout_s: float = 60.0) -> dict:
        """Shrink the fleet by one replica, zero-drop: the victim is
        marked ``draining`` (its worker finishes the in-flight batch,
        then retires — queued work belongs to the survivors; a HANG
        during the drain is still the watchdog's to wedge), its device
        weights are released, and it leaves the replica table (its slot
        returns to the spare pool).  The drain join holds
        ``_scale_lock`` only, never ``_rollout_lock``."""
        with self._scale_lock:
            with self._cond:
                live = [r for r in self.replicas
                        if r.state == REPLICA_ACTIVE]
                if len(live) <= 1:
                    raise RuntimeError(
                        "refusing to scale below 1 live replica — close() "
                        "the fleet instead")
                victim = live[-1]
                victim.state = REPLICA_DRAINING
                self._cond.notify_all()
            self._emit("fleet.replica", **victim.snapshot())
            t = victim.thread
            if t is not None:
                t.join(timeout=drain_timeout_s)
            with _device_guard(victim.device):
                victim.engine.release_buffers()
            with self._rollout_lock:
                with self._cond:
                    if victim in self.replicas:
                        self.replicas.remove(victim)
            report = {"direction": "down", "replica": victim.index,
                      "device": str(victim.device), "reason": reason,
                      "live": self.live_replicas(),
                      "generation": self.generation}
            self._emit("fleet.scale", **report)
            return report

    # -- AOT warm start ----------------------------------------------------
    def bake_aot(self, out_dir: str, *, devices=None) -> dict:
        """Write an AOT bundle (``serve/aot.py``) of the warmed (bucket,
        size, dtype) grid for every device of the scale universe (default;
        a device listed in several slots once) at ``out_dir``: what
        resurrection, scale-up and a fresh process load.  Live replicas'
        engines bake on their devices; a device without one gets a
        staging engine whose weights leave with it."""
        with self._rollout_lock:
            if self._warmup_spec is None:
                raise RuntimeError("bake_aot before warmup(): no "
                                   "(bucket, dtype) grid to bake")
            shapes, max_batch, dtypes, sizes = self._warmup_spec
            devices = list(dict.fromkeys(
                torch.device(d) for d in (devices if devices is not None
                                          else self._devices_all)))
            by_dev = {}
            for r in self.replicas:
                if r.state == REPLICA_ACTIVE:
                    by_dev.setdefault(r.device, r)
            engines, staged, locks = [], [], []
            for dev in devices:
                r = by_dev.get(dev)
                if r is not None:
                    engines.append(r.engine)
                    locks.append(r.lock)
                else:
                    with _device_guard(dev):
                        eng = self._engine(dev, f"{self.name}_bake_d{dev}")
                    engines.append(eng)
                    staged.append(eng)
            try:
                with contextlib.ExitStack() as stack:
                    # a replica's engine bakes between two of its launches
                    for lock in locks:
                        stack.enter_context(lock)
                    return bake_aot_bundle(
                        out_dir, engines=engines, bucket_shapes=shapes,
                        max_batch=max_batch, dtypes=dtypes, ds=self.ds,
                        serve_dtype=self.serve_dtype, sig_sha=self._sig_sha,
                        generation=self.generation,
                        telemetry=self.telemetry, batch_sizes=sizes)
            finally:
                for eng in staged:
                    with _device_guard(eng.device):
                        eng.release_buffers()

    def load_aot(self, bundle) -> None:
        """Attach a bundle (path or ``AotBundle``) for the recovery and
        scale paths; staleness-checked against the serving tree and, once
        warmed, the grid."""
        if isinstance(bundle, str):
            bundle = load_aot_bundle(bundle)
        geometry = {}
        if self._warmup_spec is not None:
            shapes, max_batch, _, sizes = self._warmup_spec
            geometry = dict(max_batch=max_batch, bucket_shapes=shapes,
                            batch_sizes=sizes)
        bundle.check(sig_sha=self._sig_sha, serve_dtype=self.serve_dtype,
                     ds=self.ds, device=self._devices_all[0], **geometry)
        with self._rollout_lock:
            self._aot = bundle

    # -- health -----------------------------------------------------------
    def healthz(self) -> dict:
        live = self.live_replicas()
        with self._cond:
            snaps = [r.snapshot() for r in self.replicas]
        # generation skew surfaced, not silent: the serving set's
        # generation spread is a first-class field
        serving_gens = sorted({s["generation"] for s in snaps
                               if s["state"] in (REPLICA_ACTIVE,
                                                 REPLICA_DRAINING)})
        return {"ok": live > 0, "replicas": snaps,
                "live": live, "generation": self.generation,
                "generations": serving_gens,
                "mixed_generations": len(serving_gens) > 1,
                "serve_dtype": self.serve_dtype,
                "queue_depth": len(self._queue)}

    # -- blue/green rollout ----------------------------------------------
    def rollout(self, state_dict, *, run_config: Optional[dict] = None,
                allow_config_change: bool = False) -> dict:
        """Ship a new checkpoint into the serving fleet with zero dropped
        requests.  Synchronous — call it from a background thread (the
        HTTP /rollout handler does); traffic keeps flowing on every
        replica not currently mid-flip.  Returns the rollout report."""
        with self._rollout_lock:
            t0 = time.perf_counter()
            gen = self.generation + 1
            spans = getattr(self.telemetry, "spans", None)
            trace_id = (spans.new_trace_id(f"rollout-g{gen}")
                        if spans is not None else None)
            # 1. free guards first — a refused rollout does no device
            #    work: the staging grid must exist, and a checkpoint
            #    trained as a different model VARIANT must be refused
            if self._warmup_spec is None:
                raise RuntimeError("rollout before warmup(): the fleet "
                                   "has no (bucket, dtype) grid to stage")
            drifted: List[str] = []
            if run_config is not None and self.run_config is not None:
                from can_tpu_torch.utils.checkpoint import check_serve_config

                drifted = check_serve_config(self.run_config, run_config,
                                             allow=allow_config_change)

            # 2. quantize once, on the host (same path as __init__)
            qparams = host_tree(quantize_tree(state_dict, self.serve_dtype))

            # 3. structural guard BEFORE staging: a tree with another
            #    signature would run new signatures mid-traffic on flip.
            #    The reference is the HOST-side current tree, not a
            #    replica's engine (which may be released)
            if tree_signature(qparams) != tree_signature(self._host_q):
                raise ValueError(
                    "rollout refused: the new checkpoint's param tree "
                    "differs in structure/shape/dtype from the serving "
                    "tree (did the model variant change?) — deploy it as "
                    "a fresh fleet instead of a hot flip")

            # 4. staging warmup in the background of live traffic: every
            #    (bucket, size, dtype) batch runs the NEW weights on the
            #    staging device before any live replica flips — catches
            #    NaN checkpoints and numeric blowups off-path
            shapes, max_batch, dtypes, sizes = self._warmup_spec
            stage_dev = self.devices[-1]
            t_stage0 = time.perf_counter()
            with _device_guard(stage_dev):
                staging = self._engine(stage_dev,
                                       f"{self.name}_staging_g{gen}",
                                       qparams)
                try:
                    stage_report = staging.warmup(shapes, max_batch,
                                                  dtypes=dtypes, sizes=sizes)
                finally:
                    staging.release_buffers()
            if spans is not None:
                spans.emit(trace_id=trace_id, name="rollout.staging",
                           start=t_stage0, end=time.perf_counter(),
                           compiles=stage_report["compiles"])

            # 5. flip one replica at a time under its dispatch lock: the
            #    other replicas keep pulling from the shared queue, so no
            #    request is rejected or dropped while any replica flips
            flipped = []
            for r in self.replicas:
                if r.state != REPLICA_ACTIVE:
                    continue  # quarantined replicas stay on the old gen
                t_f0 = time.perf_counter()
                with r.lock, _device_guard(r.device):
                    r.engine.swap_params(qparams, quantized=True)
                    r.generation = gen
                flipped.append(r.index)
                self._emit("fleet.replica", **r.snapshot())
                if spans is not None:
                    spans.emit(trace_id=trace_id,
                               name=f"rollout.flip_r{r.index}",
                               start=t_f0, end=time.perf_counter())

            self.generation = gen
            # the host-side staging copy follows the fleet: a replica
            # resurrected or added AFTER this rollout serves generation
            # ``gen``'s weights, never the boot checkpoint's
            with self._cond:
                self._host_q = qparams
            if run_config is not None:
                self.run_config = run_config
            report = {"generation": gen, "flipped": flipped,
                      "skipped": [r.index for r in self.replicas
                                  if r.index not in flipped],
                      "staging_compiles": stage_report["compiles"],
                      "staging_seconds": stage_report["seconds"],
                      "config_drift": drifted,
                      "seconds": round(time.perf_counter() - t0, 3)}
            self._emit("fleet.rollout", **report)
            if spans is not None:
                spans.emit(trace_id=trace_id, name="rollout",
                           start=t0, end=time.perf_counter(),
                           generation=gen)
            return report
