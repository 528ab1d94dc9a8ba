"""Instrumentation sources: where the events come from.

Counterpart of ``can_tpu/obs/sources.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

Each source measures one failure mode the loop comments used to only
WARN about:

* ``RecompileTracker`` — first calls of a new batch signature.  Every
  new ``(shape, dtype)`` batch signature hitting a step pays its
  first-launch bill on the calling thread (cuDNN's algorithm choice, the
  caching allocator's first blocks at that size, a kernel's first
  build); ``EpochStats.distinct_shapes`` is a bare count with no timing
  or attribution.  With a cost ledger on the bus the first call is also
  the one whose flops and bytes are counted (``obs/costs.py``).
* ``StallClock`` — input-pipeline starvation: seconds the consumer spent
  blocked waiting for the prefetcher's next batch.
* ``device_memory_snapshot`` / ``emit_memory`` — device memory pressure,
  from the CUDA caching allocator of every card this process has
  already put memory on (host RSS always; a CPU run reports no device
  rows and never initialises CUDA).
* ``Heartbeat`` — a liveness timestamp every N seconds from a daemon
  thread, so a hung run leaves a last-known-good timestamp in the artifact
  instead of a file that just stops.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional


class RecompileTracker:
    """Wrap a step callable; attribute each NEW batch signature.

    The first call carrying an unseen ``(name, shape, dtype)`` signature is
    timed end-to-end and emitted as a ``compile`` event: its wall time is
    the signature's first-launch bill (plus one ordinary launch).
    Signatures live in ``telemetry.signature_registry[name]``, not on the
    wrapper, so re-wrapping the step every epoch doesn't re-attribute old
    shapes.

    ``batch_arg``: positional index of the batch dict in the wrapped
    callable's signature (1 for ``train_step(state, batch)`` and
    ``eval_step(params, batch, ...)``).

    ``last_first_call`` is True right after a call that hit a new
    signature — callers timing steps around this wrapper use it to keep
    the first-call bill OUT of their steady-state step distribution (it
    is already fully accounted by the ``compile`` event; recording it
    twice would let one slow first call masquerade as the step p95/max)."""

    def __init__(self, fn: Callable, telemetry, *, name: str = "step",
                 batch_arg: int = 1):
        from can_tpu_torch.train.steps import batch_signature

        self._fn = fn
        self._tel = telemetry
        self._name = name
        self._batch_arg = batch_arg
        self._signature = batch_signature
        self._seen = telemetry.signature_registry.setdefault(name, {})
        self.last_first_call = False

    def __call__(self, *args):
        sig = self._signature(args[self._batch_arg])
        if sig in self._seen:
            self.last_first_call = False
            return self._fn(*args)
        self.last_first_call = True
        # perf-attribution hook: with a cost ledger on the bus
        # (Telemetry.ledger) the first call runs inside the ledger's
        # counting scope (obs/costs.py), and the new signature's
        # flops/bytes ride this same compile event
        ledger = getattr(self._tel, "ledger", None)
        scope = None
        t0 = time.perf_counter()
        if ledger is None:
            out = self._fn(*args)
        else:
            from can_tpu_torch.obs.costs import count_costs

            with count_costs() as scope:
                out = self._fn(*args)
        dt = time.perf_counter() - t0
        self._seen[sig] = dt
        payload = dict(name=self._name, signature=[list(s) for s in sig],
                       seconds=round(dt, 4), n_signatures=len(self._seen))
        if ledger is not None:
            cost = ledger.register(self._name, sig, cost=scope.totals())
            if cost is not None:
                payload.update(cost)
        self._tel.emit("compile", **payload)
        return out


class StallClock:
    """Accumulates time a consumer spent BLOCKED on its input pipeline.

    ``prefetch_to_device(..., stall=clock)`` adds to it only when the next
    batch's future wasn't already done — i.e. genuine starvation, not the
    cost of the (already overlapped) load itself."""

    __slots__ = ("seconds", "count")

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def add(self, dt: float) -> None:
        self.seconds += dt
        self.count += 1


def device_memory_snapshot() -> dict:
    """Best-effort memory accounting: one row per CUDA device this
    process has already put memory on, host RSS always.

    Only devices the caching allocator has used are read, and only once
    CUDA is initialised: reading a card the process never touched would
    create a CUDA context there (~0.5 GB on every visible card, from the
    heartbeat thread and from every fleet replica), and a CPU run must
    never initialise CUDA at all.  Nothing here changes the calling
    thread's current device.  Row keys are the reference's:
    ``bytes_in_use`` / ``peak_bytes_in_use`` are the allocator's
    allocated bytes (current / peak), ``bytes_limit`` the card's total
    memory, and ``largest_alloc_size`` the largest block live at the
    snapshot."""
    devices = []
    try:
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(d)
                if not (stats.get("reserved_bytes.all.peak", 0)
                        or stats.get("allocated_bytes.all.peak", 0)):
                    continue  # never used here: reading it makes a context
                rec = {"id": d, "platform": "cuda",
                       "bytes_in_use": int(stats.get(
                           "allocated_bytes.all.current", 0)),
                       "peak_bytes_in_use": int(stats.get(
                           "allocated_bytes.all.peak", 0)),
                       "bytes_limit": int(
                           torch.cuda.get_device_properties(d).total_memory)}
                largest = _largest_live_block(torch, d)
                if largest is not None:
                    rec["largest_alloc_size"] = largest
                devices.append(rec)
    # can-tpu-lint: disable=SWALLOW(allocator unreadable: host RSS still lands)
    except Exception:
        pass  # allocator unreadable: host RSS still lands
    snap = {"devices": devices, "host_rss_mb": _host_rss_mb()}
    return snap


def _largest_live_block(torch, device: int) -> Optional[int]:
    try:
        sizes = [blk["size"] for seg in torch.cuda.memory_snapshot()
                 if seg.get("device") == device
                 for blk in seg.get("blocks", ())
                 if blk.get("state") == "active_allocated"]
    # can-tpu-lint: disable=SWALLOW(the snapshot's layout is the allocator's; the row lands without this key)
    except Exception:
        return None
    return int(max(sizes)) if sizes else 0


def _host_rss_mb() -> Optional[float]:
    try:
        import resource

        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return round(rss_kb / 1024.0, 1)  # linux reports KiB
    # can-tpu-lint: disable=SWALLOW(resource module is unix-only; None row is the degrade)
    except Exception:  # pragma: no cover — non-unix
        return None


def emit_memory(telemetry, *, step: Optional[int] = None,
                where: str = "") -> None:
    """One ``memory`` event: epoch boundaries and on-demand probes."""
    telemetry.emit("memory", step=step, where=where,
                   **device_memory_snapshot())


class Heartbeat:
    """Daemon thread emitting a ``heartbeat`` event every ``interval_s``.

    One event fires immediately at start (the last-known-good baseline a
    short run still records), then every interval until ``close()``.
    Payload carries the run-local step counter, so a wedged run's artifact
    says how far it got, not just when it died — plus a monotonic ``seq``
    and the process-start ``start_ts``, so a reader of an APPENDED file
    (same run dir, new process) can tell a restarted process (``start_ts``
    changes, ``seq`` resets) from a resumed stream (``tools/run_monitor.py``
    counts the restarts).  ``interval_s <= 0`` disables the thread entirely
    (NOT a floor — a 0 interval flooding ~100 fsync'd events/second into
    the file would be worse than none)."""

    def __init__(self, telemetry, interval_s: float = 60.0,
                 *, start: bool = True):
        self._tel = telemetry
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._t0 = time.time()
        self._seq = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="can-tpu-heartbeat")
        if start and self.interval_s > 0:
            self._thread.start()

    def _run(self) -> None:
        while True:
            self._tel.emit("heartbeat",
                           uptime_s=round(time.time() - self._t0, 3),
                           seq=self._seq, start_ts=round(self._t0, 3))
            self._seq += 1
            if self._stop.wait(self.interval_s):
                return

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():  # pragma: no branch
            self._thread.join(timeout=5.0)
