"""Elastic shrink-and-continue: the preemption-tolerant training supervisor
(counterpart of ``can_tpu/parallel/elastic.py``: the same manifest schema,
file names, leave exit code and ``elastic.transition`` payload, so either
package reads the other's manifest).

The reference dies whole-job when any rank dies (synchronous NCCL DDP,
reference train.py:121-122).  This module joins what the port already has
— the signal files, exact resume, the drift guard, the deterministic
planner at any dp, the incident layer's SIGTERM bundle — into one
choreography:

1. **Signal** — SIGTERM on some rank (the supervisor's handler, chained
   after the incident manager's bundle, sets the leaving flag and writes a
   ``leave`` file), a ``dead`` file from ``tools/run_monitor.py
   --emit-signal``, or an injected fault (``testing/faults.py``, a real
   SIGTERM at a seeded step).
2. **Agreement** — the per-step hook polls on each epoch's first step and
   every ``check_every`` steps: one bounded allgather of the leave/dead
   masks over the gloo side group (set union), so every rank derives the
   same leaver set at the same step and raises ``ElasticInterrupt`` out
   of ``train_one_epoch``.
3. **Shrink checkpoint at a barrier** — every member of the dying world,
   leavers included, saves through ``CheckpointManager`` (rank 0 writes,
   even when it is the leaver) into ``<checkpoint_dir>/elastic/<gen>``;
   rank 0 then writes ``elastic.json`` (manifest last: a torn shrink reads
   as absent), and all meet a bounded barrier.
4. **Re-formation** — leavers shut the runtime down and exit
   ``LEAVE_EXIT_CODE``; survivors wait for the card, destroy the old
   groups and form a new generation at the shrunk world with
   ``env_rendezvous=False`` on their own device: alone without a process
   group, or at the coordinator the lowest survivor's ``stay`` file
   advertises (a free port it picked while the old world was whole).
5. **Resume** — the caller rebuilds the mesh, DDP, SyncBN group, optimizer,
   lr schedule (``world_size=dp'``) and batcher, restores the shrink
   checkpoint, replans the interrupted epoch's remaining items
   (``ShardedBatcher.epoch(e, include=remaining)``) and emits one
   ``elastic.transition`` event.  A cold restart reads the same manifest
   and runs the same resume, so the two end bitwise equal.

Under spatial parallelism (``sp > 1``) a replica is ``sp`` processes
(``parallel/mesh.py``: ``rank = d * sp + s``), as a JAX host holds its sp
group.  When any rank of replica ``d`` leaves, all ``sp`` ranks of ``d``
leave with it (``replica_leavers``, applied to the agreed set before
``plan_reformation``), and the survivors re-form at ``(dp - replicas
lost, sp)``: ``sp`` never changes, and a leaver set that takes every
replica ends the job.

Launch elastic jobs one process per rank with the rendezvous variables
set per process (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``,
``COORDINATOR_ADDRESS``, or ``srun``), never under ``torchrun``: its
agent stops the whole worker group when one worker exits non-zero, and a
leaver exits 143.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import socket
import time
from typing import Callable, Iterable, List, Optional, Sequence, Set

import numpy as np

from can_tpu_torch.obs.signals import (  # noqa: F401  (re-exports)
    SIGNAL_SCHEMA,
    leaver_hosts,
    read_signals,
    signal_path,
    write_signal,
)
from can_tpu_torch.parallel import runtime
from can_tpu_torch.testing.faults import active_injector

MANIFEST_SCHEMA = "can_tpu.elastic.v1"
MANIFEST_NAME = "elastic.json"
ELASTIC_SUBDIR = "elastic"
#: the leaver's exit code after a clean coordinated leave (128 + SIGTERM,
#: what a preemptor's supervisor expects from a graceful shutdown)
LEAVE_EXIT_CODE = 143


# -- elastic manifest -----------------------------------------------------
def manifest_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, MANIFEST_NAME)


def save_manifest(checkpoint_dir: str, manifest: dict) -> str:
    path = manifest_path(checkpoint_dir)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_manifest(checkpoint_dir: str) -> Optional[dict]:
    """The checkpoint dir's elastic manifest, or None when absent, torn or
    of another schema (a shrink killed before its last write is not a
    transition)."""
    try:
        with open(manifest_path(checkpoint_dir)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != MANIFEST_SCHEMA:
        return None
    return doc


def manifest_is_live(manifest: Optional[dict],
                     latest_epoch: Optional[int]) -> bool:
    """Should a resume honour this manifest?  Only while no completed-epoch
    checkpoint at or beyond the interrupted epoch exists: once the resumed
    leg finishes that epoch and saves, the manifest is history."""
    if manifest is None:
        return False
    return latest_epoch is None or latest_epoch < int(manifest["epoch"])


def consumed_items(schedule: Sequence, steps_done: int) -> List[int]:
    """Item indices the first ``steps_done`` launches of a global schedule
    covered (valid slots only: a fill slot consumed nothing)."""
    out: Set[int] = set()
    for _, group in schedule[:steps_done]:
        for idx, valid in group:
            if valid:
                out.add(int(idx))
    return sorted(out)


def remaining_items(manifest: dict, dataset_size: int) -> List[int]:
    """The interrupted epoch's uncovered items, the resumed batcher's
    ``include`` (consumed and remaining partition the epoch)."""
    consumed = set(int(i) for i in manifest.get("consumed", ()))
    bad = consumed - set(range(dataset_size))
    if bad:
        raise ValueError(
            f"elastic manifest names consumed items {sorted(bad)[:5]} "
            f"outside the dataset (size {dataset_size}) — wrong dataset "
            f"for this checkpoint?")
    return [i for i in range(dataset_size) if i not in consumed]


# -- re-formation planning (pure) -----------------------------------------
def replica_leavers(leavers: Iterable[int], *, n_processes: int,
                    sp: int = 1) -> Set[int]:
    """The agreed leaver set widened to whole replicas: every rank ``d * sp
    + s`` of a replica ``d`` that holds a leaver.  The counterpart of a JAX
    host leaving with its whole sp group; the identity at ``sp == 1``."""
    if sp < 1 or n_processes % sp:
        raise ValueError(f"sp={sp} does not divide the {n_processes}-process "
                         f"world")
    out: Set[int] = set()
    for r in leavers:
        d = int(r) // sp
        out.update(range(d * sp, (d + 1) * sp))
    return out


def plan_reformation(*, n_processes: int, leavers: Iterable[int],
                     process_index: int) -> dict:
    """Who stays, and at what new rank: the old ranks minus the leavers,
    renumbered in old-rank order (every rank derives this from the agreed
    leaver set)."""
    leavers = {int(x) for x in leavers}
    bad = leavers - set(range(n_processes))
    if bad:
        raise ValueError(f"leaver ids {sorted(bad)} outside the "
                         f"{n_processes}-process world")
    if not leavers:
        raise ValueError("no leavers: nothing to re-form")
    survivors = [r for r in range(n_processes) if r not in leavers]
    return {
        "survivors": survivors,
        "leaving": process_index in leavers,
        "new_num_processes": len(survivors),
        "new_process_id": (survivors.index(process_index)
                           if process_index in survivors else None),
    }


def reform_coordinator(signal_dir: str, survivors: Sequence[int],
                       *, generation: int) -> Optional[str]:
    """The shrunk world's coordinator address, which the lowest survivor's
    ``stay`` file advertises (written during the shrink, while the old
    world was whole); None for a world of one."""
    if len(survivors) <= 1:
        return None
    for s in read_signals(signal_dir):
        if (s.get("kind") == "stay"
                and int(s.get("host_id", -1)) == int(survivors[0])):
            addr = s.get("detail", {}).get("address")
            if addr:
                return str(addr)
    raise RuntimeError(
        f"no stay-file advertises a coordinator for survivors "
        f"{list(survivors)} in {signal_dir} (generation {generation}) — "
        f"the shrink barrier passed without the lowest survivor's "
        f"advertisement?")


def reform_address() -> str:
    """``host:port`` for this rank's re-rendezvous: the host's name and a
    port free now.  A fixed port per generation (the JAX package's
    ``REFORM_PORT_BASE + generation``) collides with concurrent jobs on
    one host."""
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    return f"{socket.gethostname()}:{port}"


def _bounded_agree(mask, *, generation: int,
                   timeout_s: Optional[float] = None):
    """``runtime.agree_max_value`` with a bounded wait: the allgather needs
    every member, and a peer dead without a grace window would hang the
    rest.  On expiry raises ``RendezvousTimeoutError``.  A world of one
    returns at once."""
    if runtime.process_count() <= 1:
        return mask
    if timeout_s is None:
        timeout_s = runtime.DEFAULT_BARRIER_TIMEOUT_S
    if timeout_s <= 0:
        return runtime.agree_max_value(mask)
    return runtime.bounded_wait(
        lambda: runtime.agree_max_value(mask),
        name="elastic-agreement", timeout_s=timeout_s,
        generation=generation,
        detail="a fleet member never joined the leave-agreement "
               "allgather (hard death without a grace window?) — "
               "restart the survivors and resume from the last "
               "checkpoint")


# -- control flow ---------------------------------------------------------
class ElasticInterrupt(Exception):
    """The agreed shrink point, raised by the step hook out of
    ``train_one_epoch``, which attaches the live post-step state
    (``.state``) and its step count (``.steps_done``).  Control flow, not
    an incident."""

    def __init__(self, *, steps_done: int, leavers: Set[int],
                 reason: str = "preemption"):
        self.steps_done = int(steps_done)
        self.leavers = set(leavers)
        self.reason = str(reason)
        self.state = None  # attached by train_one_epoch on the way out
        super().__init__(
            f"elastic shrink agreed at step {steps_done}: "
            f"host(s) {sorted(self.leavers)} leaving ({reason})")


class ElasticSupervisor:
    """One process's side of the shrink-and-continue choreography.

    signal_dir: shared directory of leave/dead/stay files (any local dir
      on one host); ``run_monitor --emit-signal`` writes the same files.
    telemetry: optional bus for the transition event and, when incidents
      are armed, a bundle on a failed shrink.
    check_every: steps between agreement polls (each a tiny allgather at
      world > 1); every epoch's first step polls too.
    barrier_timeout_s: bound for the agreement and the shrink barrier
      (default ``runtime.DEFAULT_BARRIER_TIMEOUT_S``).

    ``timeline`` records the wall-clock time (``clock``) of each stage of
    the last transition this process took part in: ``sigterm`` (a leaver's
    notice), ``agreed``, ``shrink_saved``, ``shrink_barrier``, ``reformed``.
    """

    def __init__(self, signal_dir: str, *, telemetry=None,
                 check_every: int = 4,
                 barrier_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        if not signal_dir:
            raise ValueError("signal_dir is required")
        os.makedirs(signal_dir, exist_ok=True)
        self.signal_dir = signal_dir
        self.telemetry = telemetry
        self.check_every = max(1, int(check_every))
        self.barrier_timeout_s = barrier_timeout_s
        self._clock = clock
        self._leaving = False
        self._leave_reason: Optional[str] = None
        self._restore_signal = None
        self.transitions = 0
        self.timeline: dict = {}
        # signal files name ORIGINAL host ids (stable across generations);
        # ranks are renumbered at each re-formation.  rank_to_host maps the
        # current rank to its original id (None: identity); _handled holds
        # the ids already shrunk around, so a stale leave file — or a
        # monitor re-emitting 'dead' for a host that is gone — never
        # triggers a second shrink that names an innocent renumbered rank
        self.rank_to_host: Optional[List[int]] = None
        self._handled: Set[int] = set()

    def _rank_map(self, n: int) -> List[int]:
        return (self.rank_to_host if self.rank_to_host is not None
                else list(range(n)))

    def adopt_manifest(self, manifest: dict) -> None:
        """Inherit a transition's bookkeeping: the survivors' original host
        ids become this generation's rank map, and the leavers' ids are
        handled.  ``reform`` calls it in-process; a cold restart from the
        same manifest calls it too."""
        hosts = manifest.get("survivor_hosts")
        if hosts:
            self.rank_to_host = [int(h) for h in hosts]
        self._handled.update(int(h) for h in
                             manifest.get("leaver_hosts",
                                          manifest.get("leavers", ())))

    # -- signal sources ---------------------------------------------------
    def notice_preemption(self, reason: str = "sigterm") -> None:
        """This rank is being preempted: set the leaving flag (read at the
        next poll) and announce it in the signal dir."""
        self._leaving = True
        self._leave_reason = reason
        self.timeline["sigterm"] = self._clock()
        try:
            n = runtime.process_count()
            write_signal(self.signal_dir, kind="leave",
                         host_id=self._rank_map(n)[runtime.process_index()],
                         reason=reason)
        except OSError as e:
            # the allgathered flag still drives the agreement; the file is
            # the monitor-facing record
            print(f"[elastic] leave-signal write failed: {e}", flush=True)

    def install_signal_hook(self, signum: int = _signal.SIGTERM):
        """Chain onto SIGTERM: set the leaving flag and return, so the
        grace window goes to the shrink instead of dying mid-collective.
        Install before the incident manager's hook, which then dumps its
        bundle first and chains here.  Main thread only; returns a
        ``restore()`` callable, or None."""
        def _handler(sig, frame):
            self.notice_preemption("sigterm")

        try:
            previous = _signal.signal(signum, _handler)
        except ValueError:  # not the main thread
            return None

        def restore():
            try:
                _signal.signal(signum, previous
                               if previous is not None else _signal.SIG_DFL)
            # can-tpu-lint: disable=SWALLOW(teardown restore is best-effort; process is exiting)
            except (ValueError, TypeError):
                pass

        self._restore_signal = restore
        return restore

    def close(self) -> None:
        if self._restore_signal is not None:
            self._restore_signal()
            self._restore_signal = None

    # -- the loop hook ----------------------------------------------------
    def step_hook(self, epoch: int) -> Callable[[int], None]:
        """``train_one_epoch(on_step=...)``'s callable: fault delivery, the
        local signal poll and, on step 1 and every ``check_every`` steps,
        the lockstep agreement.  Raises ``ElasticInterrupt`` at the agreed
        shrink step."""
        def on_step(step: int) -> None:
            n = runtime.process_count()
            rank = runtime.process_index()
            rank_map = self._rank_map(n)
            inj = active_injector()
            if inj is not None:
                # a kill names the launch rank, the original host id: after
                # a shrink a survivor takes a departed rank's number
                inj.on_step(step, epoch=epoch, rank=rank_map[rank])
            # the first step polls as well: an epoch shorter than
            # check_every would otherwise never poll
            if step != 1 and step % self.check_every:
                return
            mask = np.zeros((n,), np.float32)
            if self._leaving:
                mask[rank] = 1.0
            ids = leaver_hosts(read_signals(self.signal_dir)) - self._handled
            for r in range(n):
                if rank_map[r] in ids:
                    mask[r] = 1.0
            agreed = _bounded_agree(mask, generation=runtime.generation(),
                                    timeout_s=self.barrier_timeout_s)
            leavers = {i for i in range(n) if agreed[i] > 0}
            if leavers:
                self.timeline["agreed"] = self._clock()
                raise ElasticInterrupt(
                    steps_done=step, leavers=leavers,
                    reason=self._leave_reason or "peer_signal")

        return on_step

    # -- the shrink choreography ------------------------------------------
    def shrink(self, interrupt: ElasticInterrupt, *, state, epoch: int,
               checkpoint_dir: str, schedule: Sequence, dp: int,
               sp: int = 1, batch_size: int = 1,
               prior_consumed: Sequence = ()) -> dict:
        """Step 3, run by every member of the dying world: the shrink
        checkpoint, the manifest and the bounded barrier.  Returns the
        manifest as rank 0 wrote it (what a cold restart reads); the
        caller then leaves (``leave``) or re-forms (``reform``).

        schedule: the interrupted epoch's global schedule (its first
        ``steps_done`` launches are the consumed items).
        dp/sp/batch_size: the dying world's mesh and per-replica batch;
        under ``sp > 1`` the agreed leavers widen to their whole replicas
        (``replica_leavers``), whose every rank then leaves.
        prior_consumed: items an earlier transition of the same epoch
        already covered (a second shrink while training the remainder)."""
        from can_tpu_torch.utils.checkpoint import CheckpointManager

        gen = runtime.generation()
        n = runtime.process_count()
        rank = runtime.process_index()
        rank_map = self._rank_map(n)
        sp = max(int(sp), 1)
        leavers = replica_leavers(interrupt.leavers, n_processes=n, sp=sp)
        plan = plan_reformation(n_processes=n, leavers=leavers,
                                process_index=rank)
        new_procs = plan["new_num_processes"]
        # one GPU per process and sp processes a replica: the shrunk world's
        # devices are its processes (JAX's host holds sp devices, and its
        # count of at least one host is this count of at least sp)
        new_devices = max(new_procs, sp)
        new_dp = max(new_devices // sp, 1)
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "ts": self._clock(),
            "generation": gen,
            "transition_id": gen,
            "epoch": int(epoch),
            "steps_done": int(interrupt.steps_done),
            "consumed": sorted(
                set(int(i) for i in prior_consumed)
                | set(consumed_items(schedule, interrupt.steps_done))),
            "reason": interrupt.reason,
            "leavers": sorted(leavers),
            "survivors": plan["survivors"],
            "leaver_hosts": sorted(rank_map[r] for r in leavers),
            "survivor_hosts": [rank_map[s] for s in plan["survivors"]],
            "world_old": {"processes": n, "dp": int(dp), "sp": int(sp),
                          "devices": int(dp) * int(sp),
                          "batch_size": int(batch_size)},
            "world_new": {"processes": new_procs, "dp": int(new_dp),
                          "sp": int(sp), "devices": new_devices},
            "lr_scale": new_dp / max(int(dp), 1),
        }
        if not plan["leaving"] and new_procs > 1:
            # advertise this survivor's re-rendezvous address while the old
            # world can still read it (the lowest survivor's is used)
            write_signal(self.signal_dir, kind="stay", host_id=rank,
                         reason="reform",
                         detail={"address": reform_address()})
        try:
            # a shrink save is a continuation point, not a best candidate:
            # 0.0 keeps the metrics JSON finite
            CheckpointManager(os.path.join(checkpoint_dir, ELASTIC_SUBDIR)
                              ).save(gen, state, mae=0.0)
            self.timeline["shrink_saved"] = self._clock()
            if runtime.is_main_process():
                save_manifest(checkpoint_dir, manifest)  # manifest last
            runtime.barrier(f"elastic-shrink-g{gen}",
                            timeout_s=self.barrier_timeout_s)
            self.timeline["shrink_barrier"] = self._clock()
        except Exception as e:
            # a failed shrink is an incident: a rank is about to go and no
            # continuation point exists
            self._notify_incident(e, epoch=epoch, step=interrupt.steps_done)
            raise
        # every rank goes on with the manifest as written (rank 0's reason
        # and time), the one a cold restart reads
        written = load_manifest(checkpoint_dir)
        if written is None or written["transition_id"] != gen:
            raise RuntimeError(f"the shrink barrier of generation {gen} passed "
                               f"without its manifest in {checkpoint_dir}")
        manifest = written
        # the agreed leavers are handled; rank 0 also sweeps their files
        # (best effort: _handled is the guarantee)
        self._handled.update(manifest["leaver_hosts"])
        if runtime.is_main_process():
            for h in manifest["leaver_hosts"]:
                for kind in ("leave", "dead"):
                    try:
                        os.remove(signal_path(self.signal_dir, kind, h))
                    # can-tpu-lint: disable=SWALLOW(best-effort sweep of consumed signal files; _handled is the real guard)
                    except OSError:
                        pass
        return manifest

    def leave(self) -> int:
        """The leaver's last act: shut the runtime down, restore the signal
        hook, and hand back the preemption exit code."""
        runtime.shutdown_runtime(reset=True)
        self.close()
        return LEAVE_EXIT_CODE

    def reform(self, manifest: dict) -> dict:
        """The survivor's re-formation: wait for the card, destroy the old
        groups, then a new generation at the shrunk world on this
        process's own device and backend, reading no launcher variables.
        Returns the new topology.  The caller drops every object of the
        old generation first and restores from the shrink checkpoint."""
        survivors = manifest["survivors"]
        old = runtime.topology() or {}
        rank = runtime.process_index()
        gen = runtime.generation()
        device = old.get("device", "cpu")
        backend = old.get("backend")
        runtime.shutdown_runtime(reset=True)
        if len(survivors) > 1:
            coord = reform_coordinator(self.signal_dir, survivors,
                                       generation=gen)
            topo = runtime.init_runtime(
                coordinator_address=coord, num_processes=len(survivors),
                process_id=survivors.index(rank), device=device,
                backend=backend, env_rendezvous=False)
        else:
            topo = runtime.init_runtime(device=device, env_rendezvous=False)
        self.timeline["reformed"] = self._clock()
        self.adopt_manifest(manifest)
        self.transitions += 1
        return topo

    def emit_transition(self, manifest: dict, topo: dict, *,
                        new_dp: int, remaining: int,
                        global_batch_new: Optional[int] = None,
                        resumed_from: str = "in_process") -> None:
        """One ``elastic.transition`` event (the module-level
        ``emit_transition``); ``resumed_from`` tells the in-process
        survivor from a cold restart."""
        if resumed_from != "in_process":
            self.transitions += 1  # reform() counted the in-process one
        emit_transition(self.telemetry, manifest, topo, new_dp=new_dp,
                        remaining=remaining,
                        global_batch_new=global_batch_new,
                        resumed_from=resumed_from)

    def _notify_incident(self, exc, **context) -> None:
        inc = (getattr(self.telemetry, "incidents", None)
               if self.telemetry is not None else None)
        if inc is not None:
            inc.on_exception(exc, phase="elastic", **context)


def emit_transition(telemetry, manifest: dict, topo: dict, *,
                    new_dp: int, remaining: int,
                    global_batch_new: Optional[int] = None,
                    resumed_from: str = "in_process") -> None:
    """One ``elastic.transition`` event: the rescaling record (rendered by
    ``obs/report.py``).  Module-level so a cold restart records its
    transition without a supervisor; no-op without telemetry."""
    if telemetry is None:
        return
    old = manifest["world_old"]
    telemetry.emit(
        "elastic.transition",
        transition_id=manifest["transition_id"],
        generation_old=manifest["generation"],
        generation_new=topo.get("generation"),
        epoch=manifest["epoch"],
        steps_done=manifest["steps_done"],
        consumed_items=len(manifest.get("consumed", ())),
        remaining_items=int(remaining),
        leavers=manifest.get("leavers", []),
        reason=manifest.get("reason"),
        processes_old=old["processes"],
        processes_new=topo.get("process_count"),
        dp_old=old["dp"], dp_new=int(new_dp),
        # the per-replica batch is the invariant; the global batch scales
        # with dp
        global_batch_old=old["batch_size"] * old["processes"],
        global_batch_new=global_batch_new,
        lr_scale=int(new_dp) / max(old["dp"], 1),
        resumed_from=resumed_from,
    )
