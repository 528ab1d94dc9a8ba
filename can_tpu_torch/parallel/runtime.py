"""Multi-process runtime: rendezvous, topology queries, host-level
collectives (counterpart of ``can_tpu/parallel/runtime.py``).

The reference's NCCL bootstrap (utils/distributed_utils.py:7-70) maps
onto ``torch.distributed`` directly: one process per GPU, NCCL when the
device is CUDA, gloo on the CPU.

* ``init_runtime`` finds a rendezvous and calls ``init_process_group``,
  or stays a single process without a process group when none is found
  (the reference's "Not using distributed mode" fallback,
  distributed_utils.py:15-18).  Sources, in priority order:

  1. explicit arguments;
  2. the reference's launcher (``torchrun`` / ``torch.distributed.launch
     --use_env``): ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
     ``MASTER_ADDR`` / ``MASTER_PORT``;
  3. the JAX package's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
     ``PROCESS_ID`` (the address is ``host:port`` or a ``tcp://`` or
     ``file://`` URL);
  4. SLURM, by the JAX package's rules (``_slurm_rendezvous``): the
     first host of ``SLURM_JOB_NODELIST`` at a port derived from the job
     id, ``SLURM_NTASKS`` processes, ``SLURM_PROCID`` this one.  Metadata
     of a launched task that lacks what a rendezvous needs is fatal; an
     salloc shell stays a single process;
  5. nothing found: a single process without a process group.

  The JAX package's fifth source, TPU-pod metadata
  (``jax.distributed.initialize()`` with no arguments), has no
  counterpart: a GPU cluster announces itself through one of the above.
* ``process_index`` / ``process_count`` / ``is_main_process`` are the
  rank and world size (0 and 1 without a process group).
* Host-side barriers and host-value agreement run over a gloo side group,
  whatever the main backend: NCCL has no bounded barrier, while gloo's
  ``monitored_barrier`` names the ranks that never arrived
  (``RendezvousTimeoutError.missing``).  ``CAN_TPU_BARRIER_TIMEOUT_S``
  sets the default bound, as in the JAX package.

The runtime is generation-counted like the JAX package's:
``shutdown_runtime`` then ``init_runtime`` forms a new world and bumps
``generation()``.  The elastic re-formation (``parallel/elastic.py``)
passes ``env_rendezvous=False`` and the survivor's own ``device``: after a
shrink the launcher's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_PORT``, ``LOCAL_RANK``) describe the dead world.  Identical
initial weights need no protocol: every process builds the model from the
same seed (and DDP broadcasts rank 0's state at construction in any case).
"""

from __future__ import annotations

import datetime
import os
import re
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from can_tpu_torch.device import resolve_device
from can_tpu_torch.testing.faults import active_injector

_generation = 0      # completed init_runtime() calls (monotonic, never reset)
_active = False      # a runtime generation is live
_state: dict = {}    # the live generation: group, host group, device, topology

#: default bound on barrier() waits, overridable per call or by the
#: environment.  Finite by default: an unbounded wait at a barrier outlives
#: a preemptor's grace window.
DEFAULT_BARRIER_TIMEOUT_S = float(
    os.environ.get("CAN_TPU_BARRIER_TIMEOUT_S", "300"))

#: bound on one collective of the process group (``init_process_group``'s
#: timeout): long enough for a first-step kernel build on every rank
DEFAULT_COLLECTIVE_TIMEOUT_S = 1800.0


class RendezvousTimeoutError(RuntimeError):
    """A barrier did not complete within its bound.

    Carries the runtime ``generation``, the barrier name (``barrier``), the
    ``timeout_s`` that expired and ``missing``: the ranks that had not
    arrived, when the transport reports them (None = unknown)."""

    def __init__(self, name: str, *, generation: int, timeout_s: float,
                 missing: Optional[Sequence] = None, detail: str = ""):
        self.barrier = name
        self.generation = generation
        self.timeout_s = timeout_s
        self.missing = list(missing) if missing is not None else None
        miss = ("unknown (no partial-arrival info)" if self.missing is None
                else ", ".join(str(m) for m in self.missing))
        super().__init__(
            f"barrier {name!r} (runtime generation {generation}) timed out "
            f"after {timeout_s:g}s; missing hosts: {miss}"
            + (f" — {detail}" if detail else ""))


# base rendezvous port for SLURM-derived coordinators: every task must
# compute the same address without communicating, so the port is a pure
# function of job metadata, offset by SLURM_JOB_ID % 1000 so two jobs whose
# first node coincides do not rendezvous into each other (the JAX
# package's rule and constant)
SLURM_COORDINATOR_PORT = 8476


def _slurm_port(env) -> int:
    try:
        return SLURM_COORDINATOR_PORT + int(env.get("SLURM_JOB_ID", "")) % 1000
    except ValueError:
        return SLURM_COORDINATOR_PORT


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM_JOB_NODELIST, expanding the compressed
    bracket form: "tpu[003-004,007],gpu2" -> "tpu003" (zero padding kept,
    as sinfo/scontrol print it)."""
    s = nodelist.strip()
    if not s:
        raise RuntimeError("empty SLURM_JOB_NODELIST")
    # cut at the first comma OUTSIDE brackets (commas inside [] separate
    # ranges of the same prefix)
    depth = 0
    first = s
    for i, ch in enumerate(s):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            first = s[:i]
            break
    if "[" not in first:
        return first
    prefix, _, rest = first.partition("[")
    body = rest.rstrip("]")
    head = body.split(",")[0].split("-")[0]
    return prefix + head


def _slurm_rendezvous(env=None):
    """(coordinator_address, num_processes, process_id) derived from SLURM
    metadata, None when this is not a multi-task SLURM job.

    Metadata that identifies a launched task of a multi-task job
    (``SLURM_PROCID`` is set — only ``srun`` sets it, once per task) but
    lacks what rendezvous needs is fatal: a silent single-process fallback
    would train this task alone on a diverged lockstep schedule while its
    siblings wait at the coordinator.  An salloc shell is not a launched
    task: salloc exports ``SLURM_NTASKS``/``SLURM_JOB_NODELIST`` but never
    ``SLURM_PROCID``, so NTASKS-without-PROCID stays single-process (with
    a notice).
    """
    env = os.environ if env is None else env
    ntasks_s = env.get("SLURM_NTASKS", "")
    nodelist = env.get("SLURM_JOB_NODELIST", "")
    procid_s = env.get("SLURM_PROCID", "")
    if not ntasks_s:
        if procid_s:
            # a launched task (srun sets both) missing its task count:
            # incomplete metadata, not "no SLURM"
            raise RuntimeError(
                "SLURM_PROCID is set but SLURM_NTASKS is not — SLURM "
                "metadata present but incomplete; refusing to guess "
                "single-process (split-brain risk)")
        return None  # salloc shell / stray vars: not a launched task
    try:
        ntasks = int(ntasks_s)
    except ValueError:
        raise RuntimeError(
            f"unparseable SLURM_NTASKS={ntasks_s!r}; refusing to degrade "
            "to single-process")
    if ntasks <= 1:
        return None  # single-task job: nothing to rendezvous
    if not procid_s:
        # NTASKS > 1 but no task id: an salloc shell inside a multi-task
        # allocation, not an srun-launched task (srun always sets
        # PROCID) — single-process is correct, but say so, since the
        # surrounding allocation LOOKS distributed
        print(f"[runtime] SLURM_NTASKS={ntasks} but SLURM_PROCID is "
              "unset (salloc shell, not an srun task): running "
              "single-process; use srun to launch the distributed job",
              flush=True)
        return None
    if not nodelist:
        raise RuntimeError(
            f"SLURM task {procid_s} of {ntasks} has no "
            "SLURM_JOB_NODELIST — SLURM metadata present but incomplete; "
            "refusing to degrade to single-process (split-brain)")
    try:
        procid = int(procid_s)
    except ValueError:
        raise RuntimeError(
            f"unparseable SLURM_PROCID={procid_s!r} in a "
            f"{ntasks}-task SLURM job")
    host = _first_slurm_host(nodelist)
    return f"{host}:{_slurm_port(env)}", ntasks, procid


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL passes through."""
    return address if "://" in address else f"tcp://{address}"


def resolve_rendezvous(env=None, *, coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> Optional[dict]:
    """The rendezvous this process would join, from the arguments and then
    ``env`` (default ``os.environ``) in the module docstring's order:
    ``{"init_method", "world_size", "rank", "local_rank", "source"}``, or
    None for a single process without a process group.  Pure: reads
    ``env`` only (SLURM's salloc notice aside)."""
    env = os.environ if env is None else env
    local_rank = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0")))
    if coordinator_address:
        source = "arguments"
    elif "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = (int(env["WORLD_SIZE"]) if num_processes is None
                         else num_processes)
        process_id = int(env["RANK"]) if process_id is None else process_id
        source = "torchrun"
    else:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
        source = "COORDINATOR_ADDRESS"
        if num_processes is None and "NUM_PROCESSES" in env:
            num_processes = int(env["NUM_PROCESSES"])
        if process_id is None and "PROCESS_ID" in env:
            process_id = int(env["PROCESS_ID"])
        elif process_id is None and "SLURM_PROCID" in env:
            process_id = int(env["SLURM_PROCID"])
        if coordinator_address is None:
            slurm = _slurm_rendezvous(env)
            if slurm is None:
                return None
            coordinator_address, slurm_n, slurm_id = slurm
            num_processes = slurm_n if num_processes is None else num_processes
            process_id = slurm_id if process_id is None else process_id
            source = "SLURM"
    if num_processes is None or process_id is None:
        raise RuntimeError(
            f"rendezvous at {coordinator_address} ({source}) names no "
            f"process count or process id (num_processes={num_processes}, "
            f"process_id={process_id}); refusing to guess single-process")
    return {"init_method": _init_method(coordinator_address),
            "world_size": int(num_processes), "rank": int(process_id),
            "local_rank": local_rank, "source": source}


def generation() -> int:
    """Completed ``init_runtime`` calls — the runtime generation."""
    return _generation


def runtime_active() -> bool:
    return _active


def init_runtime(*, platform: str = "default",
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 backend: Optional[str] = None,
                 env_rendezvous: bool = True) -> dict:
    """Resolve this process's device and, where a rendezvous is found,
    join the process group.  Returns the topology: ``{"process_index",
    "process_count", "local_rank", "device", "backend" (None without a
    process group), "source", "generation"}``.

    ``platform`` picks the device as the CLIs' ``--platform`` does
    (``device.resolve_device``: ``cuda:LOCAL_RANK`` on the card, raising
    without one; the CPU only for ``"cpu"``), and ``torch.cuda.set_device``
    binds it before the group exists.  ``device`` overrides that choice
    and ``backend`` the backend (``nccl`` for a CUDA device, ``gloo`` on
    the CPU): two ranks on one card need both (``gloo``, ``cuda:0``), since
    NCCL refuses two ranks on one GPU.  A call while a generation is
    live returns its topology unchanged.

    ``env_rendezvous=False`` reads no environment: only the explicit
    arguments form a world, and without a coordinator the process stays
    alone.  The elastic re-formation must pass it, and a ``device`` with
    it (the survivor keeps its GPU: old rank 2 becomes rank 1, still on
    ``cuda:2``); without one only ``platform="cpu"`` is accepted, since a
    device derived from the stale ``LOCAL_RANK`` may be a departed rank's.
    """
    global _generation, _active, _state
    if _active:
        return dict(_state["topology"])
    env = os.environ if env_rendezvous else {}
    if not env_rendezvous and device is None and platform != "cpu":
        raise ValueError("init_runtime(env_rendezvous=False) needs device=: "
                         "LOCAL_RANK describes the launcher's world")
    rdv = resolve_rendezvous(env, coordinator_address=coordinator_address,
                             num_processes=num_processes, process_id=process_id)
    local_rank = (rdv["local_rank"] if rdv is not None
                  else int(env.get("LOCAL_RANK", "0")))
    if device is None:
        device = resolve_device(platform, local_rank=local_rank)
    device = torch.device(device)
    if not env_rendezvous and device.type == "cuda":
        local_rank = device.index if device.index is not None else 0
    if device.type == "cuda":
        torch.cuda.set_device(device)
    state = {"group": None, "host_group": None, "device": device}
    if rdv is not None:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=rdv["init_method"],
            world_size=rdv["world_size"], rank=rdv["rank"],
            timeout=datetime.timedelta(seconds=DEFAULT_COLLECTIVE_TIMEOUT_S),
            **kw)
        state["group"] = dist.group.WORLD
        # host-side barriers and agreement: gloo whatever the main backend
        state["host_group"] = (dist.new_group(backend="gloo")
                               if backend != "gloo" else dist.group.WORLD)
    _generation += 1
    _active = True
    state["topology"] = {
        "process_index": process_index(), "process_count": process_count(),
        "local_rank": local_rank, "device": str(device),
        "backend": backend if rdv is not None else None,
        "source": rdv["source"] if rdv is not None else "single process",
        "generation": _generation}
    _state = state
    return dict(state["topology"])


def shutdown_runtime(*, reset: bool = False) -> None:
    """Tear the live generation down: destroy its process group (the
    reference defines ``cleanup()`` but never calls it; the CLIs call this
    from ``finally``).  A later ``init_runtime`` forms a new generation,
    possibly at another world size.

    ``reset=True`` is the counterpart of the JAX package's backend reset,
    the bridge between elastic generations: it waits until the card is
    idle (``torch.cuda.synchronize``), then destroys the gloo side group
    and the world group, in that order.  Callers drop every object that
    holds the old group (the DDP module, the mesh's groups) before the
    next ``init_runtime``."""
    global _active, _state
    group, host = _state.get("group"), _state.get("host_group")
    if _active and group is not None:
        device = _state.get("device")
        if reset and device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        if reset and host is not None and host is not group:
            dist.destroy_process_group(host)
        dist.destroy_process_group()
    _active = False
    _state = {}


def topology() -> Optional[dict]:
    """The live generation's topology (``init_runtime``'s dict), or None."""
    return dict(_state["topology"]) if _active else None


def process_group():
    """The live process group (the BN-moments ``axes`` and DDP's group), or
    None for a single process without one."""
    return _state.get("group")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def _host_group():
    group = _state.get("host_group")
    if group is None:
        raise RuntimeError("no process group: call init_runtime() with a "
                           "rendezvous first")
    return group


_MISSING_RE = re.compile(r"Ranks? ([\d, ]+) failed to pass monitoredBarrier")


def _parse_missing_ranks(message: str) -> Optional[list]:
    """Ranks gloo's ``monitored_barrier`` names as not arrived ("Ranks 1, 3
    failed to pass monitoredBarrier ..."); None when the message names
    none (a rank other than 0 only learns that rank 0 gave up)."""
    m = _MISSING_RE.search(message)
    if not m:
        return None
    return sorted({int(r) for r in m.group(1).replace(",", " ").split()})


def barrier(name: str = "barrier", timeout_s: Optional[float] = None) -> None:
    """Block until every process arrives (the reference's
    ``dist.barrier``), bounded: after ``timeout_s`` (default
    ``DEFAULT_BARRIER_TIMEOUT_S``) raise ``RendezvousTimeoutError`` naming
    the generation and, on rank 0, the ranks that never arrived.  Runs on
    the gloo side group.  ``timeout_s <= 0`` waits without a bound."""
    if process_count() <= 1:
        return
    if timeout_s is None:
        timeout_s = DEFAULT_BARRIER_TIMEOUT_S
    inj = active_injector()
    if inj is not None:
        # a scheduled rendezvous_timeout fault holds THIS rank here, so
        # every other member's bounded wait times out for real
        inj.on_barrier(name, rank=process_index())
    group = _host_group()
    if timeout_s <= 0:
        dist.barrier(group=group)
        return
    gen = _generation
    try:
        dist.monitored_barrier(group=group,
                               timeout=datetime.timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        msg = str(e)
        raise RendezvousTimeoutError(
            name, generation=gen, timeout_s=timeout_s,
            missing=_parse_missing_ranks(msg),
            detail=msg.splitlines()[0] if msg else "") from e


def bounded_wait(fn, *, name: str, timeout_s: float,
                 generation: Optional[int] = None, detail: str = ""):
    """Run a blocking collective ``fn`` on a daemon thread and bound the
    wait: on expiry raise ``RendezvousTimeoutError`` instead of hanging
    (the stuck thread is abandoned — callers are on a teardown path).
    Returns ``fn()``'s result."""
    done = threading.Event()
    out: list = []

    def _run():
        try:
            out.append((True, fn()))
        except Exception as e:  # surfaced to the waiting thread
            out.append((False, e))
        finally:
            done.set()

    t = threading.Thread(target=_run, name=f"bounded-{name}", daemon=True)
    t.start()
    if not done.wait(timeout_s):
        raise RendezvousTimeoutError(
            name, generation=_generation if generation is None
            else generation, timeout_s=timeout_s, detail=detail)
    ok, value = out[0]
    if not ok:
        raise value
    return value


def process_allgather(value) -> np.ndarray:
    """Every process's host value, stacked in rank order: ``(n, *shape)``
    (``multihost_utils.process_allgather`` of the JAX package), over the
    gloo side group."""
    arr = np.asarray(value)
    local = torch.from_numpy(np.array(arr.reshape(-1)))
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local, group=_host_group())
    return np.stack([p.numpy().reshape(arr.shape) for p in parts])


def reduce_value(value, average: bool = True):
    """Sum (or average) a host-side scalar/array across processes.  No-op
    at world size 1, like the reference (distributed_utils.py:62-63)."""
    if process_count() < 2:
        return value
    total = process_allgather(value).sum(axis=0)
    return total / process_count() if average else total


def agree_max_value(value):
    """Elementwise maximum of a host-side scalar/array across processes
    (no-op at world size 1): set union on 0/1 masks."""
    if process_count() < 2:
        return value
    return process_allgather(value).max(axis=0)


def agree_min_value(value):
    """Elementwise minimum of a host-side scalar/array across processes
    (no-op at world size 1): for numbers every process must derive
    identically from its own measurement, such as the memory cap, where
    min is the conservative agreement."""
    if process_count() < 2:
        return value
    return process_allgather(value).min(axis=0)
