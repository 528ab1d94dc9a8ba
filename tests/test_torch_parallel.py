"""The port's multi-process runtime and sharding against the JAX package:
``parallel/runtime.py``'s rendezvous rules (SLURM's, line for line), its
host-side collectives and bounded barrier at 2 gloo processes, the mesh,
``ShardedBatcher``'s per-process slices of the lockstep schedule, and the
CLI plumbing that must agree across processes.

Multi-process cases run this file as a script, one process per rank,
joined by a ``file://`` rendezvous under ``tmp_path`` (no TCP port to
race for under xdist), each with a timeout of its own.  Host values are
exact: equality, no tolerance.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's modules below need it)

from can_tpu.data.batching import ShardedBatcher as JaxShardedBatcher
from can_tpu.parallel import runtime as jrt
from can_tpu_torch.cli import common
from can_tpu_torch.data import ShardedBatcher
from can_tpu_torch.parallel import make_mesh
from can_tpu_torch.parallel import mesh as pmesh
from can_tpu_torch.parallel import runtime as rt

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 120


# -- (a) rendezvous rules ------------------------------------------------------
SLURM_ENVS = [
    {},
    {"SLURM_NTASKS": "1", "SLURM_PROCID": "0", "SLURM_JOB_NODELIST": "gpu1"},
    {"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_JOB_NODELIST": "gpu[003-004,007],gpu2",
     "SLURM_JOB_ID": "123456"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_JOB_NODELIST": "node7,node8"},
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "0", "SLURM_JOB_NODELIST": "a[1-2]",
     "SLURM_JOB_ID": "x"},
    {"SLURM_NTASKS": "8", "SLURM_JOB_NODELIST": "gpu[1-2]"},          # salloc shell
    {"SLURM_PROCID": "3"},                                             # fatal
    {"SLURM_NTASKS": "four", "SLURM_PROCID": "0"},                     # fatal
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1"},                        # fatal
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "one", "SLURM_JOB_NODELIST": "n1"},  # fatal
    {"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_JOB_NODELIST": "  "},     # fatal
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (RuntimeError, ValueError) as e:
        return ("raises", str(e))


@pytest.mark.parametrize("env", SLURM_ENVS, ids=range(len(SLURM_ENVS)))
def test_slurm_rendezvous_matches_jax(env):
    """The same address, count and id, or the same fatal error, as the
    JAX package's rules; the whole resolution agrees too (it reads
    ``SLURM_PROCID`` first, as JAX's ``init_runtime`` does, so an
    unparseable id fails there)."""
    got = _outcome(rt._slurm_rendezvous, env)
    assert got == _outcome(jrt._slurm_rendezvous, env)
    rdv = _outcome(rt.resolve_rendezvous, env)
    if got[0] == "raises":
        assert rdv[0] == "raises"
    elif got[1] is None:
        assert rdv == ("ok", None)
    else:
        addr, n, pid = got[1]
        assert rdv[1] == {"init_method": f"tcp://{addr}", "world_size": n,
                          "rank": pid, "local_rank": 0, "source": "SLURM"}


@pytest.mark.parametrize("nodelist", ["gpu1", "tpu[003-004,007],gpu2", "a[9],b[1-3]",
                                      "x-y[01-04]", "h1,h2,h3"])
def test_slurm_host_and_port_match_jax(nodelist):
    assert rt._first_slurm_host(nodelist) == jrt._first_slurm_host(nodelist)
    for env in ({}, {"SLURM_JOB_ID": "98765"}, {"SLURM_JOB_ID": "bad"}):
        assert rt._slurm_port(env) == jrt._slurm_port(env)


@pytest.mark.parametrize("env,want", [
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.1",
      "MASTER_PORT": "29600"},
     {"init_method": "tcp://10.0.0.1:29600", "world_size": 8, "rank": 3,
      "local_rank": 1, "source": "torchrun"}),
    # the launcher wins over the JAX package's variables and SLURM
    ({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "h", "MASTER_PORT": "1",
      "COORDINATOR_ADDRESS": "other:2", "SLURM_NTASKS": "4", "SLURM_PROCID": "0"},
     {"init_method": "tcp://h:1", "world_size": 1, "rank": 0, "local_rank": 0,
      "source": "torchrun"}),
    ({"COORDINATOR_ADDRESS": "c0:8476", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
     {"init_method": "tcp://c0:8476", "world_size": 2, "rank": 1, "local_rank": 0,
      "source": "COORDINATOR_ADDRESS"}),
    ({"COORDINATOR_ADDRESS": "file:///tmp/rdv", "NUM_PROCESSES": "2",
      "SLURM_PROCID": "0", "SLURM_LOCALID": "0"},
     {"init_method": "file:///tmp/rdv", "world_size": 2, "rank": 0, "local_rank": 0,
      "source": "COORDINATOR_ADDRESS"}),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "1",
      "SLURM_JOB_NODELIST": "n[5-6]", "SLURM_JOB_ID": "7"},
     {"init_method": f"tcp://n5:{rt.SLURM_COORDINATOR_PORT + 7}", "world_size": 2,
      "rank": 1, "local_rank": 1, "source": "SLURM"}),
    ({"LOCAL_RANK": "2"}, None),  # no rendezvous: one process
])
def test_env_rendezvous_sources_in_order(env, want):
    assert rt.resolve_rendezvous(env) == want


def test_incomplete_coordinator_env_is_fatal():
    with pytest.raises(RuntimeError, match="refusing to guess"):
        rt.resolve_rendezvous({"COORDINATOR_ADDRESS": "c0:1"})
    assert rt.resolve_rendezvous({}, coordinator_address="h:5", num_processes=3,
                                 process_id=2)["init_method"] == "tcp://h:5"


def test_single_process_runtime_has_no_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "COORDINATOR_ADDRESS",
                "SLURM_NTASKS", "SLURM_PROCID", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    gen = rt.generation()
    topo = rt.init_runtime(platform="cpu")
    try:
        assert topo["backend"] is None and topo["process_count"] == 1
        assert rt.process_group() is None and rt.is_main_process()
        assert rt.generation() == gen + 1
        assert rt.init_runtime(platform="cpu") == topo  # live: unchanged
        assert rt.reduce_value(3.5) == 3.5 and rt.agree_min_value(2) == 2
        rt.barrier("single")  # no-op
    finally:
        rt.shutdown_runtime()
    assert not rt.runtime_active()


def test_rendezvous_error_fields():
    e = rt.RendezvousTimeoutError("ckpt", generation=3, timeout_s=2.0, missing=[1])
    j = jrt.RendezvousTimeoutError("ckpt", generation=3, timeout_s=2.0, missing=[1])
    assert (e.barrier, e.generation, e.timeout_s, e.missing) == \
        (j.barrier, j.generation, j.timeout_s, j.missing)
    assert str(e) == str(j)
    assert rt._parse_missing_ranks("[Rank 0]: Ranks 1, 3 failed to pass "
                                   "monitoredBarrier in 2000 ms") == [1, 3]
    assert rt._parse_missing_ranks("Rank 2 failed to pass monitoredBarrier") == [2]
    assert rt._parse_missing_ranks("connection closed") is None
    with pytest.raises(rt.RendezvousTimeoutError):
        rt.bounded_wait(lambda: __import__("time").sleep(5), name="w", timeout_s=0.2)
    assert rt.bounded_wait(lambda: 7, name="w", timeout_s=5) == 7


# -- (b) host collectives at 2 gloo processes ---------------------------------
def spawn(tmp_path, mode: str, nproc: int, *args, timeout=WORKER_TIMEOUT_S,
          script=__file__):
    """Run ``script`` as ``nproc`` rank processes joined by a ``file://``
    rendezvous under ``tmp_path``; returns each rank's last stdout line,
    parsed as JSON (a failure shows every rank's output)."""
    rdv = f"file://{tmp_path}/rdv-{mode}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, str(script), mode, rdv, str(nproc),
                               str(r), *map(str, args)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(rc != 0 for rc, _, _ in outs):
        raise AssertionError("\n".join(f"rank {r} rc {rc}\n{out[-3000:]}\n{err[-3000:]}"
                                       for r, (rc, out, err) in enumerate(outs)))
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def _collectives_worker(rank: int, nproc: int) -> dict:
    vals = np.arange(4, dtype=np.float32) * (rank + 1) - rank
    return {"sum": rt.reduce_value(vals, average=False).tolist(),
            "mean": rt.reduce_value(vals).tolist(),
            "scalar": float(rt.reduce_value(np.float64(rank + 0.5), average=False)),
            "min": rt.agree_min_value(vals).tolist(),
            "max": rt.agree_max_value(np.int64(rank * 7)).tolist(),
            "mem": common.agreed_device_memory_bytes("cpu"),
            "gather": rt.process_allgather(np.int64(rank)).tolist(),
            "topo": rt.init_runtime(platform="cpu")}


def test_host_collectives_at_two_processes(tmp_path):
    outs = spawn(tmp_path, "collectives", 2)
    local = [np.arange(4, dtype=np.float32) * (r + 1) - r for r in range(2)]
    stacked = np.stack(local)
    for r, out in enumerate(outs):
        assert out["sum"] == stacked.sum(0).tolist()
        assert out["mean"] == (stacked.sum(0) / 2).tolist()
        assert out["scalar"] == 0.5 + 1.5
        assert out["min"] == stacked.min(0).tolist()
        assert out["max"] == 7
        assert out["mem"] is None  # the CPU has no ceiling, so nobody caps
        assert out["gather"] == [0, 1]
        topo = out["topo"]
        assert (topo["process_index"], topo["process_count"], topo["backend"],
                topo["device"], topo["source"]) == (r, 2, "gloo", "cpu", "arguments")


def _barrier_worker(rank: int, nproc: int) -> dict:
    """Rank 1 never reaches the barrier: rank 0 must raise within the bound,
    naming it."""
    import time

    out = {}
    if rank == 0:
        t0 = time.perf_counter()
        try:
            rt.barrier("never-complete", timeout_s=2.0)
        except rt.RendezvousTimeoutError as e:
            out = {"missing": e.missing, "barrier": e.barrier,
                   "generation": e.generation, "timeout_s": e.timeout_s,
                   "seconds": time.perf_counter() - t0}
    else:
        time.sleep(4.0)
    return out


def test_barrier_names_the_rank_that_never_arrived(tmp_path):
    outs = spawn(tmp_path, "barrier", 2)
    got = outs[0]
    assert got["missing"] == [1] and got["barrier"] == "never-complete"
    assert got["timeout_s"] == 2.0 and got["generation"] >= 1
    assert 1.5 <= got["seconds"] < 15


# -- (c) the lockstep schedule's per-process slices ---------------------------
class _ItemDs:
    """Shapes, and items that name their index (pixels = index)."""

    def __init__(self, shapes):
        self.shapes = list(shapes)

    def __len__(self):
        return len(self.shapes)

    def snapped_shape(self, i):
        return self.shapes[i]

    def __getitem__(self, i, rng=None):
        h, w = self.shapes[i]
        flip = float(rng.uniform()) if rng is not None else 0.0
        img = np.full((h, w, 3), i + flip, np.float32)
        dm = np.full((h // 8, w // 8, 1), i, np.float32)
        return img, dm


def _shapes(n, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(3, 9)) * 8, int(rng.integers(3, 9)) * 8) for _ in range(n)]


@pytest.mark.parametrize("nproc", [1, 2, 4])
@pytest.mark.parametrize("mode", ["exact", "multiple", "auto", "auto-remnant"])
def test_sharded_batcher_slices_match_jax(nproc, mode):
    shapes = _shapes(37, nproc)
    kw = {"exact": dict(pad_multiple=None),
          "multiple": dict(pad_multiple=16),
          "auto": dict(pad_multiple="auto", max_buckets=4),
          "auto-remnant": dict(pad_multiple="auto", max_buckets=6,
                               remnant_sizes=True, launch_cost_px=300.0)}[mode]
    for rank in range(nproc):
        common_kw = dict(shuffle=True, seed=3, process_index=rank,
                         process_count=nproc, **kw)
        port = ShardedBatcher(_ItemDs(shapes), 2, **common_kw)
        ref = JaxShardedBatcher(_ItemDs(shapes), 2, plan_mode="cost", **common_kw)
        assert port.global_schedule(1) == ref.global_schedule(1)
        got, want = list(port.epoch(1)), list(ref.epoch(1))
        assert len(got) == len(want) == port.batches_per_epoch(1)
        for g, w in zip(got, want):
            for name in ("image", "dmap", "pixel_mask", "sample_mask"):
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    # the slices of one launch cover it once, in rank order
    if nproc > 1:
        slices = [[ShardedBatcher(_ItemDs(shapes), 2, shuffle=True, seed=3,
                                  process_index=r, process_count=nproc, **kw)
                   .host_slice(g) for r in range(nproc)]
                  for _, g in port.global_schedule(0)]
        assert [sum(s, []) for s in slices] == [g for _, g in port.global_schedule(0)]


@pytest.mark.parametrize("kw", [dict(process_count=2, batch_quantum=3),
                                dict(process_count=2, batch_quantum=8),
                                dict(process_count=4, process_index=3, batch_quantum=4)])
def test_sharded_batcher_quantum_checks_match_jax(kw):
    """The same quantum contract: the quantum splits across processes and
    divides the global batch, with JAX's errors (first word)."""
    outcomes = []
    for cls, extra in ((ShardedBatcher, {}), (JaxShardedBatcher, {"plan_mode": "cost"})):
        try:
            b = cls(_ItemDs(_shapes(12, 0)), 2, remnant_sizes=True, **kw, **extra)
            outcomes.append(("ok", b.batch_quantum))
        except ValueError as e:
            outcomes.append(("raises", str(e).split(" ")[0]))
    assert outcomes[0] == outcomes[1]


# -- the mesh and the CLI's agreement plumbing ----------------------------------
def test_mesh_is_the_world():
    """One process is a (1, 1) mesh; sp must divide the process count
    (tests/test_torch_spatial.py builds (1, 2), (2, 2) and (1, 4) meshes
    of gloo processes)."""
    mesh = make_mesh()
    assert (mesh.dp, mesh.sp, mesh.shape) == (1, 1, {"data": 1, "spatial": 1})
    assert (mesh.d, mesh.s, mesh.spatial_group, mesh.data_group) == (0, 0, None, None)
    assert pmesh.DATA_AXIS == "data" and pmesh.SPATIAL_AXIS == "spatial"
    with pytest.raises(ValueError, match="not divisible by sp=2"):
        make_mesh(sp=2)
    with pytest.raises(ValueError, match="processes"):
        make_mesh(dp=2)
    mesh, per_proc, dp = common.build_mesh_and_batch(8)
    assert (per_proc, dp) == (8, 1)
    with pytest.raises(ValueError, match="--sp 4 does not divide the process count 1"):
        common.build_mesh_and_batch(8, sp=4)
    # rank = d * sp + s, JAX's (dp, sp) device order
    big = pmesh.Mesh(dp=2, sp=4, d=1, s=2)
    assert [big.rank_of(d, s) for d in range(2) for s in range(4)] == list(range(8))


def test_launch_cap_and_remat_scale_with_the_shards():
    gib = 80 * 2 ** 30
    one = common.max_launch_pixels(bf16=True, hbm_bytes=gib)
    assert common.max_launch_pixels(bf16=True, hbm_bytes=gib, shards=4) == \
        pytest.approx(4 * one, rel=1e-12)
    fixed, per_px = common.train_footprint(bf16=True)
    px = (0.8 * gib - fixed) / per_px  # the budget's pixels on one card
    side = int(np.sqrt(px / 8)) + 8
    single = common.make_remat_policy("auto", global_batch=8, bf16=True, hbm_bytes=gib)
    split = common.make_remat_policy("auto", global_batch=16, bf16=True,
                                     hbm_bytes=gib, shards=2)
    # 8 images on one card are over the budget, 4 are under: a global
    # launch of 16 split across 2 cards is 8 per card
    assert single((side, side)) and not single((side, side), batch=4)
    assert split((side, side)) and not split((side, side), batch=8)
    assert common.agreed_device_memory_bytes("cpu") is None


# -- worker entry ------------------------------------------------------------
def _worker_main(argv) -> None:
    mode, rdv, nproc, rank = argv[0], argv[1], int(argv[2]), int(argv[3])
    rt.init_runtime(platform="cpu", coordinator_address=rdv,
                    num_processes=nproc, process_id=rank)
    try:
        out = {"collectives": _collectives_worker,
               "barrier": _barrier_worker}[mode](rank, nproc)
    finally:
        rt.shutdown_runtime()
    print(json.dumps(out))


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker_main(sys.argv[1:])
