"""The (dp, sp) world of a run (counterpart of ``can_tpu/parallel/mesh.py``).

The JAX package's world is a ``jax.sharding.Mesh`` over every chip, with
parallelism expressed as shardings over named axes.  Here the world is N
processes of one GPU each, joined by a process group
(``parallel/runtime.py``), as in the reference (utils/distributed_utils.py:
23-28); ``Mesh`` describes it: ``dp`` data-parallel replicas by ``sp``
spatial shards, with ``rank = d * sp + s`` (the order in which JAX's
``make_mesh`` reshapes its device list into (dp, sp)).

* ``data``    — data parallelism over the ``dp`` replicas: DDP
  (``parallel/data_parallel.py``) when ``sp == 1``; the ranks of one
  replica (one ``d``) hold the same images;
* ``spatial`` — image-height sharding over the ``sp`` ranks of one
  replica (``parallel/spatial.py``): each holds rows
  ``[s * H/sp, (s + 1) * H/sp)`` of every image of its replica.

Under ``sp > 1`` every rank creates the sub-groups in the same order (a
``new_group`` call is collective over the world): one spatial group per
``d`` (its ranks ``d * sp .. d * sp + sp - 1``; the halo exchange and the
pooled sums), then one data group per ``s`` (ranks ``s, sp + s, ...``;
the eval metric sums).  A group of one rank is None, and a group that is
the whole world is the world's group.

``batch_sharding`` and ``replicated_sharding`` have no counterpart: every
process holds the whole model, and each process's batch is its own slice
of the global batch (``data/batching.py``'s lockstep schedule), so no
array is ever laid out across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from can_tpu_torch.parallel.runtime import generation, process_count, process_group

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# meshes of the live runtime generation, by (dp, sp): every rank builds
# the same sequence of meshes, so each one's groups are created once
_MESHES: Dict[tuple, "Mesh"] = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` data-parallel replicas by ``sp`` spatial shards, and this
    rank's place ``(d, s)`` in them with its two groups: ``spatial_group``
    (the ``sp`` ranks of replica ``d``) and ``data_group`` (the ``dp``
    ranks of shard ``s``), None where the group is this rank alone."""

    dp: int
    sp: int = 1
    d: int = 0
    s: int = 0
    spatial_group: Optional[object] = dataclasses.field(default=None, compare=False)
    data_group: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, SPATIAL_AXIS: self.sp}

    def rank_of(self, d: int, s: int) -> int:
        """The world rank of replica ``d``, shard ``s``."""
        return d * self.sp + s


def make_mesh(*, dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """The world as a (dp, sp) mesh, one GPU per process: ``dp`` defaults
    to the process count over ``sp``, and ``dp * sp`` must equal the
    process count.  Collective under ``sp > 1`` with ``dp > 1``: every
    process calls it with the same arguments."""
    n = process_count()
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if dp is None:
        if n % sp:
            raise ValueError(f"{n} processes not divisible by sp={sp}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp * sp} != {n} processes (one GPU each)")
    key = (generation(), int(dp), int(sp))
    for stale in [k for k in _MESHES if k[0] != key[0]]:
        del _MESHES[stale]  # an elastic transition's dead world's groups
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = _build(int(dp), int(sp))
    return mesh


def forget_meshes() -> None:
    """Drop every cached mesh and with it its groups: an elastic survivor
    calls it before the old generation's groups are destroyed, and the
    next ``make_mesh`` builds the new generation's (dp', sp) mesh, its
    groups created in the same order on every rank."""
    _MESHES.clear()


def _build(dp: int, sp: int) -> Mesh:
    world = process_group()
    rank = dist.get_rank() if world is not None else 0
    d, s = divmod(rank, sp)
    if sp == 1:  # the data-parallel world: the whole world is one data group
        return Mesh(dp=dp, sp=1, d=d, s=0, data_group=world if dp > 1 else None)
    if dp == 1:
        return Mesh(dp=1, sp=sp, d=0, s=s, spatial_group=world)
    spatial = data = None
    for dd in range(dp):  # the same creation order on every rank
        g = dist.new_group(ranks=[dd * sp + ss for ss in range(sp)])
        if dd == d:
            spatial = g
    for ss in range(sp):
        g = dist.new_group(ranks=[dd * sp + ss for dd in range(dp)])
        if ss == s:
            data = g
    return Mesh(dp=dp, sp=sp, d=d, s=s, spatial_group=spatial, data_group=data)
