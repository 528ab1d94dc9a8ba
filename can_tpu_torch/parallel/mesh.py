"""The (dp, sp) world of a run (counterpart of ``can_tpu/parallel/mesh.py``).

The JAX package's world is a ``jax.sharding.Mesh`` over every chip, with
parallelism expressed as shardings over named axes.  Here the world is N
processes of one GPU each, joined by a process group
(``parallel/runtime.py``), as in the reference (utils/distributed_utils.py:
23-28); ``Mesh`` only describes it: ``dp`` data-parallel replicas (the
world size) and ``sp`` spatial shards.

* ``data``    — data parallelism over processes: DDP
  (``parallel/data_parallel.py``);
* ``spatial`` — image-height sharding (``sp > 1``) is not ported yet:
  ROADMAP Queue 1 item 4.

``batch_sharding`` and ``replicated_sharding`` have no counterpart: DDP
replicates the parameters on every process, and each process's batch is
its own slice of the global batch (``data/batching.py``'s lockstep
schedule), so no array is ever laid out across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from can_tpu_torch.parallel.runtime import process_count

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
SPATIAL_MESSAGE = ("spatial parallelism (sp={sp} > 1) is not ported yet: it "
                   "comes with ROADMAP Queue 1 item 4")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` data-parallel replicas (processes) by ``sp`` spatial shards."""

    dp: int
    sp: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, SPATIAL_AXIS: self.sp}


def make_mesh(*, dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """The world as a (dp, sp) mesh: ``dp`` defaults to the process count
    and must equal it (one GPU per process); ``sp > 1`` raises."""
    if sp != 1:
        raise NotImplementedError(SPATIAL_MESSAGE.format(sp=sp))
    n = process_count()
    if dp is None:
        dp = n
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp * sp} != {n} processes (one GPU each)")
    return Mesh(dp=int(dp), sp=int(sp))
