"""Multi-process training over ``torch.distributed`` (counterpart of
``can_tpu/parallel``): the runtime (rendezvous, bounded barriers,
host-value agreement), the (dp, sp) mesh, DDP with SyncBN and spatial
parallelism (image-height sharding with halo exchange, SyncBN over the
dp x sp world).  The JAX package's ``batch_sharding`` and
``replicated_sharding`` have no counterpart (``parallel/mesh.py``): each
process's batch is its own slice and every process holds the whole
model."""

from .mesh import Mesh, make_mesh
from .runtime import (
    init_runtime,
    shutdown_runtime,
    process_index,
    process_count,
    is_main_process,
    barrier,
    reduce_value,
    agree_max_value,
    agree_min_value,
    generation,
    runtime_active,
    RendezvousTimeoutError,
)
from .data_parallel import (
    make_global_batch,
    make_dp_train_step,
    make_dp_eval_step,
    spatial_rows,
)
from .spatial import (
    HaloTransport,
    halo_exchange_rows,
    make_spatial_ops,
    make_spatial_apply,
    make_sp_train_step,
    make_sp_eval_step,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "init_runtime",
    "shutdown_runtime",
    "process_index",
    "process_count",
    "is_main_process",
    "barrier",
    "reduce_value",
    "agree_max_value",
    "agree_min_value",
    "generation",
    "runtime_active",
    "RendezvousTimeoutError",
    "make_global_batch",
    "make_dp_train_step",
    "make_dp_eval_step",
    "spatial_rows",
    "HaloTransport",
    "halo_exchange_rows",
    "make_spatial_ops",
    "make_spatial_apply",
    "make_sp_train_step",
    "make_sp_eval_step",
]
