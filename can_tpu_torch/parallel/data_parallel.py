"""Data parallelism over processes: DDP (counterpart of
``can_tpu/parallel/data_parallel.py``).

The reference wraps its model in ``DistributedDataParallel`` and lets
its bucketed gradient all-reduce overlap the backward (train.py:121-122);
the JAX package gets the same from GSPMD.  Here it is the reference's
mechanism again:

* every process holds the whole model and its optimizer (the same seed
  gives the same weights; DDP also broadcasts rank 0's at construction);
* each process steps on its own slice of the global batch, which
  ``data/batching.py``'s lockstep schedule hands it: no process ever
  holds the global batch;
* DDP averages the gradients over the ``dp`` ranks.  That average *is*
  the JAX package's ``grad_divisor = dp`` (DDP's average of per-rank
  MSE-sums, SURVEY §7 hard part d), so the step's own divisor stays 1 —
  dividing there as well would divide twice.  The lr scales with the
  world (``train.make_lr_schedule(world_size=dp)``);
* with ``--syncBN`` the BN moments are the global batch's: each BN layer
  all-reduces its packed local sums over the process group
  (``ops/bn_moments.py``), inside the forward and, with remat, again in
  the backward's recompute.  ``broadcast_buffers=False``: the running
  statistics come from global moments, so they are equal on every rank
  already;
* metrics: the train step's are this process's (``train/loop.py`` sums
  each fetch window across processes before its non-finite check); the
  eval step's are global sums.

Without a process group (one process, no launcher) the steps are the
plain single-process ones: no DDP, no collective.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from can_tpu_torch.data.batching import Batch
from can_tpu_torch.parallel.mesh import Mesh
from can_tpu_torch.parallel.runtime import process_group
from can_tpu_torch.train.steps import (
    batch_to_device,
    make_bucketed_train_step,
    make_eval_step,
    make_train_step,
)

EVAL_KEYS = ("abs_err_sum", "sq_err_sum", "num_valid")


def make_global_batch(batch: Batch, mesh: Mesh, *, device) -> Dict[str, torch.Tensor]:
    """This process's slice of a global batch -> the step's dict of
    tensors on ``device`` (the global batch is ``mesh.dp`` such slices;
    none is ever gathered)."""
    del mesh  # each process holds its own slice only
    return batch_to_device(batch, device)


def dp_size(mesh: Mesh) -> int:
    return mesh.dp


def make_dp_train_step(model: torch.nn.Module, mesh: Mesh, *,
                       compute_dtype=None, bn_ops=None, remat: bool = False,
                       policy: Optional[Callable] = None,
                       health_metrics: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` for a state whose
    model is ``model``, on this process's slice of each global batch.

    Under a process group ``model`` is wrapped in DDP once, here (the
    gradient average over ``dp``), and BN layers sync their moments over
    the group; without one this is ``train.make_train_step``.  The state
    keeps the bare module, so state-dict keys carry no ``module.``
    prefix.
    ``policy``: per-launch remat (``cli.common.make_remat_policy``, asked
    with the global launch size); else ``remat`` for every launch.
    """
    group = process_group()
    ddp = None
    if group is not None:
        dev = next(model.parameters()).device
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=group, broadcast_buffers=False,
            gradient_as_bucket_view=True)
    kw = dict(compute_dtype=compute_dtype, bn_ops=bn_ops,
              health_metrics=health_metrics, module=ddp, bn_axes=group,
              bn_shards=dp_size(mesh))
    step = (make_train_step(remat=remat, **kw) if policy is None
            else make_bucketed_train_step(policy=policy, dp=dp_size(mesh), **kw))

    def train_step(state, batch):
        if state.model is not model:
            raise ValueError("make_dp_train_step was built for another model")
        return step(state, batch)

    return train_step


def make_dp_eval_step(mesh: Mesh, *, compute_dtype=None) -> Callable:
    """``eval_step(model, batch) -> metrics`` with global sums: this
    process's ``abs_err_sum``, ``sq_err_sum`` and ``num_valid``, summed
    over the process group in one all-reduce (none without a group)."""
    del mesh  # every process evaluates its own slice; the group sums
    step = make_eval_step(compute_dtype=compute_dtype)
    group = process_group()
    if group is None:
        return step

    def eval_step(model, batch):
        metrics = step(model, batch)
        with torch.inference_mode():
            sums = torch.stack([metrics[k].float() for k in EVAL_KEYS])
            dist.all_reduce(sums, group=group)
        return dict(zip(EVAL_KEYS, sums.unbind()))

    return eval_step
