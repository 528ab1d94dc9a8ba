"""Train and eval steps (counterpart of ``can_tpu/train/steps.py:39-176``).

The reference's hot loop (utils/train_eval_utils.py:28-52): forward,
masked MSE-sum, backward, SGD step.  DDP averages per-rank gradients of
per-rank MSE-sums while the lr scales with the world, so the global
equivalent is ``loss = sse / grad_divisor`` with ``grad_divisor`` the
data-parallel world size.  Under DDP (``parallel/data_parallel.py``)
that average is DDP's own, and the step's divisor stays 1.

A step runs eagerly and leaves its metrics on the device: the loop
fetches them once per window (``train/loop.py``), never once per step.
The step is three pieces — ``forward_loss``, ``backward``, then
``TrainState.apply_update`` — so a profiler can time each.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from can_tpu_torch.data.batching import Batch
from can_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from can_tpu_torch.data.prefetch import batch_tensors
from can_tpu_torch.train.loss import density_counts, masked_mse_sum


def batch_signature(batch) -> tuple:
    """The ``(shape, dtype)`` signature of a batch dict of tensors or
    arrays: sorted ``(name, shape, dtype name)`` triples, the dtype named
    as numpy names it (``float32``, ``uint8``), so the port's signatures
    read as the reference's.  ``obs.RecompileTracker`` attributes each new
    signature's first-call bill to the batch that incurred it (masks and
    dtypes count too: ``--u8-input`` flips the image dtype without
    touching the shape)."""
    return tuple(sorted(
        (k, tuple(v.shape),
         str(getattr(v, "dtype", type(v).__name__)).removeprefix("torch."))
        for k, v in batch.items() if hasattr(v, "shape")))


def normalize_on_device(image: torch.Tensor,
                        pixel_mask: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> ImageNet-normalised f32, on the image's device.

    The host ships bytes (4x less than normalised f32).  Padded pixels are
    zeroed in NORMALISED space via the upsampled pixel_mask (the
    downsample factor comes from the image/mask shapes), so the result
    equals the f32 host path, whose zero padding also lives in normalised
    space.  Float images pass through untouched.
    """
    if image.dtype != torch.uint8:
        return image
    ds = image.shape[-3] // pixel_mask.shape[-3]
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    x = (image.float() / 255.0 - mean) / std
    m = pixel_mask.repeat_interleave(ds, dim=-3).repeat_interleave(ds, dim=-2)
    return x * m


def batch_to_device(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """A host ``Batch`` -> the step's dict of tensors on ``device``."""
    return {k: t.to(device) for k, t in batch_tensors(batch).items()}


class NonFiniteLossError(RuntimeError):
    """Raised on a NaN/Inf loss (at the loop's windowed metric check).
    The reference ``sys.exit(1)``s the observing rank while its peers wait
    in NCCL collectives; here every process raises on the same value."""


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over a list of tensors (optax.global_norm), in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def forward_loss(state, batch: Dict[str, torch.Tensor], *, grad_divisor: int = 1,
                 compute_dtype=None, bn_ops=None, remat: bool = False,
                 module=None, bn_axes=None, bn_shards: int = 1):
    """Forward and masked MSE-sum on a device batch: returns
    ``(sse / grad_divisor, sse)``.  A BN model trains (batch moments
    through ``bn_ops`` with the masks, over the process group ``bn_axes``
    of ``bn_shards`` ranks under SyncBN, running statistics updated);
    ``remat`` recomputes the forward's segments in the backward.
    ``module``: what runs the forward (a ``DistributedDataParallel``
    wrapping ``state.model``; default the model itself)."""
    image = normalize_on_device(batch["image"], batch["pixel_mask"])
    pred = (module or state.model)(
        image, train=True, pixel_mask=batch["pixel_mask"],
        sample_mask=batch["sample_mask"], bn_ops=bn_ops,
        compute_dtype=compute_dtype, remat=remat, bn_axes=bn_axes,
        bn_shards=bn_shards)
    sse = masked_mse_sum(pred, batch)
    return sse / grad_divisor, sse


def backward(state, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()


def make_train_step(*, grad_divisor: int = 1, compute_dtype=None,
                    bn_ops=None, health_metrics: bool = False,
                    remat: bool = False, module=None, bn_axes=None,
                    bn_shards: int = 1) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    (a ``train.state.TrainState``) is updated in place.  ``remat``: the
    backward recomputes the forward segment by segment (``CANNet.forward``)
    — the same loss, gradients and running statistics, less memory.
    ``module``, ``bn_axes``, ``bn_shards``: ``forward_loss``'s (the DDP
    step of ``parallel.data_parallel.make_dp_train_step``).

    batch: dict of device tensors image/dmap/pixel_mask/sample_mask
    (``data.batching.Batch`` fields).  metrics: device scalars — ``loss``
    (this process's SSE, before the divisor) and ``num_valid``; with
    ``health_metrics`` also ``grad_norm`` and ``update_norm`` (global L2 of
    the gradients and of the update ``-lr * momentum buffer``)."""

    def train_step(state, batch):
        loss, sse = forward_loss(state, batch, grad_divisor=grad_divisor,
                                 compute_dtype=compute_dtype, bn_ops=bn_ops,
                                 remat=remat, module=module, bn_axes=bn_axes,
                                 bn_shards=bn_shards)
        backward(state, loss)
        params = [p for p in state.model.parameters() if p.grad is not None]
        grad_norm = global_norm([p.grad for p in params]) if health_metrics else None
        lr = state.apply_update()
        metrics = {"loss": sse.detach(), "num_valid": torch.sum(batch["sample_mask"])}
        if health_metrics:
            bufs = [state.optimizer.state[p]["momentum_buffer"] for p in params]
            metrics["grad_norm"] = grad_norm
            metrics["update_norm"] = lr * global_norm(bufs)
        return state, metrics

    return train_step


def make_bucketed_train_step(*, policy: Callable, dp: int = 1,
                             **step_kw) -> Callable:
    """A train step that asks ``policy(hw, batch) -> bool`` per launch
    whether to rematerialise (``cli.common.make_remat_policy``; the
    counterpart of can_tpu/cli/common.py:567's per-bucket remat
    dispatch).  ``batch`` is the global launch, this process's slice
    times ``dp``, as the JAX package's global batch.  ``step_kw``:
    ``make_train_step``'s other arguments."""
    steps = {flag: make_train_step(remat=flag, **step_kw)
             for flag in (False, True)}

    def train_step(state, batch):
        shape = batch["image"].shape
        on = bool(policy(tuple(shape[1:3]), batch=shape[0] * dp))
        return steps[on](state, batch)

    return train_step


def make_eval_step(*, compute_dtype=None) -> Callable:
    """Returns ``eval_step(model, batch) -> metrics`` (device scalars):
    ``abs_err_sum`` = sum_i |et_i - gt_i|, ``sq_err_sum`` = sum_i
    (et_i - gt_i)^2 and ``num_valid`` — enough for the dataset MAE and
    RMSE on the host without shipping density maps back.  A BN model
    normalises with its running statistics."""

    def eval_step(model, batch):
        with torch.inference_mode():
            image = normalize_on_device(batch["image"], batch["pixel_mask"])
            pred = model(image, compute_dtype=compute_dtype)
            et, gt = density_counts(pred, batch)
            err = (et - gt) * batch["sample_mask"]
            return {"abs_err_sum": torch.sum(torch.abs(err)),
                    "sq_err_sum": torch.sum(err * err),
                    "num_valid": torch.sum(batch["sample_mask"])}

    return eval_step
