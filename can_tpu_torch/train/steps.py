"""Train and eval steps (counterpart of ``can_tpu/train/steps.py:39-176``).

The reference's hot loop (utils/train_eval_utils.py:28-52): forward,
masked MSE-sum, backward, SGD step.  DDP averages per-rank gradients of
per-rank MSE-sums while the lr scales with the world, so the global
equivalent is ``loss = sse / grad_divisor`` with ``grad_divisor`` the
data-parallel world size (1 on one GPU).

A step runs eagerly and leaves its metrics on the device: the loop
fetches them once per window (``train/loop.py``), never once per step.
The step is three pieces — ``forward_loss``, ``backward``, then
``TrainState.apply_update`` — so a profiler can time each.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from can_tpu_torch.data.batching import Batch
from can_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from can_tpu_torch.train.loss import density_counts, masked_mse_sum


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
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(batch, k))).to(device)
            for k in ("image", "dmap", "pixel_mask", "sample_mask")}


class NonFiniteLossError(RuntimeError):
    """Raised on a NaN/Inf loss (at the loop's windowed metric check).
    The reference ``sys.exit(1)``s the observing rank while its peers wait
    in NCCL collectives; here every process raises on the same value."""


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over a list of tensors (optax.global_norm), in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def forward_loss(state, batch: Dict[str, torch.Tensor], *, grad_divisor: int = 1,
                 compute_dtype=None, bn_ops=None):
    """Forward and masked MSE-sum on a device batch: returns
    ``(sse / grad_divisor, sse)``.  A BN model trains (batch moments
    through ``bn_ops`` with the masks, running statistics updated)."""
    image = normalize_on_device(batch["image"], batch["pixel_mask"])
    pred = state.model(image, train=True, pixel_mask=batch["pixel_mask"],
                       sample_mask=batch["sample_mask"], bn_ops=bn_ops,
                       compute_dtype=compute_dtype)
    sse = masked_mse_sum(pred, batch)
    return sse / grad_divisor, sse


def backward(state, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()


def make_train_step(*, grad_divisor: int = 1, compute_dtype=None,
                    bn_ops=None, health_metrics: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    (a ``train.state.TrainState``) is updated in place.

    batch: dict of device tensors image/dmap/pixel_mask/sample_mask
    (``data.batching.Batch`` fields).  metrics: device scalars — ``loss``
    (the global SSE, before the divisor) and ``num_valid``; with
    ``health_metrics`` also ``grad_norm`` and ``update_norm`` (global L2 of
    the gradients and of the update ``-lr * momentum buffer``)."""

    def train_step(state, batch):
        loss, sse = forward_loss(state, batch, grad_divisor=grad_divisor,
                                 compute_dtype=compute_dtype, bn_ops=bn_ops)
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
