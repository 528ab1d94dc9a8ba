"""Mask-aware density losses and counts (counterpart of
``can_tpu/train/loss.py:21-37``).

Batches are padded to static shapes, so every term is multiplied by the
density-grid validity mask: padded cells and fill slots contribute
exactly 0.  ``batch`` is a dict of tensors with ``dmap``, ``pixel_mask``
((B, h, w, 1)) and ``sample_mask`` ((B,)).
"""

from __future__ import annotations

import torch


def _full_mask(batch) -> torch.Tensor:
    """(B, h, w, 1) combined pixel+sample mask."""
    return batch["pixel_mask"] * batch["sample_mask"][:, None, None, None]


def masked_mse_sum(pred: torch.Tensor, batch) -> torch.Tensor:
    """Sum of squared errors over valid density cells
    (``MSELoss(reduction='sum')``)."""
    err = (pred.float() - batch["dmap"]) * _full_mask(batch)
    return torch.sum(err * err)


def density_counts(pred: torch.Tensor, batch):
    """Per-image predicted and ground-truth counts (masked sums), each (B,)."""
    mask = _full_mask(batch)
    et = torch.sum(pred.float() * mask, dim=(1, 2, 3))
    gt = torch.sum(batch["dmap"] * mask, dim=(1, 2, 3))
    return et, gt
