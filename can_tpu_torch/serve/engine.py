"""ServeEngine: device-resident CANNet + the per-batch predict math
(counterpart of ``can_tpu/serve/engine.py:70-321``).

The prediction is the offline eval step's: normalise-on-device for u8
batches, the CANNet forward, then the masked per-image count reduction
``train.loss.density_counts``.  Around it the engine keeps:

* the weights on the device from construction, in the ``serve_dtype``
  storage format (``serve/quant.py``), 3x3 conv kernels in channels_last;
* ``warmup()``: one zero batch per (bucket shape, dtype) before traffic,
  so the kernel library's build and cuDNN's per-shape setup are paid
  before the first request (cuDNN's exhaustive ``benchmark`` search is
  left off: it cost minutes of start-up in f32 — PERF.md);
  ``compile_count`` is the number of warmed (shape, dtype) signatures;
* ``release_buffers()``: drop the device weights.

In f32 mode the engine turns TF32 off — ``torch.backends.cudnn.allow_tf32
= False`` and matmul precision ``"highest"``: cuDNN runs f32 convolutions
in TF32 by default, which would shift counts by about 1e-3.  These are
process-wide PyTorch settings.
"""

from __future__ import annotations

import gc
import time
from typing import Optional, Tuple

import numpy as np
import torch

from can_tpu_torch.data.batching import Batch, pad_batch
from can_tpu_torch.device import use_full_f32
from can_tpu_torch.models.cannet import CANNet
from can_tpu_torch.serve.quant import (
    compute_dtype_for,
    quantize_tree,
    storage_dtype_for,
)
from can_tpu_torch.train.loss import density_counts
from can_tpu_torch.train.steps import normalize_on_device
from can_tpu_torch.utils.torch_import import is_batch_norm_layout


class ServeEngine:
    """Executes padded serve batches on one device.

    state_dict: reference-layout f32 weights (``utils.torch_import``),
      plain or BN; a BN model normalises with its running statistics,
      kept in f32 in every serve dtype (as the JAX engine keeps its
      ``batch_stats``).
    serve_dtype: "f32" | "bf16" (``serve/quant.py``).
    device: where the weights live and the batches run (no default: the
    caller resolves it, ``device.resolve_device``).
    """

    def __init__(self, state_dict, *, device, serve_dtype: str = "f32",
                 ds: int = 8):
        self.device = torch.device(device)
        self.serve_dtype = serve_dtype
        self.ds = int(ds)
        self.compute_dtype = compute_dtype_for(serve_dtype)
        if self.device.type == "cuda" and serve_dtype == "f32":
            use_full_f32()
        model = CANNet(device=self.device, dtype=storage_dtype_for(serve_dtype),
                       seed=None, batch_norm=is_batch_norm_layout(state_dict))
        for layer in model.modules():
            if isinstance(layer, torch.nn.BatchNorm2d):
                layer.running_mean = layer.running_mean.float()
                layer.running_var = layer.running_var.float()
        model.load_state_dict(quantize_tree(state_dict, serve_dtype),
                              strict=True)
        self.model: Optional[CANNet] = model.to(
            memory_format=torch.channels_last).eval()
        self._signatures: set = set()
        self.released = False

    @property
    def compile_count(self) -> int:
        """Distinct (image shape, dtype) signatures run so far."""
        return len(self._signatures)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def predict_batch(self, batch: Batch, *, want_density: bool = False
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Run one padded batch; returns host (counts (B,), masked density
        (B, h, w, 1) f32 or None).  The density map is copied to the host
        only when a request asked for it."""
        if self.released:
            raise RuntimeError("serve engine buffers released — build a "
                               "fresh engine to serve again")
        self._signatures.add((tuple(batch.image.shape), str(batch.image.dtype)))
        with torch.inference_mode():
            t = {"image": self._put(batch.image), "dmap": self._put(batch.dmap),
                 "pixel_mask": self._put(batch.pixel_mask),
                 "sample_mask": self._put(batch.sample_mask)}
            image = normalize_on_device(t["image"], t["pixel_mask"])
            pred = self.model(image, compute_dtype=self.compute_dtype)
            counts, _ = density_counts(pred, t)
            density = None
            if want_density:
                mask = t["pixel_mask"] * t["sample_mask"][:, None, None, None]
                density = (pred.float() * mask).cpu().numpy()
            return counts.cpu().numpy(), density

    def release_buffers(self) -> None:
        """Drop the device-resident weights (idempotent); a released
        engine refuses ``predict_batch``."""
        self.model = None
        self.released = True
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def warmup(self, bucket_shapes, max_batch: int, *,
               dtypes=(np.float32,)) -> dict:
        """Run one zero batch of ``max_batch`` slots for every (bucket
        shape, image dtype) before traffic.  Returns ``{"shapes",
        "compiles" (new signatures), "seconds"}``."""
        t0 = time.perf_counter()
        before = self.compile_count
        shapes = sorted(set(map(tuple, bucket_shapes)))
        for bh, bw in shapes:
            if bh % self.ds or bw % self.ds:
                raise ValueError(f"bucket shape {bh}x{bw} is not a multiple "
                                 f"of the density downsample ({self.ds})")
            for dt in dtypes:
                img = np.zeros((bh, bw, 3), dt)
                dm = np.zeros((bh // self.ds, bw // self.ds, 1), np.float32)
                self.predict_batch(pad_batch([(img, dm)], (bh, bw), max_batch,
                                             [False], self.ds))
        return {"shapes": len(shapes),
                "compiles": self.compile_count - before,
                "seconds": round(time.perf_counter() - t0, 3)}
