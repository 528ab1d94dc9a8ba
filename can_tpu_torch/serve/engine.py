"""ServeEngine: device-resident CANNet + the per-batch predict math
(counterpart of ``can_tpu/serve/engine.py``).

The prediction is the offline eval step's: normalise-on-device for u8
batches, the CANNet forward, then the masked per-image count reduction
``train.loss.density_counts``.  Around it the engine keeps:

* the weights on the device from construction, in the ``serve_dtype``
  storage format (``serve/quant.py``), 3x3 conv kernels in
  channels_last.  f32 and bf16 weights are the model's own parameters;
  int8 weights stay int8 on the device — the model is a skeleton on the
  ``meta`` device with no storage of its own, and each launch
  dequantises the ``{"q", "scale"}`` pairs into f32 temporaries and runs
  the forward through ``torch.func.functional_call`` (so the resident
  bytes are the int8 ones, about a quarter of f32's);
* ``warmup()``: one zero batch per (bucket shape, launch size, image
  dtype) before traffic, so the kernel library's build and cuDNN's
  per-shape setup are paid before the first request; ``compile_count``
  is the number of distinct (batch shape, dtype) signatures run;
* ``swap_params()``: replace the served weights with a tree of the same
  signature (names, shapes, dtypes) — every warmed shape serves the new
  weights with no new signature; a mismatched tree is refused;
* ``release_buffers()``: drop the device weights;
* ``aot_programs``: an AOT bundle's signature table for this device
  (``serve/aot.py``): a batch on a bundled signature is an AOT hit
  (``aot_hits``), not a first-seen signature — ``compile_count`` and the
  ``compile`` event stay untouched, ``last_batch_compiled`` is False and
  ``is_warm`` True, as a loaded executable is in the JAX engine.  The
  launch itself is the same (same weights, same kernels), so counts are
  bitwise the warm path's.

With a ``telemetry`` bus the engine emits the reference's events: one
``compile`` per new batch signature (``obs.RecompileTracker``'s payload:
the signature's first call, timed) and one ``serve.warmup`` per warmup.
With a cost ledger on the bus (``Telemetry.ledger``) that first call's
forward runs inside the ledger's counting scope: the signature is
registered under the engine's ``name`` and the ``compile`` event carries
its ``flops`` and ``bytes_accessed``.

When the forward computes in f32 (f32 and int8) the engine turns TF32
off — ``torch.backends.cudnn.allow_tf32 = False`` and matmul precision
``"highest"``: cuDNN runs f32 convolutions in TF32 by default, which
would shift counts by about 1e-3.  These are process-wide settings.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from can_tpu_torch.data.batching import Batch, pad_batch
from can_tpu_torch.device import use_full_f32
from can_tpu_torch.models.cannet import CANNet
from can_tpu_torch.obs.costs import count_costs
from can_tpu_torch.sched import normalize_sizes
from can_tpu_torch.serve.quant import (
    compute_dtype_for,
    dequantize_tree,
    is_quantized_leaf,
    quantize_tree,
)
from can_tpu_torch.train.loss import density_counts
from can_tpu_torch.train.steps import batch_signature, normalize_on_device
from can_tpu_torch.utils.torch_import import is_batch_norm_layout

SWAP_MISMATCH = (
    "swap_params structure mismatch: the new checkpoint's param tree "
    "differs in structure/shape/dtype from the serving tree — flipping "
    "would recompile every bucket program mid-traffic; deploy it as a "
    "fresh fleet instead")


def tree_signature(tree) -> tuple:
    """Names + per-leaf (shape, dtype) of a storage tree — the warmed
    launches' view of the weights.  Two trees with equal signatures are
    interchangeable without a new signature."""
    out = []
    for k, v in tree.items():
        if is_quantized_leaf(v):
            out += [(f"{k}.{sub}", tuple(v[sub].shape), str(v[sub].dtype))
                    for sub in ("q", "scale")]
        else:
            out.append((k, tuple(v.shape), str(v.dtype)))
    return tuple(out)


class ServeEngine:
    """Executes padded serve batches on one device.

    state_dict: reference-layout f32 weights (``utils.torch_import``),
      plain or BN; a BN model normalises with its running statistics,
      kept in f32 in every serve dtype (as the JAX engine keeps its
      ``batch_stats``).
    serve_dtype: "f32" | "bf16" | "int8" (``serve/quant.py``).
    compute_dtype: overrides the mode's compute dtype (the legacy
      ``--bf16``: f32 weights, bf16 compute); None derives it.
    quantized: ``state_dict`` is already in ``serve_dtype`` storage form.
    device: where the weights live and the batches run (no default: the
    caller resolves it, ``device.resolve_device``).
    name: the engine's program name; a fleet names each replica
      incarnation apart (``f"{name}_r{k}"``), and stream pins hold it.
    telemetry: optional bus for ``compile`` and ``serve.warmup`` events.
    aot_programs: ``{(image shape, dtype str): record}`` of an AOT bundle
      (``AotBundle.programs_for(device)``), or None.
    """

    def __init__(self, state_dict, *, device, serve_dtype: str = "f32",
                 compute_dtype=None, quantized: bool = False, ds: int = 8,
                 name: str = "serve_predict", telemetry=None,
                 aot_programs=None):
        self.name = name
        self._aot = dict(aot_programs) if aot_programs else {}
        self.aot_hits = 0
        self.telemetry = telemetry
        self.device = torch.device(device)
        self.serve_dtype = serve_dtype
        self.ds = int(ds)
        mode_dtype = compute_dtype_for(serve_dtype)
        self.compute_dtype = (mode_dtype if compute_dtype is None
                              else compute_dtype)
        if self.device.type == "cuda" and self.compute_dtype is None:
            use_full_f32()
        storage = (state_dict if quantized
                   else quantize_tree(state_dict, serve_dtype))
        self.params = self._put(storage)
        self._signature = tree_signature(self.params)
        # int8: a storage-less skeleton, called with dequantised weights
        self._functional = serve_dtype == "int8"
        model = CANNet(device="meta", seed=None,
                       batch_norm=is_batch_norm_layout(storage))
        if not self._functional:
            model.load_state_dict(self.params, strict=True, assign=True)
        self.model: Optional[CANNet] = model.eval()
        self._lock = threading.Lock()  # swap_params vs a running launch
        self._signatures: set = set()
        self._last_compiled = False
        self.released = False

    def _put(self, tree) -> dict:
        """Storage tree -> device tensors, 4-D weights channels_last."""
        def put(t):
            fmt = (torch.channels_last if t.dim() == 4
                   else torch.contiguous_format)
            return t.to(device=self.device, memory_format=fmt)

        return {k: ({"q": put(v["q"]), "scale": put(v["scale"])}
                    if is_quantized_leaf(v) else put(v))
                for k, v in tree.items()}

    @property
    def compile_count(self) -> int:
        """Distinct (batch shape, dtype) signatures run so far."""
        return len(self._signatures)

    @property
    def last_batch_compiled(self) -> bool:
        """True when the most recent ``predict_batch`` ran a new signature
        (its wall time includes cuDNN's per-shape setup — keep it out of
        latency reservoirs)."""
        return self._last_compiled

    def is_warm(self, batch: Batch) -> bool:
        """True when ``batch``'s (shape, dtype) signature has run here or
        is bundled (an AOT hit)."""
        sig = (tuple(batch.image.shape), str(batch.image.dtype))
        return sig in self._aot or sig in self._signatures

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """The served forward of a normalised device batch (NHWC)."""
        if self._functional:
            weights = dequantize_tree(self.params, self.serve_dtype)
            return torch.func.functional_call(
                self.model, weights, (image,),
                {"compute_dtype": self.compute_dtype})
        return self.model(image, compute_dtype=self.compute_dtype)

    def _put_batch(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def predict_batch(self, batch: Batch, *, want_density: bool = False
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Run one padded batch; returns host (counts (B,), masked density
        (B, h, w, 1) f32 or None).  The density map is copied to the host
        only when a request asked for it."""
        if self.released:
            raise RuntimeError("serve engine buffers released — build a "
                               "fresh engine to serve again")
        sig = (tuple(batch.image.shape), str(batch.image.dtype))
        if sig in self._aot:
            # a bundled signature: no first-seen signature, no compile event
            self.aot_hits += 1
            first = False
        else:
            first = sig not in self._signatures
            self._signatures.add(sig)
        self._last_compiled = first
        # a new signature's first call runs inside the cost ledger's
        # counting scope when one rides the bus (obs/costs.py)
        ledger = (getattr(self.telemetry, "ledger", None)
                  if first and self.telemetry is not None else None)
        scope = None
        t0 = time.perf_counter()
        with self._lock, torch.inference_mode():
            t = {"image": self._put_batch(batch.image),
                 "dmap": self._put_batch(batch.dmap),
                 "pixel_mask": self._put_batch(batch.pixel_mask),
                 "sample_mask": self._put_batch(batch.sample_mask)}
            with (count_costs() if ledger is not None
                  else contextlib.nullcontext()) as scope:
                image = normalize_on_device(t["image"], t["pixel_mask"])
                pred = self.forward(image)
                counts, _ = density_counts(pred, t)
            density = None
            if want_density:
                mask = t["pixel_mask"] * t["sample_mask"][:, None, None, None]
                density = (pred.float() * mask).cpu().numpy()
            counts = counts.cpu().numpy()
        if first and self.telemetry is not None:
            fields = {k: getattr(batch, k) for k in
                      ("image", "dmap", "pixel_mask", "sample_mask")}
            sig = batch_signature(fields)
            payload = dict(name=self.name, signature=[list(s) for s in sig],
                           seconds=round(time.perf_counter() - t0, 4),
                           n_signatures=len(self._signatures))
            if ledger is not None:
                cost = ledger.register(self.name, sig, cost=scope.totals())
                if cost is not None:
                    payload.update(cost)
            self.telemetry.emit("compile", **payload)
        return counts, density

    def swap_params(self, state_dict, *, quantized: bool = False) -> None:
        """Replace the served weights (the blue/green flip).  The new tree
        must match the serving tree's signature exactly — names, shapes,
        dtypes — so every warmed shape serves the new weights with no new
        signature; a mismatch raises ``ValueError``.  The flip waits for a
        running launch and happens between two launches."""
        if self.released:
            raise RuntimeError("serve engine buffers released — build a "
                               "fresh engine to serve again")
        storage = (state_dict if quantized
                   else quantize_tree(state_dict, self.serve_dtype))
        params = self._put(storage)
        if tree_signature(params) != self._signature:
            raise ValueError(SWAP_MISMATCH)
        with self._lock:
            if not self._functional:
                self.model.load_state_dict(params, strict=True, assign=True)
            self.params = params

    def release_buffers(self) -> None:
        """Drop the device-resident weights and the AOT table (idempotent);
        a released engine refuses ``predict_batch``."""
        self.model = None
        self.params = None
        self._aot = {}
        self.released = True
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def warmup(self, bucket_shapes, max_batch: int, *,
               dtypes=(np.float32,), sizes=None) -> dict:
        """Run one zero batch for every (bucket shape, launch size, image
        dtype) before traffic.  ``sizes``: the launch-size menu
        (``sched``) — every size the batcher may dispatch must be warmed
        here; None keeps the single ``max_batch`` size.  Returns
        ``{"shapes", "sizes", "compiles" (new signatures), "seconds"}``."""
        t0 = time.perf_counter()
        before = self.compile_count
        shapes = sorted(set(map(tuple, bucket_shapes)))
        sizes = normalize_sizes(max_batch, sizes)
        for bh, bw in shapes:
            if bh % self.ds or bw % self.ds:
                raise ValueError(f"bucket shape {bh}x{bw} is not a multiple "
                                 f"of the density downsample ({self.ds})")
            for size in sizes:
                for dt in dtypes:
                    img = np.zeros((bh, bw, 3), dt)
                    dm = np.zeros((bh // self.ds, bw // self.ds, 1),
                                  np.float32)
                    self.predict_batch(pad_batch([(img, dm)], (bh, bw), size,
                                                 [False], self.ds))
        report = {"shapes": len(shapes), "sizes": len(sizes),
                  "compiles": self.compile_count - before,
                  "seconds": round(time.perf_counter() - t0, 3)}
        if self.telemetry is not None:
            self.telemetry.emit("serve.warmup", **report)
        return report
