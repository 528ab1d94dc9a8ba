"""Serve-time parameter storage (counterpart of ``can_tpu/serve/quant.py``).

Serving is forward-only, so each ``--serve-dtype`` keeps the parameters
on the card in the format it computes from:

* ``f32``  — identity; the parity mode (TF32 off on the card).
* ``bf16`` — every float parameter stored bf16 and the forward computed
  in bf16 (f32 accumulation inside cuDNN/cuBLAS and the context kernel).
* ``int8`` — post-training weight-only quantisation: conv kernels and the
  context 1x1s stored as int8 with PER-OUTPUT-CHANNEL f32 scales
  (symmetric, scale = max|w| over the input axes / 127).  Biases, BN
  affine parameters, BN running statistics and the 1-channel output conv
  stay f32.  The engine keeps the int8 bytes resident and dequantises
  (``q * scale``) into f32 temporaries for each launch; all arithmetic
  then runs in f32.

Trees here are flat reference-layout state dicts (name -> tensor), OIHW
conv weights.  The JAX package's kernels are HWIO and its context
matrices (Cin, Cout), so its "per output channel" reduces over every axis
but the LAST; here Cout is axis 0 and the reduction runs over the others.
``scale`` and ``q`` are computed on the host in numpy with the same
operations, so ``q`` here is JAX's ``q`` transposed, bit for bit.  A
quantised leaf is the dict ``{"q": int8, "scale": f32 (Cout,)}``.

``parity_report`` grades a mode's worst count delta against f32 on
``PARITY_LADDER``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

SERVE_DTYPES = ("f32", "bf16", "int8")
# BatchNorm buffers (the JAX package's ``batch_stats``): never quantised
RUNNING_STATS = ("running_mean", "running_var")
BN_BUFFERS = RUNNING_STATS + ("num_batches_tracked",)
# the 1x1 output conv stays f32: its error lands directly on the density
# map with nothing downstream to absorb it (JAX's ``output`` path)
OUTPUT_PREFIX = "output_layer."

# Marker key pair of a quantised leaf.
_QKEYS = frozenset({"q", "scale"})

# The count-delta tolerance ladder parity_report grades against (JAX's):
# worst relative count delta vs f32 <= bound -> that rung, strictest first.
PARITY_LADDER = (
    ("exact", 0.0),
    ("tight", 1e-3),
    ("serve", 2e-2),
    ("loose", 1e-1),
)


def _check(serve_dtype: str) -> None:
    if serve_dtype not in SERVE_DTYPES:
        raise ValueError(f"serve_dtype must be one of {SERVE_DTYPES}, "
                         f"got {serve_dtype!r}")


def is_quantized_leaf(node) -> bool:
    return isinstance(node, dict) and frozenset(node.keys()) == _QKEYS


def quantize_int8(w) -> dict:
    """Symmetric per-output-channel int8 of an OIHW (or (Cout, ...))
    weight: scale = max|w| over every axis but the first / 127; all-zero
    channels get scale 1 (q is zero anyway, and a 0 scale would NaN the
    dequantisation).  Host numpy, JAX's operations in JAX's order."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    red = tuple(range(1, w.ndim))
    amax = np.max(np.abs(w), axis=red)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    bshape = (-1,) + (1,) * (w.ndim - 1)
    q = np.clip(np.rint(w / scale.reshape(bshape)), -127, 127).astype(np.int8)
    return {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}


def dequantize_int8(leaf, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` per output channel (axis 0), in ``dtype``."""
    q = leaf["q"]
    scale = leaf["scale"].to(dtype).reshape((-1,) + (1,) * (q.dim() - 1))
    return q.to(dtype) * scale


def _quantizable(name: str, t) -> bool:
    return (isinstance(t, torch.Tensor) and t.dim() >= 2
            and t.is_floating_point() and not name.startswith(OUTPUT_PREFIX))


def quantize_tree(state_dict: Dict[str, torch.Tensor],
                  serve_dtype: str) -> Dict[str, object]:
    """f32 state dict -> the storage dict for ``serve_dtype``.

    f32: identity.  bf16: float tensors bf16, BN running statistics f32
    (JAX's ``batch_stats`` are not quantised either).  int8: every
    weight of ndim >= 2 but the output conv's becomes a quantised leaf;
    1-D tensors (biases, BN affine and statistics) stay f32."""
    _check(serve_dtype)
    if serve_dtype == "f32":
        return dict(state_dict)
    if serve_dtype == "bf16":
        return {k: v.to(torch.bfloat16)
                if v.is_floating_point() and not k.endswith(RUNNING_STATS)
                else v for k, v in state_dict.items()}
    return {k: quantize_int8(v) if _quantizable(k, v)
            else (v.float() if v.is_floating_point() else v)
            for k, v in state_dict.items()}


def dequantize_tree(qtree, serve_dtype: str):
    """Storage tree -> the f32 (or bf16) state dict the forward consumes;
    int8 leaves become f32 temporaries on the leaves' device."""
    if serve_dtype in ("f32", "bf16"):
        return qtree
    return {k: dequantize_int8(v) if is_quantized_leaf(v) else v
            for k, v in qtree.items()}


def compute_dtype_for(serve_dtype: str):
    """The forward's compute dtype: bf16 for bf16; None (f32) for f32 and
    int8, whose dequantised weights are f32."""
    _check(serve_dtype)
    return torch.bfloat16 if serve_dtype == "bf16" else None


def _tensors(leaf) -> tuple:
    return (leaf["q"], leaf["scale"]) if is_quantized_leaf(leaf) else (leaf,)


def host_tree(tree) -> Dict[str, object]:
    """Device tensors -> CPU copies, structure, shapes and dtypes kept
    (int8 leaf dicts and bf16 tensors included, so ``tree_signature`` of
    the copy equals the device tree's)."""
    return {k: ({"q": v["q"].cpu(), "scale": v["scale"].cpu()}
                if is_quantized_leaf(v) else v.cpu())
            for k, v in tree.items()}


def param_bytes(tree) -> int:
    """Parameter bytes of a storage tree: what the mode keeps resident for
    the weights.  BN buffers are left out, as JAX's ``param_bytes`` of
    the params tree leaves out ``batch_stats``."""
    return sum(t.numel() * t.element_size() for k, v in tree.items()
               if not k.endswith(BN_BUFFERS) for t in _tensors(v))


def grade_parity(worst_rel: float) -> str:
    for name, bound in PARITY_LADDER:
        if worst_rel <= bound:
            return name
    return "fail"


def parity_report(engine_q, engine_ref, images: Sequence[np.ndarray], *,
                  max_batch: int = 1, ds: int = 8,
                  ladder=PARITY_LADDER) -> dict:
    """Run ``images`` (prepared HWC arrays) through both engines one item
    per batch; grade the worst relative count delta (relative to
    max(|ref count|, 1)) on ``ladder``."""
    from can_tpu_torch.data.batching import pad_batch

    deltas = []
    for img in images:
        h, w = img.shape[:2]
        dm = np.zeros((h // ds, w // ds, 1), np.float32)
        batch = pad_batch([(img, dm)], (h, w), max_batch, [True], ds)
        cq, _ = engine_q.predict_batch(batch)
        cr, _ = engine_ref.predict_batch(batch)
        ref = float(cr[0])
        deltas.append(abs(float(cq[0]) - ref) / max(abs(ref), 1.0))
    worst = max(deltas) if deltas else 0.0
    return {
        "images": len(deltas),
        "worst_rel_count_delta": round(worst, 8),
        "mean_rel_count_delta": round(float(np.mean(deltas)), 8)
        if deltas else 0.0,
        "ladder": [{"rung": n, "bound": b} for n, b in ladder],
        "grade": grade_parity(worst),
    }
