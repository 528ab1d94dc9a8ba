"""Load CANNet weights into the port's reference-layout ``state_dict``.

Counterpart of ``can_tpu/utils/torch_import.py``.  The port's ``CANNet``
carries the reference parameter layout itself, so a reference ``.pth``
needs no conversion, only validation: the DDP ``module.`` prefix is
stripped, ``{"state_dict": ...}`` / ``{"model": ...}`` wrappers are
unwrapped, and the key set and every shape must match exactly (a
silently partial import would reproduce nothing).

Two other sources are converted from the JAX package's layouts:

* ``.npz`` files written by ``can_tpu.utils.torch_import.save_params_npz``
  (keys ``frontend.{i}.w`` HWIO, ``context.s{s}.ave`` (Cin, Cout), ...);
* ``state_dict_from_jax_params``: the JAX params tree (``cannet_init``'s
  structure) as numpy arrays — HWIO -> OIHW and (Cin, Cout) ->
  (Cout, Cin, 1, 1).  It is the weights carry-over of every parity test.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from can_tpu_torch.models.cannet import CONTEXT_SCALES, reference_param_shapes

# Sequential indices of the conv layers inside each make_layers stack.
FRONTEND_SEQ_IDX: Tuple[int, ...] = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
BACKEND_SEQ_IDX: Tuple[int, ...] = (0, 2, 4, 6, 8, 10)


def _to_f32(v) -> torch.Tensor:
    """Tensor-or-array -> contiguous f32 CPU tensor (half/bf16 checkpoints
    included)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _strip_prefix(sd: Mapping) -> dict:
    """Drop the DDP ``module.`` prefix if every key carries it."""
    keys = list(sd)
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def check_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Validate a reference-layout state dict; returns f32 CPU tensors in
    registration order.  Missing/unexpected keys or a shape mismatch raise
    ValueError naming the offenders."""
    sd = _strip_prefix(sd)
    spec = reference_param_shapes()
    missing = sorted(set(spec) - set(sd))
    unexpected = sorted(set(sd) - set(spec))
    if missing or unexpected:
        raise ValueError(
            "state dict does not match the reference CANNet layout: "
            f"missing={missing[:6]}{'...' if len(missing) > 6 else ''} "
            f"unexpected={unexpected[:6]}"
            f"{'...' if len(unexpected) > 6 else ''}")
    out = {}
    for k, shape in spec.items():
        t = _to_f32(sd[k])
        if tuple(t.shape) != shape:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, want {shape}")
        out[k] = t
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a reference checkpoint (raw state dict, or wrapped in
    ``{"state_dict": ...}`` / ``{"model": ...}``) -> validated state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(wrap), dict):
            obj = obj[wrap]
    return check_state_dict(obj)


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's params tree (numpy leaves; HWIO conv kernels,
    (Cin, Cout) context matrices) -> the port's validated state dict."""

    def oihw(w):  # HWIO -> OIHW
        return np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))

    sd = {}
    for k, p in zip(FRONTEND_SEQ_IDX, params["frontend"]):
        sd[f"frontend.{k}.weight"] = oihw(p["w"])
        sd[f"frontend.{k}.bias"] = p["b"]
    for k, p in zip(BACKEND_SEQ_IDX, params["backend"]):
        sd[f"backend.{k}.weight"] = oihw(p["w"])
        sd[f"backend.{k}.bias"] = p["b"]
    sd["output_layer.weight"] = oihw(params["output"]["w"])
    sd["output_layer.bias"] = params["output"]["b"]
    for s in CONTEXT_SCALES:
        cp = params["context"][f"s{s}"]
        # (Cin, Cout) matmul matrix -> (Cout, Cin, 1, 1) conv weight
        sd[f"conv{s}_1.weight"] = np.asarray(cp["ave"], np.float32).T[:, :, None, None]
        sd[f"conv{s}_2.weight"] = np.asarray(cp["weight"], np.float32).T[:, :, None, None]
    return check_state_dict(sd)


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``save_params_npz`` file (JAX layouts) -> state dict."""
    with np.load(path) as z:
        params = {
            "frontend": [{"w": z[f"frontend.{i}.w"], "b": z[f"frontend.{i}.b"]}
                         for i in range(len(FRONTEND_SEQ_IDX))],
            "context": {f"s{s}": {"ave": z[f"context.s{s}.ave"],
                                  "weight": z[f"context.s{s}.weight"]}
                        for s in CONTEXT_SCALES},
            "backend": [{"w": z[f"backend.{i}.w"], "b": z[f"backend.{i}.b"]}
                        for i in range(len(BACKEND_SEQ_IDX))],
            "output": {"w": z["output.w"], "b": z["output.b"]},
        }
    return state_dict_from_jax_params(params)
