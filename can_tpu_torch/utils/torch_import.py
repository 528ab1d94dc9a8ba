"""Load CANNet weights into the port's reference-layout ``state_dict``.

Counterpart of ``can_tpu/utils/torch_import.py``.  The port's ``CANNet``
carries the reference parameter layout itself, so a reference ``.pth``
needs no conversion, only validation: the DDP ``module.`` prefix is
stripped, ``{"state_dict": ...}`` / ``{"model": ...}`` wrappers are
unwrapped, and the key set and every shape must match exactly (a
silently partial import would reproduce nothing).

Either layout validates: the plain model's and the BN model's
(``make_layers(batch_norm=True)``: conv, BatchNorm2d, ReLU per entry);
the layout is told by the presence of BatchNorm keys.

Two other sources are converted from the JAX package's layouts:

* ``.npz`` files written by ``can_tpu.utils.torch_import.save_params_npz``
  (keys ``frontend.{i}.w`` HWIO, ``context.s{s}.ave`` (Cin, Cout), ...);
* ``state_dict_from_jax_params``: the JAX params tree (``cannet_init``'s
  structure, BN variant included) and its ``batch_stats`` as numpy arrays
  — HWIO -> OIHW, (Cin, Cout) -> (Cout, Cin, 1, 1), ``bn.scale``/``bn.bias``
  -> ``weight``/``bias``, ``mean``/``var`` -> ``running_mean``/
  ``running_var``.  It is the weights carry-over of every parity test;
  ``int8_state_dict_from_jax`` carries JAX's int8 serving tree over the
  same way (``q`` transposed, ``scale`` kept).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from can_tpu_torch.models.cannet import CONTEXT_SCALES, reference_param_shapes

# Sequential indices of the conv layers inside each make_layers stack
# (plain: conv, ReLU per entry; BN: conv, BatchNorm2d, ReLU — each BN at
# its conv's index + 1).
FRONTEND_SEQ_IDX: Tuple[int, ...] = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
BACKEND_SEQ_IDX: Tuple[int, ...] = (0, 2, 4, 6, 8, 10)
FRONTEND_BN_SEQ_IDX: Tuple[int, ...] = (0, 3, 7, 10, 14, 17, 20, 24, 27, 30)
BACKEND_BN_SEQ_IDX: Tuple[int, ...] = (0, 3, 6, 9, 12, 15)


def _to_f32(v) -> torch.Tensor:
    """Tensor-or-array -> contiguous f32 CPU tensor (half/bf16 checkpoints
    included)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _to_i64(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.int64)
    return torch.from_numpy(np.array(v, dtype=np.int64))


def _strip_prefix(sd: Mapping) -> dict:
    """Drop the DDP ``module.`` prefix if every key carries it."""
    keys = list(sd)
    if keys and all(k.startswith("module.") for k in keys):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def is_batch_norm_layout(sd: Mapping) -> bool:
    """True when the state dict carries BatchNorm running statistics."""
    return any(k.endswith(".running_mean") for k in _strip_prefix(sd))


def check_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Validate a reference-layout state dict, plain or BN; returns CPU
    tensors in registration order (f32; int64 ``num_batches_tracked``).
    Missing/unexpected keys or a shape mismatch raise ValueError naming
    the offenders."""
    sd = _strip_prefix(sd)
    bn = is_batch_norm_layout(sd)
    spec = reference_param_shapes(batch_norm=bn)
    missing = sorted(set(spec) - set(sd))
    unexpected = sorted(set(sd) - set(spec))
    if missing or unexpected:
        raise ValueError(
            f"state dict does not match the reference CANNet "
            f"{'BN ' if bn else ''}layout: "
            f"missing={missing[:6]}{'...' if len(missing) > 6 else ''} "
            f"unexpected={unexpected[:6]}"
            f"{'...' if len(unexpected) > 6 else ''}")
    out = {}
    for k, shape in spec.items():
        t = (_to_i64(sd[k]) if k.endswith(".num_batches_tracked")
             else _to_f32(sd[k]))
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


def _flat_from_jax(params: Mapping, batch_stats: Optional[Mapping],
                   kernel, matrix) -> dict:
    """The JAX params tree -> reference-layout names, the conv kernels
    (HWIO) through ``kernel`` and the context matrices ((Cin, Cout))
    through ``matrix``; every other leaf as it is."""
    bn = "bn" in params["frontend"][0]
    sd = {}
    stacks = (("frontend", FRONTEND_BN_SEQ_IDX if bn else FRONTEND_SEQ_IDX),
              ("backend", BACKEND_BN_SEQ_IDX if bn else BACKEND_SEQ_IDX))
    for group, seq in stacks:
        for i, (k, p) in enumerate(zip(seq, params[group])):
            sd[f"{group}.{k}.weight"] = kernel(p["w"])
            sd[f"{group}.{k}.bias"] = p["b"]
            if bn:
                c = np.asarray(p["b"]).shape[0]
                st = (batch_stats[group][i] if batch_stats is not None else
                      {"mean": np.zeros(c, np.float32),
                       "var": np.ones(c, np.float32)})
                sd[f"{group}.{k + 1}.weight"] = p["bn"]["scale"]
                sd[f"{group}.{k + 1}.bias"] = p["bn"]["bias"]
                sd[f"{group}.{k + 1}.running_mean"] = st["mean"]
                sd[f"{group}.{k + 1}.running_var"] = st["var"]
                sd[f"{group}.{k + 1}.num_batches_tracked"] = np.int64(0)
    sd["output_layer.weight"] = kernel(params["output"]["w"])
    sd["output_layer.bias"] = params["output"]["b"]
    for s in CONTEXT_SCALES:
        cp = params["context"][f"s{s}"]
        sd[f"conv{s}_1.weight"] = matrix(cp["ave"])
        sd[f"conv{s}_2.weight"] = matrix(cp["weight"])
    return sd


def _oihw(w) -> np.ndarray:  # HWIO -> OIHW
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _conv_of_matrix(m) -> np.ndarray:  # (Cin, Cout) -> (Cout, Cin, 1, 1)
    return np.asarray(m).T[:, :, None, None]


def state_dict_from_jax_params(params: Mapping, batch_stats: Optional[Mapping] = None
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's params tree (numpy leaves; HWIO conv kernels,
    (Cin, Cout) context matrices; a ``bn`` entry per conv in the BN model)
    and, for the BN model, its ``batch_stats`` tree (``init_batch_stats``'s
    structure; None = torch's defaults, mean 0 / var 1) -> the port's
    validated state dict."""
    return check_state_dict(_flat_from_jax(
        params, batch_stats,
        lambda w: _oihw(np.asarray(w, np.float32)),
        lambda m: _conv_of_matrix(np.asarray(m, np.float32))))


def int8_state_dict_from_jax(qparams: Mapping,
                             batch_stats: Optional[Mapping] = None) -> dict:
    """The JAX package's int8 storage tree (``can_tpu.serve.quant.
    quantize_tree(params, "int8")`` as numpy; quantised leaves ``{"q":
    int8 (..., Cout), "scale": f32 (Cout,)}``) -> the port's int8 storage
    (``serve/quant.py``): each ``q`` transposed to OIHW (a context
    matrix's to (Cout, Cin, 1, 1)), ``scale`` kept, every other leaf as
    the f32 converter makes it.  Names and shapes are checked against the
    reference layout."""
    def leaf(convert):
        def go(x):
            if isinstance(x, Mapping) and set(x) == {"q", "scale"}:
                return {"q": torch.from_numpy(np.ascontiguousarray(
                            convert(np.asarray(x["q"], np.int8)))),
                        "scale": torch.from_numpy(
                            np.array(x["scale"], np.float32))}
            return convert(np.asarray(x, np.float32))
        return go

    flat = _flat_from_jax(qparams, batch_stats, leaf(_oihw),
                          leaf(_conv_of_matrix))
    spec = reference_param_shapes(batch_norm="bn" in qparams["frontend"][0])
    if set(flat) != set(spec):
        raise ValueError(f"int8 tree does not match the reference layout: "
                         f"missing={sorted(set(spec) - set(flat))[:6]} "
                         f"unexpected={sorted(set(flat) - set(spec))[:6]}")
    out = {}
    for k, shape in spec.items():
        v = flat[k]
        if isinstance(v, dict):
            if tuple(v["q"].shape) != shape or v["scale"].shape != (shape[0],):
                raise ValueError(f"{k}: q {tuple(v['q'].shape)} / scale "
                                 f"{tuple(v['scale'].shape)}, want {shape}")
            out[k] = v
            continue
        t = (_to_i64(v) if k.endswith(".num_batches_tracked")
             else _to_f32(v))
        if tuple(t.shape) != shape:
            raise ValueError(f"{k}: shape {tuple(t.shape)}, want {shape}")
        out[k] = t
    return out


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


def export_state_dict(state_dict: Mapping, *, ddp_prefix: bool = False
                      ) -> Dict[str, np.ndarray]:
    """The port's plain-model state dict -> reference-layout numpy arrays
    in registration order (set ``ddp_prefix`` for the DDP-saved form).
    A BN model is refused: the reference layout has no BatchNorm."""
    sd = check_state_dict(state_dict)
    if is_batch_norm_layout(sd):
        raise ValueError("reference layout has no BatchNorm; "
                         "cannot export a --syncBN model")
    out = {k: v.numpy().copy() for k, v in sd.items()}
    if ddp_prefix:
        out = {f"module.{k}": v for k, v in out.items()}
    return out


def save_torch_checkpoint(state_dict: Mapping, path: str, *,
                          ddp_prefix: bool = False) -> None:
    """``torch.save`` a reference-layout checkpoint of a plain model."""
    torch.save({k: torch.from_numpy(v) for k, v in
                export_state_dict(state_dict, ddp_prefix=ddp_prefix).items()},
               path)


def save_params_npz(state_dict: Mapping, path: str) -> None:
    """Write a plain model as the JAX package's ``save_params_npz`` file
    (keys ``frontend.{i}.w`` HWIO, ``context.s{s}.ave`` (Cin, Cout), ...);
    the inverse of ``load_params_npz``."""
    sd = export_state_dict(state_dict)

    def hwio(w):  # OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))

    flat = {}
    for group, seq in (("frontend", FRONTEND_SEQ_IDX), ("backend", BACKEND_SEQ_IDX)):
        for i, k in enumerate(seq):
            flat[f"{group}.{i}.w"] = hwio(sd[f"{group}.{k}.weight"])
            flat[f"{group}.{i}.b"] = sd[f"{group}.{k}.bias"]
    for s in CONTEXT_SCALES:
        # (Cout, Cin, 1, 1) conv weight -> (Cin, Cout) matmul matrix
        flat[f"context.s{s}.ave"] = np.ascontiguousarray(sd[f"conv{s}_1.weight"][:, :, 0, 0].T)
        flat[f"context.s{s}.weight"] = np.ascontiguousarray(sd[f"conv{s}_2.weight"][:, :, 0, 0].T)
    flat["output.w"] = hwio(sd["output_layer.weight"])
    flat["output.b"] = sd["output_layer.bias"]
    np.savez(path, **flat)
