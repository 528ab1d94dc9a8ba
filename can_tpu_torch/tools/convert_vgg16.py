"""Convert pretrained VGG-16 conv weights to the frontend ``.npz``
(counterpart of ``tools/convert_vgg16.py``)::

    python -m can_tpu_torch.tools.convert_vgg16 --pth vgg16.pth --out vgg16_frontend.npz

The reference copies the first 20 tensors of torchvision's ``vgg16``
(10 conv weight and bias pairs) into the frontend by ordinal position
(model/CANNet.py:26-35).  This tool does that conversion once, offline:
a torchvision ``vgg16`` state dict (``features.{k}.weight`` OIHW) becomes
``conv{i}_w`` (HWIO) and ``conv{i}_b`` for i in 0..9, the layout
``can_tpu_torch.models.load_vgg16_frontend`` (and the JAX package's
loader) reads.  The key order and shapes of the dict's first 20 tensors
are checked against ``vgg16_manifest.json`` beside this module (a copy of
the JAX tool's manifest), with the JAX tool's drift error.

``--pth`` is the only source: the JAX tool's second source, a torchvision
download, has no counterpart here (the port fetches nothing from the
network); save ``torchvision.models.vgg16(weights=...).state_dict()``
with ``torch.save`` where torchvision is installed and pass that file.
"""

from __future__ import annotations

import argparse
import json
import os
from itertools import zip_longest

import numpy as np

from can_tpu_torch.utils.torch_import import FRONTEND_SEQ_IDX as VGG16_CONV_FEATURE_IDX

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "vgg16_manifest.json")


def validate_against_manifest(state_dict) -> None:
    """The dict's first 20 (key, shape) pairs must be the manifest's, in
    order: the reference's ordinal copy would otherwise load the wrong
    tensors.  Raises ``ValueError`` naming every drifted position (a
    truncated dict names its missing positions too)."""
    with open(MANIFEST_PATH) as f:
        manifest = json.load(f)["entries"][:20]  # the copied frontend slice
    got = [(k, list(np.asarray(v).shape)) for k, v in
           list(state_dict.items())[:20]]
    want = [(e["key"], e["shape"]) for e in manifest]
    if got != want:
        drift = [f"  pos {i}: got {g}, manifest {w}"
                 for i, (g, w) in enumerate(zip_longest(got, want,
                                                        fillvalue="<absent>"))
                 if g != w]
        raise ValueError(
            "state dict's first 20 tensors do not match the pinned "
            "torchvision vgg16 layout (tools/vgg16_manifest.json) — the "
            "ordinal copy the reference relies on would load the WRONG "
            "tensors:\n" + "\n".join(drift))


def state_dict_to_npz_arrays(state_dict) -> dict:
    """torchvision vgg16 state dict (numpy arrays or tensors) ->
    ``{conv{i}_w (HWIO), conv{i}_b}`` f32 arrays."""
    validate_against_manifest(state_dict)
    out = {}
    for i, k in enumerate(VGG16_CONV_FEATURE_IDX):
        w = np.asarray(state_dict[f"features.{k}.weight"], dtype=np.float32)
        b = np.asarray(state_dict[f"features.{k}.bias"], dtype=np.float32)
        if w.ndim != 4:
            raise ValueError(f"features.{k}.weight has ndim {w.ndim}, want 4")
        out[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO
        out[f"conv{i}_b"] = b
    return out


def load_state_dict(path: str) -> dict:
    """A ``torch.save``d vgg16 state dict (or a module holding one) as
    numpy arrays, in the file's key order."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="torchvision vgg16 state dict -> the CANNet frontend .npz")
    ap.add_argument("--out", default="vgg16_frontend.npz")
    ap.add_argument("--pth", required=True,
                    help="torch.save'd torchvision vgg16 state dict (.pth); "
                         "there is no download source")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.isfile(args.pth):
        raise SystemExit(f"no such file: {args.pth}")
    arrays = state_dict_to_npz_arrays(load_state_dict(args.pth))
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: " +
          ", ".join(f"{k}{v.shape}" for k, v in sorted(arrays.items())[:4]) + ", ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
