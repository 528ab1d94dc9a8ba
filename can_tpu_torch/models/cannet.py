"""CANNet (CVPR'19 Context-Aware Crowd Counting) as a PyTorch module.

Counterpart of ``can_tpu/models/cannet.py`` (``cannet_apply`` :152,
``context_block`` :278) for the plain, non-BN model:

* VGG-16 frontend: 10 conv+ReLU, 3 maxpools -> 1/8 resolution, 512 ch;
* context block: for S in (1, 2, 3, 6) adaptive-avg-pool to S x S, biasless
  1x1 conv, align-corners upsample, gate = sigmoid(1x1(sm - fv));
  fi = sum(gate * sm) / (sum(gate) + 1e-12); concat(fv, fi) -> 1024 ch;
* backend: 6 dilation-2 3x3 convs + a 1x1 output conv -> (N, H/8, W/8, 1).

The parameters carry the reference ``state_dict`` layout
(``frontend.{0,2,5,...}``, ``backend.{0,2,...}``, ``output_layer``,
``conv{s}_{1,2}``), so a reference ``.pth`` loads with ``strict=True``.
The forward takes and returns NHWC; the context tail goes through the
``context_fused`` seam, which by default is ``ops.cuda_context``: the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from can_tpu_torch.ops.conv import conv1x1, conv2d
from can_tpu_torch.ops.cuda_context import make_fused_context
from can_tpu_torch.ops.pooling import adaptive_avg_pool2d, max_pool2d

FRONTEND_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
BACKEND_CFG = (512, 512, 512, 256, 128, 64)
CONTEXT_SCALES = (1, 2, 3, 6)
FEAT_CH = 512


def _make_layers(cfg, in_channels: int, dilation: int) -> nn.Sequential:
    """The reference ``make_layers``: conv+ReLU per entry, MaxPool per 'M'
    (these Sequential indices ARE the state-dict keys)."""
    layers = []
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers += [nn.Conv2d(in_channels, v, 3, padding=dilation,
                                 dilation=dilation), nn.ReLU(inplace=True)]
            in_channels = v
    return nn.Sequential(*layers)


class CANNet(nn.Module):
    """The plain CANNet.

    device/dtype: where and in what dtype the parameters live.
    seed: an int initialises the weights from ``random_state_dict(seed)``
    (N(0, 0.01), zero biases — the reference init); None leaves them
    uninitialised for a ``load_state_dict`` to fill.
    context_fused: replaces the context-tail seam ``(fv, aves, weights,
    hw) -> fi``; None keeps ``ops.cuda_context``'s (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor).
    """

    def __init__(self, *, device=None, dtype=torch.float32,
                 seed: Optional[int] = 0, context_fused=None):
        super().__init__()
        # built on the meta device: no storage, no draw from the global RNG
        with torch.device("meta"):
            self.frontend = _make_layers(FRONTEND_CFG, 3, 1)
            self.backend = _make_layers(BACKEND_CFG, 2 * FEAT_CH, 2)
            self.output_layer = nn.Conv2d(BACKEND_CFG[-1], 1, kernel_size=1)
            for s in CONTEXT_SCALES:
                for j in (1, 2):
                    setattr(self, f"conv{s}_{j}",
                            nn.Conv2d(FEAT_CH, FEAT_CH, 1, bias=False))
        self.to_empty(device=device or "cpu")
        self.to(dtype)
        if seed is not None:
            self.load_state_dict({k: torch.from_numpy(v) for k, v in
                                  random_state_dict(seed).items()})
        self.context_fused = context_fused or make_fused_context()

    def context_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The context 1x1s as the JAX package's (Cin, Cout) matrices:
        ``{"s1": {"ave": ..., "weight": ...}, ...}`` (views, no copy)."""
        return {f"s{s}": {
            "ave": getattr(self, f"conv{s}_1").weight[:, :, 0, 0].t(),
            "weight": getattr(self, f"conv{s}_2").weight[:, :, 0, 0].t()}
            for s in CONTEXT_SCALES}

    def forward(self, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
        """(N, H, W, 3) NHWC image batch -> (N, H/8, W/8, 1) density map,
        computed in ``compute_dtype`` (default: x's dtype)."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        dt = x.dtype
        for layer in self.frontend:
            if isinstance(layer, nn.Conv2d):
                x = F.relu(conv2d(x, layer.weight.to(dt), layer.bias.to(dt)),
                           inplace=True)
            elif isinstance(layer, nn.MaxPool2d):
                x = max_pool2d(x)
        fv = x
        fi = context_block(self.context_params(), fv,
                           context_fused=self.context_fused)
        x = torch.cat([fv, fi], dim=-1)
        for layer in self.backend:
            if isinstance(layer, nn.Conv2d):
                x = F.relu(conv2d(x, layer.weight.to(dt), layer.bias.to(dt),
                                  dilation=2), inplace=True)
        p = self.output_layer
        return conv2d(x, p.weight.to(dt), p.bias.to(dt), padding=0)


def context_block(cparams: Mapping, fv: torch.Tensor, *,
                  context_fused) -> torch.Tensor:
    """Multi-scale context fusion (``can_tpu`` cannet.py:278):
    fi = sum_k gate_k * sm_k / (sum_k gate_k + 1e-12), with
    sm_k = upsample(1x1(adaptive_pool(fv, k))) and
    gate_k = sigmoid(1x1(sm_k - fv)).

    cparams: ``{"s{k}": {"ave": (C, C), "weight": (C, C)}}`` (Cin, Cout).
    ``context_fused`` (the seam, ``ops.cuda_context.make_fused_context``)
    computes everything after the per-scale pooled projections, which are
    tiny and stay outside.
    """
    hw = (fv.shape[1], fv.shape[2])
    aves = [conv1x1(adaptive_avg_pool2d(fv, s),
                    cparams[f"s{s}"]["ave"].to(fv.dtype))
            for s in CONTEXT_SCALES]
    weights = [cparams[f"s{s}"]["weight"].to(fv.dtype) for s in CONTEXT_SCALES]
    return context_fused(fv, aves, weights, hw)


def reference_param_shapes() -> Dict[str, tuple]:
    """Reference state-dict keys -> shapes (OIHW), in registration order
    (frontend, backend, output, conv{s}_{j})."""
    return {k: tuple(v.shape) for k, v in
            CANNet(device="meta", seed=None).state_dict().items()}


def random_state_dict(seed: int, *, he: bool = False) -> Dict[str, np.ndarray]:
    """Reference-layout f32 weights from a numpy seed.

    Default: N(0, 0.01) with zero biases, the reference init
    (model/CANNet.py:93-101).  Its activations shrink layer by layer (the
    feature map reaches ~1e-7, every gate is sigmoid(0) = 0.5), so
    ``he=True`` rescales the same normals to N(0, 2 / fan_in) for the
    convs and N(0, 1 / C) for the context 1x1s, with biases 0.01: O(1)
    activations end to end, gates that vary, counts of order one and up.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in reference_param_shapes().items():
        if k.endswith(".bias"):
            out[k] = np.full(shape, 0.01 if he else 0.0, np.float32)
            continue
        std = 0.01
        if he:
            fan_in = int(np.prod(shape[1:]))
            std = np.sqrt((1.0 if k.startswith("conv") else 2.0) / fan_in)
        out[k] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return out
