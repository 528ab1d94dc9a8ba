"""CANNet (CVPR'19 Context-Aware Crowd Counting) as a PyTorch module.

Counterpart of ``can_tpu/models/cannet.py`` (``cannet_apply`` :152,
``context_block`` :278, ``_batch_norm`` :312), plain and BN variants:

* VGG-16 frontend: 10 conv+ReLU, 3 maxpools -> 1/8 resolution, 512 ch;
* context block: for S in (1, 2, 3, 6) adaptive-avg-pool to S x S, biasless
  1x1 conv, align-corners upsample, gate = sigmoid(1x1(sm - fv));
  fi = sum(gate * sm) / (sum(gate) + 1e-12); concat(fv, fi) -> 1024 ch;
* backend: 6 dilation-2 3x3 convs + a 1x1 output conv -> (N, H/8, W/8, 1);
* ``batch_norm=True`` (the ``--syncBN`` model): a BatchNorm after each of
  the 16 frontend/backend convs, normalised by ``_batch_norm`` — masked
  moments through the ``bn_ops`` seam (``ops/bn_moments.py``), never
  ``F.batch_norm``, which cannot mask bucket padding and fill slots.

The parameters carry the reference ``state_dict`` layout of
``make_layers(batch_norm=...)`` (plain: ``frontend.{0,2,5,...}``; BN:
conv, BatchNorm2d, ReLU per entry, so ``frontend.{0,1,3,4,7,8,...}``),
``output_layer`` and ``conv{s}_{1,2}``, so a reference ``.pth`` loads with
``strict=True``.  The forward takes and returns NHWC; the context tail
goes through the ``context_fused`` seam, which by default is
``ops.cuda_context``: the CUDA kernel on a CUDA tensor, its plain version
on a CPU tensor.  In train mode the BN running statistics are updated in
place under ``no_grad`` (the PyTorch idiom for the JAX package's returned
``new_stats``).
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from can_tpu_torch.ops.bn_moments import BNOps
from can_tpu_torch.ops.conv import (
    conv1x1,
    conv2d,
    depth_to_space,
    fold_stem_kernel,
    space_to_depth,
)
from can_tpu_torch.ops.cuda_context import make_fused_context
from can_tpu_torch.ops.pooling import adaptive_avg_pool2d, max_pool2d

FRONTEND_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
BACKEND_CFG = (512, 512, 512, 256, 128, 64)
CONTEXT_SCALES = (1, 2, 3, 6)
FEAT_CH = 512


BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _make_layers(cfg, in_channels: int, dilation: int,
                 batch_norm: bool = False) -> nn.Sequential:
    """The reference ``make_layers``: conv(+BatchNorm)+ReLU per entry,
    MaxPool per 'M' (these Sequential indices ARE the state-dict keys)."""
    layers = []
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2d(in_channels, v, 3, padding=dilation,
                                    dilation=dilation))
            if batch_norm:
                layers.append(nn.BatchNorm2d(v))
            layers.append(nn.ReLU(inplace=True))
            in_channels = v
    return nn.Sequential(*layers)


class CANNet(nn.Module):
    """CANNet, plain or with BatchNorm.

    device/dtype: where and in what dtype the parameters live.
    seed: an int initialises the weights from ``random_state_dict(seed)``
    (N(0, 0.01), zero biases — the reference init; BN scale 1, bias 0,
    running mean 0, var 1); None leaves them uninitialised for a
    ``load_state_dict`` to fill.
    batch_norm: the BN variant (``make_layers(batch_norm=True)``).
    context_fused: replaces the context-tail seam ``(fv, aves, weights,
    hw) -> fi``; None keeps ``ops.cuda_context``'s (the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor).
    s2d_stem: the first frontend conv runs as
    ``depth_to_space(conv2d(space_to_depth(x), w', b'))`` with the folded
    kernel (``ops.conv.fold_stem_kernel``): the plain stem up to
    summation order, trained through the original weights.
    """

    def __init__(self, *, device=None, dtype=torch.float32,
                 seed: Optional[int] = 0, batch_norm: bool = False,
                 context_fused=None, s2d_stem: bool = False):
        super().__init__()
        self.batch_norm = bool(batch_norm)
        self.s2d_stem = bool(s2d_stem)
        # built on the meta device: no storage, no draw from the global RNG
        with torch.device("meta"):
            self.frontend = _make_layers(FRONTEND_CFG, 3, 1, batch_norm)
            self.backend = _make_layers(BACKEND_CFG, 2 * FEAT_CH, 2, batch_norm)
            self.output_layer = nn.Conv2d(BACKEND_CFG[-1], 1, kernel_size=1)
            for s in CONTEXT_SCALES:
                for j in (1, 2):
                    setattr(self, f"conv{s}_{j}",
                            nn.Conv2d(FEAT_CH, FEAT_CH, 1, bias=False))
        self.to_empty(device=device or "cpu")
        self.to(dtype)
        if seed is not None:
            self.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                                  random_state_dict(seed, batch_norm=batch_norm)
                                  .items()})
        self.context_fused = context_fused or make_fused_context()
        # the frontend's remat segments: each stage ends at its max-pool
        stages, cur = [], []
        for layer in self.frontend:
            cur.append(layer)
            if isinstance(layer, nn.MaxPool2d):
                stages.append(cur)
                cur = []
        self._stages = stages + [cur]

    def context_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The context 1x1s as the JAX package's (Cin, Cout) matrices:
        ``{"s1": {"ave": ..., "weight": ...}, ...}`` (views, no copy)."""
        return {f"s{s}": {
            "ave": getattr(self, f"conv{s}_1").weight[:, :, 0, 0].t(),
            "weight": getattr(self, f"conv{s}_2").weight[:, :, 0, 0].t()}
            for s in CONTEXT_SCALES}

    def forward(self, x: torch.Tensor, *, train: bool = False,
                pixel_mask: Optional[torch.Tensor] = None,
                sample_mask: Optional[torch.Tensor] = None,
                bn_ops: Optional[BNOps] = None,
                compute_dtype=None, remat: bool = False,
                bn_axes=None, bn_shards: int = 1) -> torch.Tensor:
        """(N, H, W, 3) NHWC image batch -> (N, H/8, W/8, 1) density map,
        computed in ``compute_dtype`` (default: x's dtype).

        BN model only: ``train`` takes the batch moments (through
        ``bn_ops``; None = two-pass) and updates the running statistics in
        place, once, after the forward; otherwise the running statistics
        normalise.  ``pixel_mask`` ((N, H/8, W/8, 1)) and ``sample_mask``
        ((N,)) restrict the train-mode moments to real pixels of real
        images: the /8 mask is upsampled by 8 and subsampled by each
        max-pool (valid regions are /8-snapped, so this is exact).
        ``bn_axes`` (SyncBN): the process group the train-mode moments are
        summed over (``parallel.runtime.process_group()``), None for the
        local batch; ``bn_shards`` is its size, for the unmasked
        moments' unbiased correction (the masked path counts the global
        valid pixels itself).

        ``remat`` (with gradients enabled): each segment — the frontend's
        four stages, each ending at its max-pool, the context block and
        the backend — runs under ``torch.utils.checkpoint``, so the
        backward keeps only the segments' inputs and recomputes the rest
        one segment at a time.  The recompute takes the same batch moments
        (under SyncBN it all-reduces them again, inside the backward) and
        leaves the running statistics alone: the updates a segment returns
        are applied after the forward, from its first run only.
        """
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        dt = x.dtype
        masks = [None] * len(self._stages)
        if self.batch_norm and train and pixel_mask is not None:
            m8 = pixel_mask.float()
            if sample_mask is not None:
                m8 = m8 * sample_mask.float()[:, None, None, None]
            ds = x.shape[-3] // m8.shape[-3]  # 8 at input resolution
            masks[0] = m8.repeat_interleave(ds, dim=-3).repeat_interleave(ds, dim=-2)
            for i in range(1, len(masks)):
                # contiguous once here, not in each BN layer's kernel call
                masks[i] = masks[i - 1][:, ::2, ::2, :].contiguous()

        def run(fn, *args):
            if remat and torch.is_grad_enabled():
                # the model has no random op: no RNG state to carry
                return checkpoint(fn, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return fn(*args)

        stack = functools.partial(self._stack, dt=dt, train=train, bn_ops=bn_ops,
                                  bn_axes=bn_axes, bn_shards=bn_shards)
        updates = []
        for stage, mask in zip(self._stages, masks):
            x, ups = run(stack, stage, x, mask)
            updates += ups
        x = run(self._context, x)
        # at /8 the mask is back at pixel_mask resolution
        x, ups = run(stack, self.backend, x, masks[-1])
        updates += ups
        if updates:
            with torch.no_grad():
                for layer, new in updates:
                    layer.running_mean.copy_(new["mean"])
                    layer.running_var.copy_(new["var"])
                    layer.num_batches_tracked += 1
        return x

    def _context(self, fv):
        """The context block and the concatenation: (fv, fi)."""
        fi = context_block(self.context_params(), fv,
                           context_fused=self.context_fused)
        return torch.cat([fv, fi], dim=-1)

    def _stack(self, layers, x, bn_mask, *, dt, train, bn_ops, bn_axes,
               bn_shards):
        """A frontend stage or the backend (with the output conv), one
        remat segment: returns ``(x, [(BatchNorm2d, new stats), ...])``."""
        dilation = 2 if layers is self.backend else 1
        updates = []
        for layer in layers:
            if isinstance(layer, nn.Conv2d):
                if self.s2d_stem and layer is self.frontend[0]:
                    wp, bp = fold_stem_kernel(layer.weight.to(dt),
                                              layer.bias.to(dt))
                    x = depth_to_space(conv2d(space_to_depth(x), wp, bp))
                else:
                    x = conv2d(x, layer.weight.to(dt), layer.bias.to(dt),
                               dilation=dilation)
            elif isinstance(layer, nn.BatchNorm2d):
                stats = {"mean": layer.running_mean, "var": layer.running_var}
                x, new = _batch_norm(x, {"scale": layer.weight,
                                         "bias": layer.bias},
                                     stats, train, BN_MOMENTUM, mask=bn_mask,
                                     bn_ops=bn_ops, axes=bn_axes,
                                     n_shards=bn_shards)
                if new is not None:
                    updates.append((layer, new))
            elif isinstance(layer, nn.ReLU):
                x = F.relu(x, inplace=True)
            elif isinstance(layer, nn.MaxPool2d):
                x = max_pool2d(x)
        if layers is self.backend:
            p = self.output_layer
            x = conv2d(x, p.weight.to(dt), p.bias.to(dt), padding=0)
        return x, updates


def _batch_norm(y, bn_params: Mapping, stats: Optional[Mapping], train: bool,
                momentum: float, eps: float = BN_EPS, *, axes=None,
                n_shards: int = 1, mask=None, bn_ops: Optional[BNOps] = None):
    """torch-semantics BatchNorm2d over NHWC (``_batch_norm`` of
    can_tpu/models/cannet.py:312): train mode normalises with the biased
    batch variance and returns running stats updated with the unbiased
    one; eval mode normalises with ``stats``.  Returns ``(out, updated)``
    (``updated`` None in eval mode, detached otherwise).

    * moments in f32 at least (bf16 and f32 inputs take f32, f64 keeps
      f64), normalised in that dtype, cast back to y's dtype;
    * ``mask`` ((N, h, w, 1) validity weights): moments are weighted sums
      over the weighted count s0, floored at 1 (an all-fill batch gives
      mean = var = 0, not NaN), unbiased by ``s0 / (s0 - 1)``, and an
      all-fill batch (s0 = 0) leaves the running stats unchanged;
    * ``bn_ops`` picks how the masked moments are reduced (two-pass when
      None); ``axes`` is the process group the moments are summed over
      (SyncBN, ``ops/bn_moments.py``) or None, and ``n_shards`` its size:
      the unmasked moments' unbiased correction counts the global pixels
      (the masked path's s0 is already global).
    """
    acc = torch.float64 if y.dtype == torch.float64 else torch.float32
    yf = y.to(acc)
    updated = None
    if train:
        if bn_ops is None:
            bn_ops = BNOps()
        if mask is not None:
            m = mask.to(acc)
            # y in its own dtype: the kernel reads bf16 as it is
            mean, var, s0 = bn_ops.masked_moments(y, m, axes)
            unbiased = var * (s0 / torch.clamp(s0 - 1.0, min=1.0))
            momentum = momentum * (s0 > 0.0).to(acc)
        elif axes:
            mean, var = bn_ops.global_moments(yf, axes)
        else:
            mean = torch.mean(yf, dim=(0, 1, 2))
            var = torch.var(yf, dim=(0, 1, 2), unbiased=False)
        if mask is None:
            n = y.shape[0] * y.shape[1] * y.shape[2] * n_shards
            unbiased = var * (n / max(n - 1, 1))
        with torch.no_grad():
            if stats is not None:
                updated = {
                    "mean": (1 - momentum) * stats["mean"] + momentum * mean,
                    "var": (1 - momentum) * stats["var"] + momentum * unbiased,
                }
            else:
                updated = {"mean": mean.detach(), "var": unbiased.detach()}
    else:
        mean, var = stats["mean"], stats["var"]
    inv = torch.rsqrt(var + eps)
    out = (yf - mean) * inv * bn_params["scale"].to(acc)
    out = out + bn_params["bias"].to(acc)
    return out.to(y.dtype), updated


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


def load_vgg16_frontend(model: CANNet, npz_path: str) -> CANNet:
    """Copy pretrained VGG-16 conv weights into the 10 frontend convs, in
    place (``load_vgg16_frontend`` of can_tpu/models/cannet.py:392).  The
    ``.npz`` is ``tools/convert_vgg16.py``'s: keys ``conv{i}_w`` (HWIO)
    and ``conv{i}_b`` for i in 0..9.  Shapes are checked in HWIO, with the
    JAX loader's errors; a BN model's BatchNorm parameters and running
    statistics are left alone.  Returns the model."""
    data = np.load(npz_path)
    convs = [m for m in model.frontend if isinstance(m, nn.Conv2d)]
    with torch.no_grad():
        for i, conv in enumerate(convs):
            w = np.asarray(data[f"conv{i}_w"])
            b = np.asarray(data[f"conv{i}_b"])
            want_w = tuple(conv.weight.permute(2, 3, 1, 0).shape)
            if w.shape != want_w:
                raise ValueError(f"conv{i}: npz shape {w.shape} != expected {want_w}")
            if b.shape != tuple(conv.bias.shape):
                raise ValueError(f"conv{i}: bias shape {b.shape} != expected "
                                 f"{tuple(conv.bias.shape)}")
            conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(b))
    return model


def reference_param_shapes(batch_norm: bool = False) -> Dict[str, tuple]:
    """Reference state-dict keys -> shapes (OIHW; BN vectors; () for
    ``num_batches_tracked``), in registration order (frontend, backend,
    output, conv{s}_{j})."""
    return {k: tuple(v.shape) for k, v in
            CANNet(device="meta", seed=None, batch_norm=batch_norm)
            .state_dict().items()}


def _bn_prefixes(batch_norm: bool) -> set:
    """State-dict prefixes (``frontend.1.`` ...) of the BatchNorm layers."""
    if not batch_norm:
        return set()
    model = CANNet(device="meta", seed=None, batch_norm=True)
    return {f"{name}." for name, mod in model.named_modules()
            if isinstance(mod, nn.BatchNorm2d)}


def random_state_dict(seed: int, *, he: bool = False,
                      batch_norm: bool = False) -> Dict[str, np.ndarray]:
    """Reference-layout weights from a numpy seed (f32; int64 for
    ``num_batches_tracked``).

    Default: N(0, 0.01) with zero biases, the reference init
    (model/CANNet.py:93-101).  Its activations shrink layer by layer (the
    feature map reaches ~1e-7, every gate is sigmoid(0) = 0.5), so
    ``he=True`` rescales the same normals to N(0, 2 / fan_in) for the
    convs and N(0, 1 / C) for the context 1x1s, with biases 0.01: O(1)
    activations end to end, gates that vary, counts of order one and up.
    ``batch_norm=True``: the BN layout, with torch's BatchNorm2d defaults
    (scale 1, bias 0, running mean 0, var 1, 0 batches tracked); the convs
    draw the same normals in the same order as the plain model's.
    """
    rng = np.random.default_rng(seed)
    bn = _bn_prefixes(batch_norm)
    out = {}
    for k, shape in reference_param_shapes(batch_norm).items():
        prefix, leaf = k.rsplit(".", 1)
        if prefix + "." in bn:
            out[k] = {"weight": np.ones(shape, np.float32),
                      "bias": np.zeros(shape, np.float32),
                      "running_mean": np.zeros(shape, np.float32),
                      "running_var": np.ones(shape, np.float32),
                      "num_batches_tracked": np.zeros(shape, np.int64)}[leaf]
            continue
        if leaf == "bias":
            out[k] = np.full(shape, 0.01 if he else 0.0, np.float32)
            continue
        std = 0.01
        if he:
            fan_in = int(np.prod(shape[1:]))
            std = np.sqrt((1.0 if k.startswith("conv") else 2.0) / fan_in)
        out[k] = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return out
