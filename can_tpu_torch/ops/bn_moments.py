"""BatchNorm batch-moment implementations, selectable by ``--bn-impl``
(counterpart of ``can_tpu/ops/bn_moments.py``).

The train-mode moments of every BN layer (16 in the BN model: 10 frontend
+ 6 backend) are the per-layer reduction ``(B, h, w, C) -> (C,)``:

* ``twopass`` — masked mean first, then the centered second moment
  ``sum((y - mean)^2 * m)``: two reads of the activation, the
  numerically most forgiving form (the default of ``_batch_norm``);
* ``onepass`` — per-channel ``(sum, sumsq, count)`` from one read, packed
  into one ``(2C + 1,)`` vector (the future DDP collective), variance as
  ``E[x^2] - mean^2`` clamped at 0;
* ``kernel`` — the one-pass contract with the local sums from the CUDA
  kernel ``ops/cuda_bn.py`` (the JAX package's ``pallas``).  No shape
  fallback: the kernel takes every C the model has and any h, w.

Sums are accumulated in f32 at least (f64 stays f64): the implementations
take the activation in its own dtype and upcast, so bf16 compute changes
only the values entering the reduction.  The kernel reads bf16 as it is.

One GPU has no collectives: ``axes`` must be empty until the DDP slice
(ROADMAP Queue 1); the packing is kept so the all-reduce slots in there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from can_tpu_torch.ops.cuda_bn import masked_moment_sums, moment_sums

BN_IMPLS = ("twopass", "onepass", "kernel")
COLLECTIVES_MESSAGE = ("cross-device BN moments (axes={axes!r}) come with the "
                       "DDP/SyncBN slice of can_tpu_torch (ROADMAP Queue 1); "
                       "one GPU takes its moments over the local batch")


def _acc(y: torch.Tensor) -> torch.Tensor:
    """y upcast to the accumulator dtype: f32 as a floor, f64 kept."""
    return y.to(torch.float64 if y.dtype == torch.float64 else torch.float32)


def _psum(x: torch.Tensor, axes: Optional[Sequence]) -> torch.Tensor:
    if axes:
        raise NotImplementedError(COLLECTIVES_MESSAGE.format(axes=axes))
    return x


# -- masked moments: (y, m, axes) -> (mean, biased var, global s0) ---------
def masked_moments_twopass(y, m, axes) -> Tuple:
    """Two-pass weighted moments: the mean from one pass over y, the
    centered second moment from a second."""
    yf = _acc(y)
    m = m.to(yf.dtype)
    s0 = _psum(torch.sum(m), axes)
    s1 = _psum(torch.sum(yf * m, dim=(0, 1, 2)), axes)
    den = torch.clamp(s0, min=1.0)
    mean = s1 / den
    ss = _psum(torch.sum(torch.square(yf - mean) * m, dim=(0, 1, 2)), axes)
    return mean, ss / den, s0


def _finish_onepass(s1, s2, s0, axes):
    """Pack the three sums into one vector (one collective under DDP),
    then close the moments."""
    c = s1.shape[-1]
    packed = _psum(torch.cat([s1, s2, s0.reshape(1)]), axes)
    s1, s2, s0 = packed[:c], packed[c:2 * c], packed[2 * c]
    den = torch.clamp(s0, min=1.0)
    mean = s1 / den
    # E[x^2] - mean^2 can round a hair negative on near-constant channels;
    # rsqrt(var + eps) downstream needs the clamp
    var = torch.clamp(s2 / den - torch.square(mean), min=0.0)
    return mean, var, s0


def masked_moments_onepass(y, m, axes) -> Tuple:
    yf = _acc(y)
    return _finish_onepass(*masked_moment_sums(yf, m.to(yf.dtype)), axes)


def masked_moments_kernel(y, m, axes) -> Tuple:
    """The one-pass contract with the local sums from ``cuda_bn`` (the
    CUDA kernel on a CUDA tensor, its plain version on a CPU tensor)."""
    return _finish_onepass(*moment_sums(y, m), axes)


# -- unmasked cross-device moments: (yf, axes) -> (mean, biased var) -------
def global_moments_twopass(yf, axes) -> Tuple:
    """Mean first, then the centered second moment."""
    mean = _psum(torch.mean(yf, dim=(0, 1, 2)), axes)
    var = _psum(torch.mean(torch.square(yf - mean), dim=(0, 1, 2)), axes)
    return mean, var


def global_moments_onepass(yf, axes) -> Tuple:
    """One read of ``(E[x], E[x^2])``, packed (one collective under DDP)."""
    c = yf.shape[-1]
    packed = _psum(torch.cat([torch.mean(yf, dim=(0, 1, 2)),
                              torch.mean(torch.square(yf), dim=(0, 1, 2))]),
                   axes)
    mean = packed[:c]
    return mean, torch.clamp(packed[c:] - torch.square(mean), min=0.0)


@dataclasses.dataclass(frozen=True)
class BNOps:
    """The BN-moments seam of ``models.cannet._batch_norm``.

    ``masked_moments(y, m, axes) -> (mean, biased_var, global_s0)`` takes y
    in its own dtype; ``global_moments(yf, axes) -> (mean, biased_var)``.
    ``impl`` is the CLI-facing name.
    """

    impl: str = "twopass"
    masked_moments: Callable = masked_moments_twopass
    global_moments: Callable = global_moments_twopass


def make_bn_ops(impl: Optional[str]) -> Optional[BNOps]:
    """``--bn-impl`` value -> BNOps (None/'twopass' -> None: the model's
    built-in two-pass default)."""
    if impl in (None, "twopass"):
        return None
    if impl == "onepass":
        return BNOps(impl="onepass", masked_moments=masked_moments_onepass,
                     global_moments=global_moments_onepass)
    if impl == "kernel":
        # the unmasked path has no mask multiply to fuse: onepass is
        # already a single read
        return BNOps(impl="kernel", masked_moments=masked_moments_kernel,
                     global_moments=global_moments_onepass)
    raise ValueError(f"unknown bn impl {impl!r} (one of {BN_IMPLS})")
