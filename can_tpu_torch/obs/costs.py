"""ProgramCostLedger: per-program cost attribution — MFU, roofline class,
and the empirical launch-cost fit (counterpart of
``can_tpu/obs/costs.py``; the ledger's arithmetic is the reference's line
for line).

The ledger joins three sources:

* **first calls** — ``obs.RecompileTracker`` (the train and eval steps)
  and ``ServeEngine`` run the first call of each new ``(shape, dtype)``
  signature inside ``count_costs()``, the call that is already billed as
  ``compile`` and kept out of every timing, and hand its totals to
  :meth:`ProgramCostLedger.register`.  Eager PyTorch has no compiled
  program to analyse the way the JAX package AOT-compiles the step a
  second time (and running a train step twice would apply the optimizer
  twice), so the port counts the call itself:

  - **flops**: ``torch.utils.flop_counter.FlopCounterMode`` over the
    aten ops (matmuls, convolutions and their backward; elementwise
    work counts 0 there), a convolution counted by the JAX package's
    cost-analysis rule: only the taps that land inside the input;
  - **bytes accessed**: a ``TorchDispatchMode`` that sums, for every
    aten op, the bytes of its tensor inputs and of its tensor outputs,
    views excepted (they move nothing).  Nothing is fused, so this is an
    upper bound on the memory traffic, like XLA's figure before fusion;
  - **the hand-written kernels** are ctypes calls no dispatch mode sees.
    Each seam (``ops/cuda_context.py`` ``context_tail``,
    ``ops/cuda_bn.py`` ``moment_sums`` and ``MomentSums.backward``) runs
    inside ``seam_cost(flops, bytes)``: the kernel's analytic count (the
    one ``chip_smoke.py``'s bounds use) is added, and whatever aten work
    the seam runs inside — the plain version on a CPU tensor, the
    wrapper's allocations on a CUDA one — is hidden.  A forward therefore
    reads the same count on the CPU and on the card.  A train step's
    backward is counted as what runs: the context kernel's backward is
    plain PyTorch on both devices (on the card it also recomputes the
    forward, the JAX custom VJP's rule), and the BN backward is the
    kernel's analytic count on the card, the plain version's aten ops on
    the CPU;

  the scope changes no bit of the call's result and launches nothing;
  outside a first call no mode is active.
* **steady state** — ``StepTimer`` per-shape wall totals (train/eval)
  and serve per-batch execute times (``CountService``) land via
  :meth:`observe` / :meth:`observe_timer`, first calls excluded
  upstream.
* **the device peak table** — ``cli.common.local_device_peaks(device)``
  (spec FLOP/s + memory bytes/s by CUDA device name; a labelled-NOMINAL
  entry on the CPU) turns flops/seconds into MFU and flops/bytes into a
  roofline class against the ridge intensity.

The launch-cost fit closes the loop with the planner: its cost model
prices a launch as ``area * slots + launch_cost_px``; in time units
``seconds = px / rate + launch_overhead_s``.  A weighted least-squares
line through the measured (pixels, mean seconds) points recovers both
terms, and the intercept re-expressed in the planner's unit is the
EMPIRICAL launch cost — ``launch_cost_drift`` (empirical / planned) says
when ``cli/common.py``'s ``DEFAULT_LAUNCH_COST_MPX`` has gone stale.

Everything surfaces as ``perf.summary`` events (per epoch in the loops,
periodic in serve): numeric payload keys become ``can_tpu_mfu_*`` /
``can_tpu_roofline_*`` / ``can_tpu_launch_cost_*`` gauges through the
exporter's ``GaugeSink``, and the ``detail`` rows feed
``tools/telemetry_report.py``.  A run without telemetry constructs no
ledger.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Tuple

ROOFLINE_COMPUTE = "compute"
ROOFLINE_MEMORY = "memory"
ROOFLINE_UNKNOWN = "unknown"

# Timing-trust rule: serve execute times are FENCED (the counts' .cpu()
# closes every measured window), so one launch is already honest.  The
# train loop's per-shape samples are host-side dispatch intervals (the
# window flush absorbs the device sync): one sample can be wildly short,
# but the MEAN converges on the true step time as launches accumulate.
# Unfenced programs need this many launches before their mean feeds MFU
# or the launch-cost fit; below it the row reports mean_s but no MFU.
MIN_UNFENCED_LAUNCHES = 4


def extract_image_signature(signature) -> Tuple[tuple, str]:
    """``train.steps.batch_signature`` triples -> (image shape, dtype).

    The image tensor carries the pixels every cost in this module is
    normalised by; batches without an ``image`` entry fall back to the
    largest-shape tensor."""
    best = None
    for name, shape, dtype in signature:
        if name == "image":
            return tuple(shape), str(dtype)
        size = 1
        for d in shape:
            size *= int(d)
        if best is None or size > best[0]:
            best = (size, tuple(shape), str(dtype))
    if best is None:
        return (), "?"
    return best[1], best[2]


# -- the counting scope ---------------------------------------------------
_local = threading.local()


def current_scope() -> Optional["CostScope"]:
    """The innermost ``count_costs()`` scope open on this thread, or None
    (one attribute read: what every seam pays outside a first call)."""
    stack = getattr(_local, "scopes", None)
    return stack[-1] if stack else None


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _byte_mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _ByteCounter(TorchDispatchMode):
        """Adds each aten op's input and output tensor bytes to a scope
        (views move nothing and count 0)."""

        def __init__(self, scope):
            super().__init__()
            self.scope = scope

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not self.scope.paused and not getattr(func, "is_view", False):
                self.scope.add(0.0, _tensor_bytes((args, kwargs, out)))
            return out

    return _ByteCounter


class CostScope:
    """Running totals of one ``count_costs()`` scope: ``flops`` and
    ``bytes_accessed`` (final once the scope has closed)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flop_counter = None
        self._flops_closed: Optional[float] = None
        self._correction = 0.0   # aten flops hidden by seams (negative)
        self._extra_flops = 0.0  # seams' analytic flops
        self.bytes_accessed = 0.0
        self.paused = 0          # > 0 inside a seam: aten work is hidden

    def _aten_flops(self) -> float:
        if self._flops_closed is not None:
            return self._flops_closed
        return float(self._flop_counter.get_total_flops())

    @property
    def flops(self) -> float:
        return self._aten_flops() + self._correction + self._extra_flops

    def add(self, flops: float, nbytes: float) -> None:
        with self._lock:
            self._extra_flops += flops
            self.bytes_accessed += nbytes

    def totals(self) -> Tuple[Optional[float], Optional[float]]:
        """``(flops, bytes)`` in the ledger's ``cost=`` form: a zero is
        "not reported" (None), as for a backend's cost analysis."""
        flops, nbytes = self.flops, self.bytes_accessed
        return (flops if flops > 0 else None, nbytes if nbytes > 0 else None)


def _valid_taps(size: int, k: int, stride: int, pad: int, dil: int,
                out: int) -> int:
    """Kernel taps along one spatial dim that land inside the input,
    summed over the output positions."""
    n = 0
    for o in range(out):
        base = o * stride - pad
        n += sum(1 for j in range(k) if 0 <= base + j * dil < size)
    return n


def _conv_valid_flops(x_shape, w_shape, out_shape, stride, padding,
                      dilation) -> int:
    """2 x the multiply-adds of a (non-transposed) convolution whose input
    position lies inside the input: XLA's rule (HloCostAnalysis), which
    leaves the zero padding's taps out."""
    nd = len(w_shape) - 2

    def per_dim(v):
        return list(v) * nd if len(v) == 1 else list(v)

    taps = 1
    for d, (s, p, dl) in enumerate(zip(per_dim(stride), per_dim(padding),
                                       per_dim(dilation))):
        taps *= _valid_taps(x_shape[2 + d], w_shape[2 + d], s, p, dl,
                            out_shape[2 + d])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs) -> int:
    from torch.utils.flop_counter import conv_flop_count

    if transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    return _conv_valid_flops(x_shape, w_shape, out_shape, stride, padding,
                             dilation)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kwargs) -> int:
    """The input and the weight gradient each take one multiply-add per
    valid (output, tap) pair of the forward."""
    from torch.utils.flop_counter import conv_backward_flop

    if transposed:
        return conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias,
                                  stride, padding, dilation, transposed,
                                  _output_padding, _groups, output_mask,
                                  out_shape)
    fwd = _conv_valid_flops(x_shape, w_shape, grad_out_shape, stride,
                            padding, dilation)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _flop_counter():
    """``FlopCounterMode`` with the convolution rule of the JAX package's
    cost analysis (``_conv_valid_flops``): FlopCounterMode's own formula
    counts every tap of the padded window, ~10% more than XLA on CANNet
    at small sizes (its 3x3 dilated backend at 1/8 resolution has many
    taps in the padding)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    conv = {op: _conv_flop for op in (aten.convolution, aten._convolution,
                                      aten.cudnn_convolution,
                                      aten._slow_conv2d_forward,
                                      aten.convolution_overrideable)}
    return FlopCounterMode(display=False, custom_mapping={
        **conv, aten.convolution_backward: _conv_backward_flop})


@contextlib.contextmanager
def count_costs():
    """Count the flops and bytes of the aten work run inside (and of the
    seams' kernels): yields a ``CostScope``.  Results are bitwise those
    of the same work without the scope."""
    scope = CostScope()
    scope._flop_counter = _flop_counter()
    stack = getattr(_local, "scopes", None)
    if stack is None:
        stack = _local.scopes = []
    stack.append(scope)
    try:
        with scope._flop_counter, _byte_mode_class()(scope):
            yield scope
    finally:
        scope._flops_closed = float(scope._flop_counter.get_total_flops())
        stack.pop()


@contextlib.contextmanager
def seam_cost(flops: float, nbytes: float, scope: Optional[CostScope] = None):
    """Around a hand-written kernel's seam: add its analytic ``flops`` and
    ``nbytes`` to ``scope`` (default: this thread's open scope) and hide
    the aten work run inside.  A no-op without a scope."""
    scope = scope if scope is not None else current_scope()
    if scope is None:
        yield
        return
    before = scope._aten_flops()
    with scope._lock:
        scope.paused += 1
    try:
        yield
    finally:
        with scope._lock:
            scope.paused -= 1
            scope._correction -= scope._aten_flops() - before
        scope.add(float(flops), float(nbytes))


# -- the ledger -----------------------------------------------------------
@dataclasses.dataclass
class ProgramCost:
    """One program's ledger row (mutable: timings accumulate)."""

    name: str                 # step name ("train_step", "serve_predict", …)
    shape: tuple              # image shape (B, H, W, C)
    dtype: str                # image dtype string
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    launches: int = 0
    seconds: float = 0.0
    fenced: bool = True  # ANDed over observations; see MIN_UNFENCED_LAUNCHES

    @property
    def timing_reliable(self) -> bool:
        return bool(self.launches) and (self.fenced or
                                        self.launches >=
                                        MIN_UNFENCED_LAUNCHES)

    @property
    def pixels(self) -> Optional[int]:
        if len(self.shape) < 3:
            return None
        return int(self.shape[0]) * int(self.shape[1]) * int(self.shape[2])

    @property
    def mean_s(self) -> Optional[float]:
        return self.seconds / self.launches if self.launches else None

    @property
    def intensity(self) -> Optional[float]:
        """Arithmetic intensity, FLOP per memory byte."""
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed


class ProgramCostLedger:
    """The join: per-program costs x timings x device peaks.

    compute: "bf16" or "f32" — selects the peak-FLOP/s ceiling MFU is
      quoted against (the run's compute dtype).
    peaks: a ``cli.common.DevicePeaks``; None reads ``device``'s
      (``cli.common.local_device_peaks``), and with neither the MFU rows
      go None (flops/bytes and the launch-cost fit still work).
    plan_launch_cost_px: the planner's configured launch cost (pixel
      units) — the denominator of ``launch_cost_drift``; the train CLI
      sets it to the resolved ``--launch-cost-mpx``.

    Thread-safety: ``register`` runs on whatever thread hits a first call
    (train loop / serve batcher / fleet replica), ``observe`` on loop or
    batcher threads, snapshots on scrape threads — one lock covers the
    record table.
    """

    def __init__(self, *, compute: str = "f32", peaks=None, device=None,
                 plan_launch_cost_px: Optional[float] = None):
        if peaks is None and device is not None:
            from can_tpu_torch.cli.common import local_device_peaks

            peaks = local_device_peaks(device)
        self.peaks = peaks
        self.compute = compute if compute in ("bf16", "f32") else "f32"
        self.plan_launch_cost_px = plan_launch_cost_px
        self._lock = threading.Lock()
        self._programs: Dict[Tuple[str, tuple, str], ProgramCost] = {}

    # -- first-call registration (RecompileTracker / ServeEngine) ---------
    def register(self, name: str, signature, *, cost=None) -> Optional[dict]:
        """Record a new signature; returns ``{"flops", "bytes_accessed"}``
        for the keys ``cost`` reports (the ``compile`` event carries
        them).  ``cost``: ``(flops, bytes)``, either None when unknown —
        a ``CostScope.totals()``."""
        shape, dtype = extract_image_signature(signature)
        with self._lock:
            rec = self._programs.setdefault(
                (name, shape, dtype), ProgramCost(name, shape, dtype))
            if cost is not None and rec.flops is None:
                rec.flops, rec.bytes_accessed = cost
        if cost is None:
            return None
        # only the keys actually counted: no literal Nones in the payload
        out = {}
        if cost[0] is not None:
            out["flops"] = cost[0]
        if cost[1] is not None:
            out["bytes_accessed"] = cost[1]
        return out or None

    # -- steady-state timing ---------------------------------------------
    def observe(self, name: str, shape, seconds: float, n: int = 1,
                *, dtype: Optional[str] = None,
                fenced: bool = True) -> None:
        """Add ``n`` launches totalling ``seconds`` for the program with
        this image ``shape`` (first calls excluded by the caller).
        ``dtype`` disambiguates when one shape ran at several image
        dtypes (serve passes it; the train loop runs one dtype per run,
        so shape alone resolves — ties go to the most recently registered
        record).  ``fenced=False`` marks dispatch-biased samples (the
        train loop's asynchronous intervals): those feed MFU only once
        MIN_UNFENCED_LAUNCHES accumulate."""
        shape = tuple(shape)
        with self._lock:
            rec = None
            if dtype is not None:
                rec = self._programs.get((name, shape, dtype))
            if rec is None:
                matches = [r for (n_, s_, _), r in self._programs.items()
                           if n_ == name and s_ == shape]
                rec = matches[-1] if matches else None
            if rec is None:
                rec = self._programs[(name, shape, dtype or "?")] = \
                    ProgramCost(name, shape, dtype or "?")
            rec.launches += int(n)
            rec.seconds += float(seconds)
            rec.fenced = rec.fenced and bool(fenced)

    def observe_timer(self, name: str, timer) -> None:
        """Fold a ``StepTimer``'s per-shape totals in (the loops call this
        at epoch boundaries with their per-epoch timers).  Loop samples
        are host-side dispatch intervals — unfenced by construction."""
        for shape, (n, total) in timer.shape_totals().items():
            self.observe(name, shape, total, n, fenced=False)

    # -- snapshots --------------------------------------------------------
    def _peak_flops(self) -> Optional[float]:
        return self.peaks.flops(self.compute) if self.peaks else None

    def roofline_of(self, rec: ProgramCost) -> str:
        inten = rec.intensity
        if inten is None or self.peaks is None:
            return ROOFLINE_UNKNOWN
        return (ROOFLINE_COMPUTE
                if inten >= self.peaks.ridge(self.compute)
                else ROOFLINE_MEMORY)

    def _snapshot(self) -> List[ProgramCost]:
        """Consistent point-in-time copy of every registered program —
        the unit rows(), launch_cost_fit() and the summary share so one
        emitted event can never disagree with itself."""
        with self._lock:
            recs = sorted(self._programs.values(),
                          key=lambda r: (r.name, r.shape, r.dtype))
            return [dataclasses.replace(r) for r in recs]

    def rows(self, _snapshot: Optional[List[ProgramCost]] = None
             ) -> List[dict]:
        """Per-program dicts, sorted by (name, shape): flops/bytes,
        intensity, roofline class, launches, mean seconds, MFU and
        bandwidth utilisation against the peak table."""
        peak_f = self._peak_flops()
        peak_bw = self.peaks.hbm_bytes_s if self.peaks else None
        recs = self._snapshot() if _snapshot is None else _snapshot
        out = []
        for r in recs:
            mean_s = r.mean_s
            trust = r.timing_reliable
            mfu = (r.flops / (mean_s * peak_f)
                   if trust and r.flops and mean_s and peak_f else None)
            bw_util = (r.bytes_accessed / (mean_s * peak_bw)
                       if trust and r.bytes_accessed and mean_s and peak_bw
                       else None)
            out.append({
                "name": r.name, "shape": list(r.shape), "dtype": r.dtype,
                "flops": r.flops, "bytes_accessed": r.bytes_accessed,
                "pixels": r.pixels,
                "intensity": (round(r.intensity, 4)
                              if r.intensity is not None else None),
                "roofline": self.roofline_of(r),
                "launches": r.launches,
                "mean_s": round(mean_s, 6) if mean_s is not None else None,
                "total_s": round(r.seconds, 4),
                "timing_reliable": trust,
                "mfu": round(mfu, 4) if mfu is not None else None,
                "bw_util": round(bw_util, 4) if bw_util is not None else None,
            })
        return out

    def launch_cost_fit(self, name: Optional[str] = None, *,
                        _snapshot: Optional[List[ProgramCost]] = None
                        ) -> Optional[dict]:
        """Weighted least-squares of mean seconds-per-launch against
        pixels-per-launch over the timed programs (optionally one step
        ``name``): ``seconds = px / rate + overhead``.  Needs >= 2
        distinct pixel sizes and a positive slope; returns the realized
        device rate, the fixed per-launch overhead, and that overhead in
        the planner's Mpx unit (clamped at 0 — a negative intercept is
        measurement noise, reported raw in ``intercept_s``).  Only
        timing-reliable programs contribute (see MIN_UNFENCED_LAUNCHES)."""
        if _snapshot is None:
            _snapshot = self._snapshot()
        pts = [(r.pixels, r.mean_s, r.launches)
               for r in _snapshot
               if (name is None or r.name == name)
               and r.pixels and r.mean_s and r.timing_reliable]
        if len({px for px, _, _ in pts}) < 2:
            return None
        sw = sum(n for _, _, n in pts)
        mx = sum(n * px for px, _, n in pts) / sw
        my = sum(n * s for _, s, n in pts) / sw
        sxx = sum(n * (px - mx) ** 2 for px, _, n in pts)
        sxy = sum(n * (px - mx) * (s - my) for px, s, n in pts)
        if sxx <= 0 or sxy <= 0:
            return None
        slope = sxy / sxx            # seconds per pixel
        intercept = my - slope * mx  # fixed seconds per launch
        mpx = max(intercept / slope, 0.0) / 1e6
        out = {
            "rate_mpx_s": round(1.0 / slope / 1e6, 4),
            "intercept_s": round(intercept, 6),
            "launch_cost_mpx_empirical": round(mpx, 4),
            "fit_points": len(pts),
        }
        if self.plan_launch_cost_px:
            out["launch_cost_drift"] = round(
                mpx / (self.plan_launch_cost_px / 1e6), 4)
        return out

    def _aggregate(self, rows: List[dict],
                   snapshot: Optional[List[ProgramCost]] = None) -> dict:
        """Aggregate payload derived from ONE rows() snapshot: weighted
        MFU over timed programs, roofline class counts over all
        registered programs, the launch-cost fit, and the peak-table
        provenance.  Numeric entries become ``can_tpu_<key>`` gauges."""
        out: dict = {"perf_programs": len(rows)}
        for cls in (ROOFLINE_COMPUTE, ROOFLINE_MEMORY, ROOFLINE_UNKNOWN):
            out[f"roofline_{cls}_bound" if cls != ROOFLINE_UNKNOWN
                else "roofline_unknown"] = sum(
                    1 for r in rows if r["roofline"] == cls)
        timed = [r for r in rows if r["mfu"] is not None and r["total_s"]]
        if timed:
            wsum = sum(r["total_s"] for r in timed)
            out["mfu_weighted"] = round(
                sum(r["mfu"] * r["total_s"] for r in timed) / wsum, 4)
            out["mfu_best"] = max(r["mfu"] for r in timed)
            out["mfu_worst"] = min(r["mfu"] for r in timed)
        # the launch-cost fit PER step family, never pooled: train_step is
        # forward + backward + update while eval/serve are forward only,
        # so their seconds-per-pixel slopes differ ~3x and a pooled line
        # reports a bogus intercept.  The planner prices TRAIN launches:
        # the drift gauge comes from "train_step" whenever it has a fit,
        # else from the best-constrained other family (labelled)
        best_name = best_fit = None
        for n in sorted({r["name"] for r in rows}):
            f = self.launch_cost_fit(n, _snapshot=snapshot)
            if f is None:
                continue
            if n == "train_step":
                best_name, best_fit = n, f
                break
            if best_fit is None or f["fit_points"] > best_fit["fit_points"]:
                best_name, best_fit = n, f
        if best_fit is not None:
            out.update(best_fit)
            out["launch_cost_fit_name"] = best_name
        if self.peaks is not None:
            out["peak_flops"] = self._peak_flops()
            out["peak_hbm_bytes_s"] = self.peaks.hbm_bytes_s
            out["peak_nominal"] = int(self.peaks.nominal)
            out["peak_source"] = self.peaks.source
        return out

    def summary(self) -> dict:
        snap = self._snapshot()
        return self._aggregate(self.rows(snap), snap)

    def emit_summary(self, telemetry, *, step: Optional[int] = None,
                     phase: str = "") -> dict:
        """One ``perf.summary`` event: the aggregate payload (gauge feed)
        plus the per-program ``detail`` rows, both — the launch-cost fit
        included — from the same snapshot."""
        snap = self._snapshot()
        rows = self.rows(snap)
        payload = self._aggregate(rows, snap)
        telemetry.emit("perf.summary", step=step, phase=phase,
                       detail=rows, **payload)
        return payload
