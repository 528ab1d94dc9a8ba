"""Run-health detectors: watch a training run while it is ALIVE.

Counterpart of ``can_tpu/obs/health.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The bus (obs/bus.py) records what happened; nothing watched the stream
until after the fact — a diverging loss, a dying input pipeline, or a
silent throughput regression was a post-mortem discovery in the JSONL.
This module turns the per-window metric fetch the loop already does into
live ``health.alert`` events (same bus, same sinks, so alerts land in the
JSONL, the /metrics exporter, and ``tools/run_monitor.py`` alike).

Signals and detector kinds:

* ``loss``       — ``spike`` (EWMA+MAD outlier), ``plateau`` (no EWMA
                   improvement for ``plateau_patience`` steps), ``nan``
                   (the abort path: emitted BEFORE ``NonFiniteLossError``
                   propagates, so the artifact says why the run died).
* ``grad_norm``  — ``spike`` and ``nan_precursor`` (a non-finite or
                   exploding gradient norm usually precedes the NaN loss
                   by a window; the norm is computed INSIDE the
                   step — see ``train/steps.py make_train_step``
                   ``health_metrics`` — so it rides the existing windowed
                   fetch with zero extra device syncs).
* ``step_time``  — ``throughput_regression``: the window's median
                   steady-state step time vs a rolling baseline of recent
                   windows (compile first-calls are already excluded from
                   the samples, so a new bucket shape is not a
                   regression).
* ``input``      — ``stall_budget``: the epoch's ``stall`` accounting
                   escalated to an alert when starvation exceeds a budget
                   fraction of the epoch.

All thresholds are scale-free (MAD multiples / relative fractions): the
detectors never need to know whether the loss is 1e-4 or 1e4.  Alert
storms are bounded by a per-(signal, kind) cooldown — repeats inside the
cooldown window are counted (``suppressed`` in ``health.summary``), not
emitted.
"""

from __future__ import annotations

import collections
import math
import statistics
from typing import Optional

_EPS = 1e-12


class EwmaMadDetector:
    """EWMA baseline + MAD scale over one scalar stream.

    ``update(x)`` returns None, or an anomaly dict when ``x`` deviates
    from the EWMA by more than ``k`` MADs (after ``warmup`` samples).
    The MAD is floored at ``rel_floor`` of the baseline magnitude so a
    near-constant stream (synthetic data, converged runs) doesn't alert
    on femto-scale jitter.  The baseline keeps adapting THROUGH spikes
    (an EWMA tracks level shifts; a one-off outlier barely moves it),
    and residuals are recorded unconditionally so the scale estimate
    reflects the stream as it actually is.
    """

    def __init__(self, *, alpha: float = 0.15, k: float = 8.0,
                 warmup: int = 8, window: int = 64,
                 rel_floor: float = 1e-3):
        self.alpha = float(alpha)
        self.k = float(k)
        self.warmup = int(warmup)
        self.rel_floor = float(rel_floor)
        self.ewma: Optional[float] = None
        self.n = 0
        self._resid = collections.deque(maxlen=int(window))

    def _mad(self) -> float:
        return statistics.median(self._resid)

    def update(self, x: float) -> Optional[dict]:
        x = float(x)
        if not math.isfinite(x):
            return None  # non-finite is the caller's nan_precursor path
        verdict = None
        if self.ewma is None:
            self.ewma = x
        else:
            resid = abs(x - self.ewma)
            if self.n >= self.warmup and self._resid:
                scale = max(self._mad(),
                            self.rel_floor * max(abs(self.ewma), _EPS))
                deviation = resid / max(scale, _EPS)
                if deviation > self.k:
                    verdict = {"alert": "spike", "value": x,
                               "baseline": self.ewma,
                               "deviation": round(deviation, 2)}
            self._resid.append(resid)
            self.ewma += self.alpha * (x - self.ewma)
        self.n += 1
        return verdict


class PlateauDetector:
    """Fires once when the EWMA of a to-be-minimised series stops
    improving: no new best better than ``tol`` (relative) for
    ``patience`` consecutive updates.  Re-arms after a genuine
    improvement, so a run that un-sticks and re-sticks alerts again."""

    def __init__(self, *, alpha: float = 0.05, patience: int = 200,
                 tol: float = 1e-3, warmup: int = 20):
        self.alpha = float(alpha)
        self.patience = int(patience)
        self.tol = float(tol)
        self.warmup = int(warmup)
        self.ewma: Optional[float] = None
        self.best: Optional[float] = None
        self.since_best = 0
        self.n = 0
        self._fired = False

    def update(self, x: float) -> Optional[dict]:
        x = float(x)
        if not math.isfinite(x):
            return None
        self.ewma = x if self.ewma is None else (
            self.ewma + self.alpha * (x - self.ewma))
        self.n += 1
        if self.n < self.warmup:
            self.best = self.ewma
            return None
        if self.best is None or self.ewma < self.best * (1.0 - self.tol):
            self.best = min(self.best, self.ewma) \
                if self.best is not None else self.ewma
            self.since_best = 0
            self._fired = False
            return None
        self.since_best += 1
        if self.since_best >= self.patience and not self._fired:
            self._fired = True
            return {"alert": "plateau", "value": self.ewma,
                    "baseline": self.best, "stuck_for": self.since_best}
        return None


class ThroughputDetector:
    """Median window step-time vs a rolling baseline of recent windows.

    ``update(median_step_s)`` alerts after ``consec`` consecutive windows
    slower than ``(1 + frac)`` times the rolling-median baseline — a
    sustained regression (thermal throttling, a neighbour stealing host
    CPU, a degraded ICI link), not one noisy window.  The baseline deque
    only ingests NON-regressing windows, so a persistent slowdown cannot
    talk its way into the baseline and silence itself."""

    def __init__(self, *, frac: float = 0.25, consec: int = 3,
                 warmup: int = 3, window: int = 16):
        self.frac = float(frac)
        self.consec = int(consec)
        self.warmup = int(warmup)
        self._base = collections.deque(maxlen=int(window))
        self._slow = 0

    def baseline(self) -> Optional[float]:
        if len(self._base) < self.warmup:
            return None
        return statistics.median(self._base)

    def update(self, median_step_s: float) -> Optional[dict]:
        x = float(median_step_s)
        if not math.isfinite(x) or x <= 0:
            return None
        base = self.baseline()
        if base is not None and x > base * (1.0 + self.frac):
            self._slow += 1
            if self._slow == self.consec:
                return {"alert": "throughput_regression", "value": x,
                        "baseline": base,
                        "slowdown": round(x / base, 3),
                        "windows": self._slow}
            return None
        self._slow = 0
        self._base.append(x)
        return None


class HealthMonitor:
    """Joins the detectors to the bus: one per-run object, fed from the
    train loop's existing windowed metric fetch (``train/loop.py``).

    Emits ``health.alert`` events (payload: signal, kind, value,
    baseline, epoch, ...) and one ``health.summary`` per epoch (alert
    counts by ``signal/kind``, suppressed repeats, last baselines).
    Everything here is host-side arithmetic on already-fetched scalars —
    no device work, no extra syncs; when telemetry is off the loop never
    constructs a monitor and the hot path is untouched.
    """

    #: a spiking value beyond this multiple of its baseline is classed
    #: nan_precursor rather than spike — the "about to overflow" regime
    #: (a ratio, not a MAD count: low-jitter series make MADs tiny, and a
    #: 10% wobble must not read as impending divergence)
    NAN_PRECURSOR_RATIO = 10.0

    def __init__(self, telemetry, *, spike_k: float = 8.0,
                 warmup: int = 8, plateau_patience: int = 200,
                 plateau_tol: float = 1e-3, regress_frac: float = 0.25,
                 regress_consec: int = 3, stall_budget_frac: float = 0.15,
                 cooldown: int = 50):
        self.telemetry = telemetry
        self.stall_budget_frac = float(stall_budget_frac)
        self.cooldown = int(cooldown)
        self._loss = EwmaMadDetector(k=spike_k, warmup=warmup)
        self._grad = EwmaMadDetector(k=spike_k, warmup=warmup)
        self._plateau = PlateauDetector(patience=plateau_patience,
                                        tol=plateau_tol)
        self._rate = ThroughputDetector(frac=regress_frac,
                                        consec=regress_consec)
        self._updates = 0
        self._last_emit: dict = {}  # (signal, kind) -> update index
        self.alerts_total = 0
        self.suppressed_total = 0
        self._counts: dict = {}  # "signal/kind" -> count (incl. suppressed)

    # -- alert fan-out ---------------------------------------------------
    def _alert(self, signal: str, verdict: dict, *, epoch: int,
               step: Optional[int] = None, rate_limit: bool = True,
               **extra) -> None:
        """``rate_limit=False`` for alerts that are already naturally
        bounded (once per epoch / terminal): the cooldown counts per-STEP
        updates, so a short epoch would wrongly swallow them."""
        key = (signal, verdict["alert"])
        tag = f"{signal}/{verdict['alert']}"
        self._counts[tag] = self._counts.get(tag, 0) + 1
        last = self._last_emit.get(key)
        if rate_limit and last is not None \
                and self._updates - last < self.cooldown:
            self.suppressed_total += 1
            return
        self._last_emit[key] = self._updates
        self.alerts_total += 1
        self.telemetry.emit("health.alert", step=step, signal=signal,
                            epoch=epoch, **verdict, **extra)

    def _classify(self, verdict: dict) -> dict:
        """Upgrade a spike verdict to nan_precursor when the value has
        left its baseline's decade — the explosion regime, not noise."""
        base = abs(verdict.get("baseline") or 0.0)
        if abs(verdict["value"]) > self.NAN_PRECURSOR_RATIO * max(base, _EPS):
            return dict(verdict, alert="nan_precursor")
        return verdict

    # -- feed points (called by train/loop.py) ---------------------------
    def on_step_metrics(self, *, loss_per_img: float,
                        grad_norm: Optional[float] = None,
                        update_norm: Optional[float] = None,
                        epoch: int, step: Optional[int] = None) -> None:
        """One fetched step's scalars.  Called inside the metric-flush
        window, so detection lags the device by at most ``check_every``
        steps — the same staleness the NaN abort already has."""
        self._updates += 1
        if grad_norm is not None:
            if not math.isfinite(grad_norm):
                self._alert("grad_norm",
                            {"alert": "nan_precursor", "value": grad_norm,
                             "baseline": self._grad.ewma}, epoch=epoch,
                            step=step)
            else:
                v = self._grad.update(grad_norm)
                if v is not None:
                    self._alert("grad_norm", self._classify(v), epoch=epoch,
                                step=step, update_norm=update_norm)
        v = self._loss.update(loss_per_img)
        if v is not None:
            self._alert("loss", self._classify(v), epoch=epoch, step=step)
        v = self._plateau.update(loss_per_img)
        if v is not None:
            self._alert("loss", v, epoch=epoch, step=step)

    def on_window(self, samples, *, epoch: int, phase: str = "train") -> None:
        """One metric-flush window's steady-state step-time samples (the
        list ``step_window`` events carry; compiles already excluded)."""
        if not samples:
            return
        v = self._rate.update(statistics.median(float(x) for x in samples))
        if v is not None:
            self._alert("step_time", v, epoch=epoch, phase=phase)

    def on_stall(self, *, seconds: float, frac: float, epoch: int,
                 phase: str = "train") -> None:
        """Escalate the epoch's stall accounting: starvation beyond the
        budget fraction means the chip waited on the host — an alert, not
        just a row in the post-mortem table."""
        if frac > self.stall_budget_frac:
            # at most once per epoch by construction — never step-cooled
            # (epochs shorter than the cooldown would silently swallow a
            # persistent starvation condition)
            self._alert("input", {"alert": "stall_budget",
                                  "value": round(frac, 4),
                                  "baseline": self.stall_budget_frac,
                                  "seconds": round(seconds, 3)},
                        epoch=epoch, phase=phase, rate_limit=False)

    def on_nonfinite(self, loss: float, *, epoch: int,
                     step: Optional[int] = None) -> None:
        """The abort path: called by the loop's flush right BEFORE it
        raises ``NonFiniteLossError``, so the alert is on the bus (and
        flushed to the JSONL) when the process dies.  Never rate-limited:
        a dying run's last event must not be swallowed by a cooldown."""
        tag = "loss/nan"
        self._counts[tag] = self._counts.get(tag, 0) + 1
        self.alerts_total += 1
        self.telemetry.emit("health.alert", step=step, signal="loss",
                            alert="nan", value=loss, epoch=epoch)

    def epoch_summary(self, epoch: int) -> None:
        """One ``health.summary`` per epoch: the rollup the monitor and
        the report table read without replaying every alert."""
        self.telemetry.emit(
            "health.summary", epoch=epoch,
            alerts_total=self.alerts_total,
            suppressed=self.suppressed_total,
            counts=dict(sorted(self._counts.items())),
            loss_ewma=self._loss.ewma,
            grad_norm_ewma=self._grad.ewma,
            step_time_baseline_s=self._rate.baseline())
