"""SLO-driven autoscaler: replica count follows the fleet's own gauges
(counterpart of ``can_tpu/serve/autoscale.py``, copied line for line).

Production scale is not a fixed N replicas: it's replicas that appear in
seconds when the queue deepens and leave when the load does.  This
module is the control loop over signals the stack already exports —
outstanding load (the queue's shedding signal), fleet work-queue depth,
the request-latency reservoir's p99 against the deployment's deadline,
and the SLO engine's burn-rate alerts (``can_tpu_slo_alerting`` on the
gauge sink the serve CLI hands it from ``--slo-spec``) — acting through ``FleetEngine.add_replica`` /
``remove_replica``, which carry the rollout-style zero-drop choreography
(a new replica warms BEFORE joining dispatch; a removed one drains its
in-flight batch first).

Flap control is structural, not tuned: a scale decision needs the signal
to hold for ``up_consecutive`` / ``down_consecutive`` CONSECUTIVE
evaluations (a one-tick spike buys nothing), the up and down thresholds
are separated (``queue_high`` vs ``queue_low``: between them the fleet
holds), and every action starts a ``cooldown_s`` dead time — a step load
change therefore produces at most one transition, not a limit cycle.
Bounds are hard: never below ``min_replicas`` (and never below 1 live),
never above ``max_replicas`` or the fleet's slot universe.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from can_tpu_torch.obs import supervised_loop


@dataclasses.dataclass
class AutoscalePolicy:
    """The knobs; defaults are deliberately conservative (scale up on
    sustained pressure, down only on sustained idleness)."""

    min_replicas: int = 1
    max_replicas: int = 2
    # outstanding admitted load PER LIVE REPLICA that demands growth /
    # permits shrink (between them: hold)
    queue_high: float = 8.0
    queue_low: float = 1.0
    # latency target: scale up when request p99 exceeds it (None = queue
    # signals only); the CLI wires the request deadline here
    p99_high_s: Optional[float] = None
    up_consecutive: int = 2
    down_consecutive: int = 6
    cooldown_s: float = 10.0
    interval_s: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(f"max_replicas ({self.max_replicas}) < "
                             f"min_replicas ({self.min_replicas})")
        if self.queue_low >= self.queue_high:
            raise ValueError(f"queue_low ({self.queue_low}) must be < "
                             f"queue_high ({self.queue_high}) — the gap "
                             f"IS the hysteresis band")


def decide(signals: dict, policy: AutoscalePolicy) -> Optional[str]:
    """Pure per-tick verdict from one signals snapshot: ``"up"``,
    ``"down"``, or None (hold).  Streaks/cooldown/bounds live in the
    Autoscaler — this is just the threshold logic, unit-testable with
    dict literals."""
    live = max(int(signals.get("live", 1)), 1)
    outstanding = float(signals.get("outstanding", 0))
    per_replica = outstanding / live
    p99 = signals.get("p99_s")
    # the latency reservoir is all-time and only decays with NEW
    # traffic: with zero load it replays history forever.  An idle
    # fleet (nothing outstanding, nothing queued) therefore ignores the
    # stale p99 — it must neither block scale-down nor keep voting up.
    idle = outstanding == 0 and int(signals.get("queue_depth", 0)) == 0
    over_latency = (not idle and policy.p99_high_s is not None
                    and p99 is not None and p99 > policy.p99_high_s)
    if (per_replica > policy.queue_high or over_latency
            or signals.get("slo_alerting")):
        return "up"
    under_latency = (idle or policy.p99_high_s is None or p99 is None
                     or p99 < 0.5 * policy.p99_high_s)
    if (per_replica < policy.queue_low and under_latency
            and not signals.get("slo_alerting")
            and int(signals.get("queue_depth", 0)) == 0):
        return "down"
    return None


class Autoscaler:
    """Drives a ``CountService``-fronted ``FleetEngine`` from its gauges.

    ``gauges``: an ``obs.exporter.GaugeSink`` (optional) — the SLO engine's
    ``can_tpu_slo_alerting`` labelled gauges become the burn signal.
    ``clock`` is injectable for deterministic tests; ``tick()``
    can be driven directly without the thread."""

    def __init__(self, service, policy: AutoscalePolicy, *,
                 gauges=None, clock=time.monotonic):
        fleet = getattr(service, "_fleet", None)
        if fleet is None:
            raise ValueError("Autoscaler needs a fleet-mode CountService "
                             "(serve with --replicas >= 2)")
        self.service = service
        self.fleet = fleet
        self.policy = policy
        self.gauges = gauges
        self._clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_ts: Optional[float] = None
        self._actions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals ----------------------------------------------------------
    def _slo_alerting(self) -> bool:
        if self.gauges is None:
            return False
        snap = self.gauges.snapshot()
        return any(g["name"].endswith("_slo_alerting") and g["value"]
                   for g in snap.get("labelled_gauges", ()))

    def observe(self) -> dict:
        """One signals snapshot (the ``decide()`` input)."""
        return {
            "live": self.fleet.live_replicas(),
            "outstanding": self.service.queue.outstanding(),
            "queue_depth": len(self.fleet._queue),
            # via the service: its lock serialises the reservoir read
            # against the recording threads (PR-2's locking rule)
            "p99_s": self.service.latency_percentile(99),
            "slo_alerting": self._slo_alerting(),
        }

    # -- the loop ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One evaluation; returns the ACTION taken ("up"/"down"/None).
        Streak + cooldown + bounds gate the raw ``decide()`` verdict."""
        now = self._clock() if now is None else now
        sig = self.observe()
        verdict = decide(sig, self.policy)
        self._up_streak = self._up_streak + 1 if verdict == "up" else 0
        self._down_streak = (self._down_streak + 1 if verdict == "down"
                             else 0)
        in_cooldown = (self._last_action_ts is not None
                       and now - self._last_action_ts
                       < self.policy.cooldown_s)
        if in_cooldown:
            return None
        live = sig["live"]
        if (self._up_streak >= self.policy.up_consecutive
                and live < self.policy.max_replicas):
            reason = ("slo_burn" if sig["slo_alerting"] else
                      "p99" if (self.policy.p99_high_s is not None
                                and sig["p99_s"] is not None
                                and sig["p99_s"] > self.policy.p99_high_s)
                      else "queue_depth")
            try:
                self.fleet.add_replica(reason=f"autoscale:{reason}")
            except RuntimeError:
                # no spare device / closed: hold (bounds said yes but the
                # universe said no — max_replicas was set too high)
                return None
            self._after_action(now)
            return "up"
        if (self._down_streak >= self.policy.down_consecutive
                and live > self.policy.min_replicas):
            try:
                self.fleet.remove_replica(reason="autoscale:idle")
            except RuntimeError:
                return None
            self._after_action(now)
            return "down"
        return None

    def _after_action(self, now: float) -> None:
        self._last_action_ts = now
        self._actions += 1
        self._up_streak = 0
        self._down_streak = 0

    def stats(self) -> dict:
        return {"actions": self._actions,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "min_replicas": self.policy.min_replicas,
                "max_replicas": self.policy.max_replicas,
                "live": self.fleet.live_replicas()}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            t = threading.Thread(target=self._run, daemon=True,
                                 name="can-tpu-autoscaler")
            self._thread = t
            t.start()
        return self

    def _run(self) -> None:
        supervised_loop(self._stop, self.policy.interval_s, self.tick,
                        "autoscale")

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
