"""Declarative SLOs + multi-window burn rates over the telemetry bus.

Counterpart of ``can_tpu/obs/slo.py``, kept as the port's own copy
(the JSONL schema, event kinds, file names and ``can_tpu_*`` metric
names are the reference's, so one toolchain reads either package's
output).

The stack exports every signal an autoscaler or pager needs — serve
latency, reject counts, step times, stall fractions, MFU — but only as
raw gauges: "p99 vs deadline" existed as two numbers an operator had to
eyeball.  This module adds the formal layer: a JSON spec declares
OBJECTIVES (a good/bad predicate over one event stream plus a target
good-fraction), and the engine evaluates each as an error-budget BURN
RATE over several sliding windows:

    burn(window) = bad_fraction(window) / (1 - target)

Burn 1.0 means spending the budget exactly at the sustainable rate;
burn 10 means ten times too fast.  An objective ALERTS when its burn
meets ``burn_alert`` on EVERY window — the classic multi-window AND: the
short window proves the problem is happening NOW, the long window proves
it is not a blip (Google SRE workbook ch. 5).  Alerts ride the bus as
``slo.burn`` events, which:

* become ``can_tpu_slo_*`` gauges via ``GaugeSink`` — the scrape-able
  admission/scale-up signal ROADMAP item 2 consumes;
* trigger an incident bundle on fast burn (``obs/incidents.py``);
* land in the JSONL, where ``tools/slo_report.py`` replays a finished
  run against the same spec (same arithmetic, event-time clock) and
  exits nonzero on violation — the CI shape of an SLO.

Spec schema (see the committed ``slo_spec.json``)::

    {"version": 1, "eval_interval_s": 30,
     "objectives": [
       {"name": "serve_p99_deadline",
        "event": "serve.request",      # bus kind sampled
        "field": "latency_s",          # numeric payload key; a LIST
                                       #   field (samples_s) contributes
                                       #   one sample per element; null
                                       #   = each event is one good
        "op": "<=", "threshold": 2.0,  # good when value op threshold
        "bad_kinds": ["serve.reject"], # kinds counted bad (payload
                                       #   "count", default 1)
        "target": 0.95,                # required good fraction
        "windows_s": [60, 300],        # burn windows, short -> long
        "burn_alert": 10.0,            # alert at >= this on ALL windows
        "min_samples": 10}]}           # per window, else burn undefined

The engine is a ``Telemetry.watchers`` entry: it samples every event
(host-side dict reads, no device work), and evaluation is TIME-GATED on
the event stream's own clock — heartbeats keep it live on an otherwise
quiet run, and no new thread exists.  Everything is keyed on event
``ts``, so the offline replay is bit-identical to the live evaluation.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

_OPS = ("<=", ">=")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declared objective (see the module docstring for semantics)."""

    name: str
    event: str
    target: float
    field: Optional[str] = None
    op: str = "<="
    threshold: Optional[float] = None
    bad_kinds: Tuple[str, ...] = ()
    windows_s: Tuple[float, ...] = (60.0, 300.0)
    burn_alert: float = 10.0
    min_samples: int = 10
    description: str = ""

    @property
    def budget(self) -> float:
        """The error budget: allowed bad fraction."""
        return 1.0 - self.target

    def good(self, value: float) -> bool:
        if self.op == "<=":
            return value <= self.threshold
        return value >= self.threshold


def parse_slo_spec(doc: dict) -> "SloSpec":
    """Validate a spec document; raises ``ValueError`` naming the exact
    field (a typo'd spec must fail at CLI-validation time, before any
    runtime init — the path-check contract)."""
    if not isinstance(doc, dict):
        raise ValueError("spec must be a JSON object")
    if doc.get("version") != 1:
        raise ValueError(f"unsupported spec version {doc.get('version')!r} "
                         "(expected 1)")
    objs = doc.get("objectives")
    if not isinstance(objs, list) or not objs:
        raise ValueError("spec needs a non-empty 'objectives' list")
    seen = set()
    out = []
    for i, o in enumerate(objs):
        where = f"objectives[{i}]"
        if not isinstance(o, dict):
            raise ValueError(f"{where}: must be an object")
        name = o.get("name")
        if not name or not isinstance(name, str):
            raise ValueError(f"{where}: needs a string 'name'")
        if name in seen:
            raise ValueError(f"{where}: duplicate objective name {name!r}")
        seen.add(name)
        event = o.get("event")
        if not event or not isinstance(event, str):
            raise ValueError(f"{where} ({name}): needs a string 'event' "
                             "(the bus kind sampled)")
        target = o.get("target")
        if not isinstance(target, (int, float)) or not 0.0 < target < 1.0:
            raise ValueError(f"{where} ({name}): 'target' must be a "
                             "fraction in (0, 1)")
        field = o.get("field")
        if field is not None and not isinstance(field, str):
            raise ValueError(f"{where} ({name}): 'field' must be a string "
                             "payload key or null")
        op = o.get("op", "<=")
        if op not in _OPS:
            raise ValueError(f"{where} ({name}): 'op' must be one of "
                             f"{_OPS}")
        threshold = o.get("threshold")
        if field is not None and not isinstance(threshold, (int, float)):
            raise ValueError(f"{where} ({name}): a value objective "
                             "(field set) needs a numeric 'threshold'")
        windows = o.get("windows_s", [60, 300])
        if (not isinstance(windows, list) or not windows
                or not all(isinstance(w, (int, float)) and w > 0
                           for w in windows)):
            raise ValueError(f"{where} ({name}): 'windows_s' must be a "
                             "non-empty list of positive seconds")
        bad_kinds = o.get("bad_kinds", [])
        if not isinstance(bad_kinds, list) \
                or not all(isinstance(k, str) for k in bad_kinds):
            raise ValueError(f"{where} ({name}): 'bad_kinds' must be a "
                             "list of event kinds")
        out.append(SloObjective(
            name=name, event=event, target=float(target), field=field,
            op=op,
            threshold=(float(threshold)
                       if isinstance(threshold, (int, float)) else None),
            bad_kinds=tuple(bad_kinds),
            windows_s=tuple(sorted(float(w) for w in windows)),
            burn_alert=float(o.get("burn_alert", 10.0)),
            min_samples=int(o.get("min_samples", 10)),
            description=str(o.get("description", ""))))
    interval = doc.get("eval_interval_s", 30.0)
    if not isinstance(interval, (int, float)) or interval <= 0:
        raise ValueError("'eval_interval_s' must be positive seconds")
    return SloSpec(objectives=tuple(out), eval_interval_s=float(interval))


def load_slo_spec(path: str) -> "SloSpec":
    """Read + validate a spec file; ``ValueError`` on unparsable JSON so
    callers handle one exception family for 'bad spec'."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON ({e})") from None
    try:
        return parse_slo_spec(doc)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


@dataclasses.dataclass(frozen=True)
class SloSpec:
    objectives: Tuple[SloObjective, ...]
    eval_interval_s: float = 30.0
    version: int = 1


class _ObjectiveState:
    """Sliding sample log + run totals for one objective."""

    def __init__(self, obj: SloObjective):
        self.obj = obj
        self.samples: deque = deque()  # (ts, good_n, bad_n)
        self.total_good = 0
        self.total_bad = 0
        self.last_value: Optional[float] = None

    def add(self, ts: float, good: int, bad: int) -> None:
        self.samples.append((ts, good, bad))
        self.total_good += good
        self.total_bad += bad

    def prune(self, now: float) -> None:
        floor = now - max(self.obj.windows_s)
        while self.samples and self.samples[0][0] < floor:
            self.samples.popleft()

    def window_counts(self, now: float, window_s: float) -> Tuple[int, int]:
        floor = now - window_s
        good = bad = 0
        for ts, g, b in reversed(self.samples):
            if ts < floor:
                break
            good += g
            bad += b
        return good, bad

    def burn(self, now: float, window_s: float) -> dict:
        """Burn over one window: ``bad_frac / budget``, or None below
        ``min_samples`` (an empty window must read as "not enough data",
        never as "healthy" OR "violating")."""
        good, bad = self.window_counts(now, window_s)
        n = good + bad
        out = {"good": good, "bad": bad, "samples": n, "burn": None}
        if n >= self.obj.min_samples:
            out["burn"] = round((bad / n) / max(self.obj.budget, 1e-9), 4)
        return out


class SloEngine:
    """The evaluator: a bus watcher maintaining per-objective windows.

    telemetry: where ``slo.burn`` events go (None for offline replay —
    :func:`grade_events` reads the returned payloads directly).
    Thread-safe: sampling happens on whichever thread emits, evaluation
    payloads are computed under the lock and emitted outside it (the
    emission re-enters the watcher list; the refreshed ``_last_eval``
    time gate makes that re-entry a no-op).
    """

    def __init__(self, spec: SloSpec, telemetry=None):
        self.spec = spec
        self._tel = telemetry
        self._lock = threading.Lock()
        self._state = {o.name: _ObjectiveState(o) for o in spec.objectives}
        self._last_eval: Optional[float] = None
        self.alerts_total = 0

    # -- sampling ---------------------------------------------------------
    def _sample(self, obj: SloObjective, st: _ObjectiveState,
                kind: str, ts: float, payload: dict) -> None:
        if kind == obj.event:
            if obj.field is None:
                st.add(ts, 1, 0)  # each event is one good; bad_kinds count
                return
            v = payload.get(obj.field)
            values = v if isinstance(v, (list, tuple)) else (v,)
            good = bad = 0
            last = None
            for x in values:
                if not isinstance(x, (int, float)) or isinstance(x, bool):
                    continue
                last = float(x)
                if obj.good(last):
                    good += 1
                else:
                    bad += 1
            if good or bad:
                st.add(ts, good, bad)
                st.last_value = last
        elif kind in obj.bad_kinds:
            n = payload.get("count", 1)
            n = int(n) if isinstance(n, (int, float)) else 1
            st.add(ts, 0, max(n, 1))

    def on_event(self, event: dict) -> Optional[List[dict]]:
        """``Telemetry.watchers`` hook.  Samples the event, and — when
        ``eval_interval_s`` has elapsed on the EVENT clock — evaluates,
        emits, and returns the evaluation payloads (live callers ignore
        the return; the offline replay collects it)."""
        kind = event.get("kind", "")
        if kind.startswith("slo.") or kind.startswith("incident."):
            return None  # our own output must not feed our input
        ts = event.get("ts")
        if not isinstance(ts, (int, float)):
            return None
        with self._lock:
            for st in self._state.values():
                self._sample(st.obj, st, kind, float(ts), event.get(
                    "payload", {}))
            if self._last_eval is None:
                # anchor the gate at the first event; evaluating a
                # single-sample stream would only emit noise
                self._last_eval = float(ts)
                return None
            due = float(ts) - self._last_eval >= self.spec.eval_interval_s
            if due:
                # claim the interval INSIDE the lock: two threads
                # emitting just past the boundary must not both see
                # `due` and double-evaluate (double slo.burn events,
                # inflated alert counters)
                self._last_eval = float(ts)
        if not due:
            return None
        return self.evaluate(float(ts))

    # -- evaluation -------------------------------------------------------
    def evaluate(self, now: float) -> List[dict]:
        """Compute every objective's multi-window burn at ``now``; emit
        one ``slo.burn`` event per objective that has ever sampled (a
        spec may declare serve objectives a train run never feeds — those
        stay silent rather than emitting empty noise forever)."""
        with self._lock:
            self._last_eval = now
            payloads = []
            for name, st in self._state.items():
                st.prune(now)
                if st.total_good + st.total_bad == 0:
                    continue
                obj = st.obj
                windows = {str(int(w)): st.burn(now, w)
                           for w in obj.windows_s}
                burns = [w["burn"] for w in windows.values()
                         if w["burn"] is not None]
                alerting = (len(burns) == len(windows) and bool(burns)
                            and all(b >= obj.burn_alert for b in burns))
                if alerting:
                    self.alerts_total += 1
                payloads.append({
                    "objective": name,
                    "target": obj.target,
                    "op": obj.op,
                    "threshold": obj.threshold,
                    "burn_alert": obj.burn_alert,
                    "windows": windows,
                    "burn_max": max(burns) if burns else None,
                    "burn_min": min(burns) if burns else None,
                    "alerting": alerting,
                    "last_value": st.last_value,
                    "run_good": st.total_good,
                    "run_bad": st.total_bad,
                })
        if self._tel is not None:
            # outside the lock: the emit fans back through the watcher
            # list (incident trigger on alerting burns) and into sinks
            for p in payloads:
                self._tel.emit("slo.burn", **p)
        return payloads

    def run_totals(self) -> Dict[str, Tuple[int, int]]:
        """(good, bad) over the whole run per objective — the offline
        grader's budget check (never pruned)."""
        with self._lock:
            return {name: (st.total_good, st.total_bad)
                    for name, st in self._state.items()}

    def close(self) -> None:
        """Final evaluation at the last seen event time, so a run's tail
        window is graded and the last ``slo.burn`` is in the artifact."""
        with self._lock:
            last = self._last_eval
        if last is not None:
            self.evaluate(last)


def replay_evals(events: Sequence[dict], spec: SloSpec,
                 engine: Optional[SloEngine] = None
                 ) -> Tuple[SloEngine, List[Tuple[float, dict]]]:
    """The offline feed loop, factored so the fleet collector's
    bit-identity oracle IS this code: sort by ``ts`` (Python's stable
    sort — equal timestamps keep input order, which for concatenated
    per-host files means (host, line) order), feed every ts-carrying
    event, tail-evaluate at the final event time unless that event
    itself just evaluated.  Returns the engine and every
    ``(eval_ts, payload)`` pair."""
    if engine is None:
        engine = SloEngine(spec, telemetry=None)
    ordered = sorted((e for e in events
                      if isinstance(e.get("ts"), (int, float))),
                     key=lambda e: e["ts"])
    evals: List[Tuple[float, dict]] = []
    for e in ordered:
        out = engine.on_event(e)
        if out:
            evals.extend((e["ts"], p) for p in out)
    if ordered:
        # tail evaluation at the final event time — unless the final
        # event itself just evaluated (double-counting its alerts)
        last_ts = float(ordered[-1]["ts"])
        evals.extend((last_ts, p)
                     for p in tail_evaluate(engine, last_ts))
    engine._replay_events = len(ordered)
    return engine, evals


def tail_evaluate(engine: SloEngine, last_ts: float) -> List[dict]:
    """Final evaluation at ``last_ts`` — a no-op when the last event
    already evaluated there (the exact rule :func:`replay_evals` uses;
    the live collector's drain calls this so its closing evaluation is
    bit-identical to the offline tail)."""
    with engine._lock:
        already = (engine._last_eval is not None
                   and engine._last_eval >= last_ts)
    return [] if already else engine.evaluate(last_ts)


def grade_events(events: Sequence[dict], spec: SloSpec) -> dict:
    """Offline replay: feed a finished run's events (any order; sorted
    here by ``ts``) through the SAME engine arithmetic, collect every
    evaluation, and grade two ways:

    * **fast burn** — any evaluation where an objective alerted: the
      violation names the objective and its windows (the live pager
      would have fired there).
    * **budget** — the run-total bad fraction exceeds the objective's
      error budget (needs ``min_samples`` total): the run as a whole
      blew its objective even if no single window alerted.

    Returns ``{"objectives": {...}, "violations": [...],
    "evaluations": n, "events": n}`` — ``tools/slo_report.py`` renders
    it and exits 1 on any violation."""
    engine, evals = replay_evals(events, spec)
    return aggregate_grade(spec, evals, engine.run_totals(),
                           n_events=engine._replay_events)


def aggregate_grade(spec: SloSpec, evals: Sequence[Tuple[float, dict]],
                    totals: Dict[str, Tuple[int, int]], *,
                    n_events: int) -> dict:
    """Fold evaluation payloads + run totals into the grade dict —
    shared verbatim by :func:`grade_events` (offline) and the fleet
    collector's live verdict (``obs/collector.py``), so "live == replay"
    is a property of the inputs, never of two graders drifting."""
    objectives: dict = {}
    violations: List[dict] = []
    for obj in spec.objectives:
        good, bad = totals.get(obj.name, (0, 0))
        n = good + bad
        worst: Dict[str, float] = {}
        alert_evals = 0
        first_alert_ts = None
        for ts, p in evals:
            if p["objective"] != obj.name:
                continue
            if p["alerting"]:
                alert_evals += 1
                if first_alert_ts is None:
                    first_alert_ts = ts
            for w, info in p["windows"].items():
                if info["burn"] is not None:
                    worst[w] = max(worst.get(w, 0.0), info["burn"])
        bad_frac = (bad / n) if n else None
        row = {
            "samples": n, "good": good, "bad": bad,
            "bad_frac": round(bad_frac, 6) if bad_frac is not None else None,
            "budget": round(obj.budget, 6),
            "target": obj.target,
            "worst_burn": {w: worst[w] for w in sorted(worst)},
            "alert_evaluations": alert_evals,
            "graded": n >= obj.min_samples,
        }
        objectives[obj.name] = row
        if alert_evals:
            widest = max(obj.windows_s)
            violations.append({
                "objective": obj.name, "kind": "fast_burn",
                "window": "+".join(str(int(w)) for w in obj.windows_s),
                "burn": max(worst.values()) if worst else None,
                "burn_alert": obj.burn_alert,
                "first_at_ts": first_alert_ts,
                "evaluations": alert_evals,
                "detail": (f"burn >= {obj.burn_alert} on every window "
                           f"(up to {int(widest)}s) in {alert_evals} "
                           f"evaluation(s)"),
            })
        elif row["graded"] and bad_frac is not None \
                and bad_frac > obj.budget:
            violations.append({
                "objective": obj.name, "kind": "budget", "window": "run",
                "bad_frac": round(bad_frac, 6),
                "budget": round(obj.budget, 6),
                "detail": (f"run bad fraction {bad_frac:.4g} exceeds the "
                           f"{obj.budget:.4g} error budget "
                           f"(target {obj.target})"),
            })
    return {"objectives": objectives, "violations": violations,
            "evaluations": len(evals), "events": n_events}
