"""One cost-priced scheduling core under train, eval and serve
(counterpart of ``can_tpu/sched/core.py``, line for line: pure Python, no
torch).

Built on the offline planner's pricing function
(``data/planner.py::PlanCostModel``, ``plan_cost = area * padded_slots +
launch_cost * n_launches``), it gives the other batch-formation engines
the same prices:

* **Priced sub-batch menu** (``select_menu`` / ``ServeSched``): serving
  warms a small menu of batch sizes chosen by the cost model under a
  program-count budget, and every flush is covered by the planner's exact
  ``decompose`` DP over that menu — a 2-request flush launches a 2-slot
  batch instead of padding to ``max_batch``.  The menu is static and
  warmed up front, so the engine's signature count stays ``buckets x
  dtypes x len(menu)``.
* **Priced flush deadlines** (``ServeSched.flush_at``): a group flushes
  when it fills the top menu size, when one more request saves no model
  cost (``coalesce_gain <= 0``), or when the bucket's observed arrival
  rate says the next request is not expected inside the window;
  ``max_wait_ms`` is the latency cap, and with no rate estimate yet the
  policy is the old timer.
* **Cost/deadline-aware dispatch ordering** (``pick_work``):
  deadline-pressured work earliest-deadline-first, starving or
  redispatched work oldest-first, everything else cheapest-first, with
  the stream pin as a preference.
* **Predicted == realized cost**: every dispatched batch's slot count
  equals the core's predicted cover (``cover_one``); the service records
  both costs per batch (``costs_match`` is the one comparison).
* **Priced prefetch depth** (``prefetch_depth`` / ``prefetch_depth_for``)
  for the train and eval input pipelines.

Determinism (exact tie rules, the same float operations in the same
order) is load-bearing: menus, covers, flush times and picks equal the
JAX package's (tests/test_torch_sched.py).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

from can_tpu_torch.data.planner import GlobalPlanner, PlanCostModel, decompose

# Default program-count budget per (bucket, dtype) for the serve menu:
# three sizes cover the flush-size distribution well (the expected-cost
# curve is flat past 3) while keeping warmup small.
DEFAULT_MENU_BUDGET = 3
# Fixed cost of one serve launch in SLOT-equivalents (the per-launch
# dispatch overhead divided by one slot's compute at the bucket shape).
# 0.25 means "one extra launch costs a quarter of a slot": small enough
# that exact-size launches win at low fill, large enough that the DP
# never shatters a flush into per-request launches.
DEFAULT_LAUNCH_COST_SLOTS = 0.25
# Arrival-gap EWMA: how many observed interarrivals before the estimate
# is trusted (below this the flush policy is the legacy timer), and the
# smoothing factor (~last 8 arrivals dominate).
MIN_GAP_INTERVALS = 3
GAP_EWMA_ALPHA = 0.25
# How many expected interarrival gaps the policy will wait for one more
# request before declaring the arrival overdue and flushing.
DEFAULT_WAIT_GAP_FACTOR = 2.0


# -- priced sub-batch menu -------------------------------------------------
def cover_cost(n: int, menu: Tuple[int, ...],
               launch_cost_slots: float) -> float:
    """Model cost (in slot units) of serving one flush of ``n`` requests
    with launch sizes from ``menu`` — the offline planner's ``decompose``
    DP at unit area: ``slots + launch_cost_slots * launches``."""
    parts = decompose(n, menu, 1.0, launch_cost_slots)
    return sum(parts) + launch_cost_slots * len(parts)


def _cover_costs(max_n: int, menu: Tuple[int, ...],
                 lc: float) -> list:
    """``[cover_cost(n, menu, lc) for n in 1..max_n]`` from ONE bottom-up
    DP pass (the same recurrence ``decompose`` runs, read out at every
    n instead of once) — ``select_menu`` scores each candidate menu over
    every flush size, and re-running the full DP per n made the search
    O(max_batch^2) per menu (measured: minutes at --max-batch 64)."""
    best = [0.0] * (max_n + 1)
    for r in range(1, max_n + 1):
        best[r] = min((s if r <= s else s + best[r - s]) + lc
                      for s in menu)
    return best[1:]


def costs_match(predicted, realized, *, tol: float = 1e-6) -> bool:
    """THE predicted==realized comparison, owned by the module that owns
    the invariant: the gauge sink, the report, and the bench receipt all
    call this — three hand-rolled epsilon checks could silently disagree
    about whether the invariant held."""
    if predicted is None or realized is None:
        return True  # a record without a cost pair: nothing to judge
    return abs(float(predicted) - float(realized)) <= tol


def select_menu(max_batch: int, *, budget: int = DEFAULT_MENU_BUDGET,
                launch_cost_slots: float = DEFAULT_LAUNCH_COST_SLOTS,
                weights: Optional[Sequence[float]] = None
                ) -> Tuple[int, ...]:
    """The priced sub-batch menu: up to ``budget`` launch sizes (always
    including ``max_batch`` — the full-batch path must exist) minimising
    the expected flush cost ``sum_n w[n] * cover_cost(n, menu)`` over
    flush sizes ``n = 1..max_batch``.

    ``weights[n-1]`` weights flush size ``n`` (default uniform — the
    agnostic prior; a deployment that knows its load shape can pass its
    histogram).  Exact subset search (``max_batch`` is single digits for
    serving); ties prefer FEWER sizes, then the lexicographically
    smallest descending tuple — the same determinism rule as the offline
    planner's decompose.  Returns sizes descending."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if budget < 1:
        raise ValueError(f"menu budget must be >= 1, got {budget}")
    if weights is None:
        w = [1.0] * max_batch
    else:
        w = [float(x) for x in weights]
        if len(w) != max_batch:
            raise ValueError(f"weights must have max_batch={max_batch} "
                             f"entries, got {len(w)}")
    smaller = list(range(max_batch - 1, 0, -1))  # descending, sans top
    best = None
    for k in range(0, min(budget - 1, len(smaller)) + 1):
        for extra in itertools.combinations(smaller, k):
            menu = (max_batch,) + extra
            costs = _cover_costs(max_batch, menu, launch_cost_slots)
            cost = sum(wn * cn for wn, cn in zip(w, costs))
            key = (cost, len(menu), menu)
            if best is None or key < best:
                best = key
    return best[2]


def default_serve_menu(max_batch: int, *,
                       budget: int = DEFAULT_MENU_BUDGET) -> Tuple[int, ...]:
    """THE serve menu registry: the batch sizes every serve consumer
    (the service's ``ServeSched``, hence the engine's warmup) derives
    from one call, so warmed sizes and dispatched sizes cannot diverge."""
    return select_menu(max_batch, budget=budget)


class ServeSched:
    """The serving instance of the core: one menu + flush pricing + the
    predicted-cost function, shared by the MicroBatcher (flush decisions,
    sub-batch covers) and CountService (predicted-vs-realized accounting
    on every ``serve.batch`` event).

    max_wait_s is the latency CAP the priced deadline can never exceed
    (the old timer's only surviving role); ``priced_flush=False`` keeps
    the timer as the flush trigger while the menu still prices sizes
    (the legacy escape hatch the CLI's ``--flush-policy timer`` wires).
    """

    def __init__(self, max_batch: int, *, max_wait_s: float,
                 menu: Optional[Tuple[int, ...]] = None,
                 menu_budget: int = DEFAULT_MENU_BUDGET,
                 launch_cost_slots: float = DEFAULT_LAUNCH_COST_SLOTS,
                 priced_flush: bool = True,
                 wait_gap_factor: float = DEFAULT_WAIT_GAP_FACTOR,
                 min_gap_intervals: int = MIN_GAP_INTERVALS):
        self.max_batch = int(max_batch)
        self.menu = (tuple(sorted(menu, reverse=True)) if menu is not None
                     else default_serve_menu(max_batch, budget=menu_budget))
        if max(self.menu) != self.max_batch:
            raise ValueError(
                f"menu {self.menu} must top out at max_batch="
                f"{self.max_batch}: the full-batch program is the high-"
                f"load path and must exist")
        # the shared pricing function, at unit area (serve flushes are
        # within one bucket; the bucket's pixel area scales predicted and
        # realized cost identically, so slot units price the DECISIONS
        # and the px conversion happens only in the emitted costs)
        self.model = PlanCostModel(menu=self.menu,
                                   launch_cost_px=float(launch_cost_slots))
        self.launch_cost_slots = float(launch_cost_slots)
        self.max_wait_s = float(max_wait_s)
        self.priced_flush = bool(priced_flush)
        self.wait_gap_factor = float(wait_gap_factor)
        self.min_gap_intervals = int(min_gap_intervals)
        # per group key: (ewma gap seconds, intervals seen, last arrival
        # ts).  Touched only from the batcher pump thread.
        self._gaps: Dict[object, Tuple[float, int, float]] = {}

    # -- sizes -----------------------------------------------------------
    def parts_for(self, n: int) -> Tuple[int, ...]:
        """Launch sizes covering a flush of ``n`` requests, descending
        (the planner DP; fill lands in the final part)."""
        return self.model.parts((1, 1), n)

    def cover_one(self, n: int) -> int:
        """Slot count of a single launch holding ``n`` valid requests —
        the smallest menu size covering ``n``.  Every batch the core
        dispatches satisfies ``batch_slots == cover_one(valid)`` (each
        DP part is either exactly full or the tail whose size is its
        remainder's cheapest single-launch cover), which is the
        predicted==realized invariant serve.batch events carry."""
        fits = [s for s in self.menu if s >= n]
        return min(fits) if fits else max(self.menu)

    def predicted_cost_px(self, area_px: float, valid: int) -> float:
        """Model cost of the launch the core predicts for ``valid``
        requests at a bucket of ``area_px`` pixels."""
        return float(area_px) * (self.cover_one(valid)
                                 + self.launch_cost_slots)

    def realized_cost_px(self, area_px: float, slots: int) -> float:
        """Model cost of the launch that actually ran."""
        return float(area_px) * (int(slots) + self.launch_cost_slots)

    def coalesce_gain(self, n: int) -> float:
        """Slot-units saved by one more request joining this flush
        instead of launching alone later: ``C(n) + C(1) - C(n+1)``.
        ``<= 0`` means waiting cannot beat launch-cost amortization —
        flush now."""
        if n >= self.max_batch:
            return 0.0
        c = lambda k: cover_cost(k, self.menu, self.launch_cost_slots)  # noqa: E731
        return c(n) + c(1) - c(n + 1)

    # -- arrival-rate estimate + the priced flush deadline ---------------
    def observe_arrival(self, key, t: float) -> None:
        got = self._gaps.get(key)
        if got is None:
            self._gaps[key] = (0.0, 0, t)
            return
        ewma, n, t_last = got
        gap = max(t - t_last, 0.0)
        ewma = gap if n == 0 else (1 - GAP_EWMA_ALPHA) * ewma \
            + GAP_EWMA_ALPHA * gap
        self._gaps[key] = (ewma, n + 1, t)

    def expected_gap(self, key) -> Optional[float]:
        got = self._gaps.get(key)
        if got is None or got[1] < self.min_gap_intervals:
            return None  # cold: not enough evidence to price the wait
        return got[0]

    def flush_at(self, key, n: int, t0: float, t_last: float,
                 now: float, deadline_ts: Optional[float] = None) -> float:
        """Absolute time this group should flush — the priced deadline.

        t0: oldest request's submit time (the latency cap anchors here);
        t_last: newest arrival; deadline_ts: the group's earliest request
        deadline (flushing after it serves nobody).  Returns ``now`` (or
        earlier) when the group should flush immediately."""
        window_end = t0 + self.max_wait_s
        if deadline_ts is not None:
            window_end = min(window_end, deadline_ts)
        if n >= max(self.menu):
            return now  # full: waiting buys nothing
        if not self.priced_flush:
            return window_end  # legacy timer
        if self.coalesce_gain(n) <= 1e-12:
            return now  # one more request saves no model cost
        gap = self.expected_gap(key)
        if gap is None:
            return window_end  # cold start degrades to the timer
        candidate = t_last + gap * self.wait_gap_factor
        if candidate > window_end:
            # the next arrival is not expected inside the window: waiting
            # longer cannot beat the amortization — flush now
            return now
        return candidate


# -- fleet dispatch ordering ----------------------------------------------
def normalize_sizes(max_batch: int, sizes=None) -> Tuple[int, ...]:
    """ONE menu normalisation for every consumer (engine warmup now; the
    fleet's warmup spec later): dedupe, sort descending; None means the
    single ``max_batch`` program (the service without a core)."""
    if sizes is None:
        return (int(max_batch),)
    return tuple(sorted({int(s) for s in sizes}, reverse=True))


def pick_work(items: Sequence, now: float, *,
              starvation_age_s: float = 2.0,
              pressure_s: float = 0.5,
              prefer: Optional[int] = None) -> int:
    """Index of the work item the fleet should run next: cheapest-
    feasible-first under deadline pressure.

    Three tiers, most critical first:

    * DEADLINE-PRESSURED — a live deadline within ``pressure_s``:
      earliest-deadline-first.  These launch now or their requests
      expire; nothing a deadline-less item could gain outranks that (a
      deadline-less batch cannot expire, only wait longer).
    * URGENT — a redispatched batch (its requests already waited
      through one failure) or age ``>= starvation_age_s``: oldest
      enqueue first.
    * RELAXED — everything else, cheapest model cost first (``area *
      slots``): small launches drain fast and keep p50 low while
      nothing is at risk.

    ``prefer`` is the pulling replica's index, for STICKY STREAM
    ROUTING (serve/streams.py): an item whose ``pin`` matches wins over
    an unpinned item, which wins over one pinned elsewhere — primary
    within the relaxed tier (locality is the relaxed tier's whole
    objective), a trailing tiebreak in the pressured/urgent tiers
    (correctness first: a deadline or a starvation bound always
    outranks cache affinity).  Preference, never exclusion — any
    replica may still take any item, so a pin can never starve a
    stream behind a dead or busy replica.

    The age promotion is the starvation bound: a relaxed item bypassed
    by cheaper work becomes urgent after ``starvation_age_s`` and from
    then on only genuinely expiring work jumps it, so no item waits
    more than ``starvation_age_s`` plus the deadline-pressured drain
    (tests/test_torch_sched.py holds it equal to JAX's).  Items must expose ``t_enqueue``,
    ``seq``, ``cost_px``, ``min_deadline`` (None ok),
    ``redispatches``; ``pin`` (a replica index or None) is optional —
    absent reads as unpinned, so pre-stream items rank exactly as
    before."""
    best_i = 0
    best_rank = None
    for i, it in enumerate(items):
        pin = getattr(it, "pin", None)
        aff = (1 if pin is None or prefer is None
               else (0 if pin == prefer else 2))
        dl = getattr(it, "min_deadline", None)
        if dl is not None and dl - now <= pressure_s:
            rank = (0, dl, aff, it.seq)
        elif (getattr(it, "redispatches", 0) > 0
                or now - it.t_enqueue >= starvation_age_s):
            rank = (1, it.t_enqueue, aff, it.seq)
        else:
            rank = (2, aff, it.cost_px, it.seq)
        if best_rank is None or rank < best_rank:
            best_rank, best_i = rank, i
    return best_i


# -- offline planner + prefetch consumers ---------------------------------
def offline_planner(model: PlanCostModel, *, max_buckets: int,
                    mode: str = "cost", warn=None) -> GlobalPlanner:
    """The offline engine's entry into the core: exactly the
    ``GlobalPlanner`` over the shared cost model — plans are identical to
    constructing it directly."""
    return GlobalPlanner(model, max_buckets=max_buckets, mode=mode,
                         warn=warn)


def prefetch_depth(launch_px: float, launch_cost_px: float, *,
                   lo: int = 2, hi: int = 4) -> int:
    """Priced prefetch depth for the train/eval input pipelines: enough
    batches in flight to hide the per-launch dispatch overhead behind
    device compute.  A launch whose fixed cost is a large fraction of
    its compute (tiny batches) needs deeper pipelining; big launches
    need only the classic double buffer.  ``1 + ceil(launch_cost /
    launch_compute)`` clamped to [lo, hi] — at the bench pricing
    (0.05 Mpx launch, ~1 Mpx batches) this is exactly the historical
    depth=2, so default behaviour is unchanged."""
    px = max(float(launch_px), 1.0)
    depth = 1 + int(-(-float(launch_cost_px) // px))
    return max(int(lo), min(int(hi), depth))


def prefetch_depth_for(batcher, *, epoch: int = 0, lo: int = 2,
                       hi: int = 4) -> int:
    """``prefetch_depth`` priced from a ``ShardedBatcher``'s own epoch
    schedule (mean pixels per launch) and its configured launch cost —
    the CLIs call this so the train AND eval input pipelines consume the
    same pricing the planner built the schedule with."""
    sched = batcher.global_schedule(epoch)
    if not sched:
        return int(lo)
    px = sum(k[0] * k[1] * len(g) for k, g in sched) / len(sched)
    return prefetch_depth(px, getattr(batcher, "launch_cost_px", 0.0),
                          lo=lo, hi=hi)
