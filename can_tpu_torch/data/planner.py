"""Cost-model batch planning for the bucketed schedule (counterpart of
``can_tpu/data/planner.py:55-489``).

One objective prices every launch plan, in pixels:

    plan_cost = area * padded_slots + launch_cost_px * n_launches

``launch_cost_px`` turns a step launch's fixed cost into pixel
equivalents (``cli/common.py``: the card's per-launch time times its
training rate).  The search is deterministic and covers:

* **per-cell batch size** — a cell whose full batch exceeds the
  ``max_launch_px`` memory cap prices every launch size that fits (whole
  cell at a lower batch against cap-to-menu decompositions);
* **remnant menu** — every multiple of the batch quantum up to the batch,
  so straggler groups launch at their exact size; the program budget
  drops sizes when the (shape, size) count would exceed ``max_buckets``;
* **group packing** — greedy pairwise merges at the elementwise-max join
  cell plus steepest-descent moves and extractions;
* **bucket boundaries** — ``ShardedBatcher._resolve_auto_buckets`` scores
  every ladder grid by the plan cost of the schedule it induces.

Everything is a pure function of the shape histogram and the config, so
the plan is the same in every epoch (the shuffle only decides which items
fill the slots) and equal to the JAX package's for the same inputs
(tests/test_torch_planner.py).

``mode="legacy"`` is the pre-cost-model planner, bit-compatible with the
JAX package's (tests/test_torch_legacy_plan.py): the largest fitting
full size, the power-of-two menu, pairwise merges and drops of the
smallest menu size only — the baseline arm of ``tools/plan_ablation.py``.
Host code: no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, List, NamedTuple, Optional, Tuple

Key = Tuple[int, int]


def decompose(n: int, menu: Tuple[int, ...], area: float = 1.0,
              launch_cost: float = 0.0) -> Tuple[int, ...]:
    """Cover ``n`` items with menu-size parts minimising ``area *
    total_slots + launch_cost * n_parts`` (exact bottom-up DP).  Ties
    prefer fewer launches, then the lexicographically smallest parts;
    parts return descending, so fill slots land in the last part."""
    base = (0.0, 0, ())
    best = [base] * (n + 1 if n > 0 else 1)
    for r in range(1, n + 1):
        best[r] = min(
            (area * s + launch_cost + sub[0], 1 + sub[1], (s,) + sub[2])
            for s in menu
            for sub in (best[r - s] if r > s else base,))
    return tuple(sorted(best[n if n > 0 else 0][2], reverse=True))


@dataclasses.dataclass(frozen=True)
class PlanCostModel:
    """The planner's one pricing function.

    menu: legal launch sizes, descending; each a multiple of the batch
      quantum.
    launch_cost_px: fixed cost of one step launch, in pixel equivalents.
    max_launch_px: device-memory ceiling per launch (batch * H * W), or
      None.
    """

    menu: Tuple[int, ...]
    launch_cost_px: float = 0.0
    max_launch_px: Optional[float] = None

    @staticmethod
    def area(key: Key) -> int:
        return key[0] * key[1]

    def fits(self, key: Key, size: int) -> bool:
        return (self.max_launch_px is None
                or size * self.area(key) <= self.max_launch_px)

    def fits_any(self, key: Key, menu: Optional[Tuple[int, ...]] = None) -> bool:
        return any(self.fits(key, s) for s in (menu or self.menu))

    def fitting(self, key: Key,
                menu: Optional[Tuple[int, ...]] = None) -> Tuple[int, ...]:
        """Menu filtered by the per-launch cap; the smallest size always
        survives (refusing the cell would drop data; the caller warns)."""
        menu = menu or self.menu
        kept = tuple(s for s in menu if self.fits(key, s))
        return kept or (min(menu),)

    def parts(self, key: Key, count: int,
              menu: Optional[Tuple[int, ...]] = None) -> Tuple[int, ...]:
        """Cheapest launch-size cover of ``count`` items in this cell."""
        return decompose(count, self.fitting(key, menu), float(self.area(key)),
                         self.launch_cost_px)

    def parts_cost(self, key: Key, parts: Tuple[int, ...]) -> float:
        return self.area(key) * sum(parts) + self.launch_cost_px * len(parts)

    def cell_cost(self, key: Key, count: int,
                  menu: Optional[Tuple[int, ...]] = None) -> float:
        return self.parts_cost(key, self.parts(key, count, menu))

    def full_size(self, key: Key, count: int) -> int:
        """Launch size of this cell's exactly-filled runs: each fitting
        size is priced over the whole cell (full chunks plus the cheapest
        cover of the rest) and the cheapest wins, the larger on a tie."""
        fit = self.fitting(key)
        if count <= 0 or len(fit) == 1:
            return max(fit)

        def whole_cell_cost(s: int) -> float:
            n_full = count // s
            rem = count - n_full * s
            cost = n_full * (self.area(key) * s + self.launch_cost_px)
            if rem:
                cost += self.cell_cost(key, rem)
            return cost

        return max(fit, key=lambda s: (-whole_cell_cost(s), s))


class PlannedGroup(NamedTuple):
    """One remnant launch group: stragglers of the ``sources`` cells run
    at the elementwise-max ``key`` in launches of sizes ``parts``."""

    key: Key
    sources: Tuple[Key, ...]
    count: int
    parts: Tuple[int, ...]


class Plan(NamedTuple):
    """An epoch-invariant launch plan for one shape histogram."""

    full_parts: Dict[Key, Tuple[int, ...]]  # exactly-filled launches per cell
    groups: Tuple[PlannedGroup, ...]        # remnant groups (may hold fill)
    menu: Tuple[int, ...]                   # after any budget drops
    programs: FrozenSet[Tuple[Key, int]]    # distinct (shape, size) pairs
    cost: float                             # model cost of the whole plan
    scheduled_px: float                     # area * slots over all launches
    launches: int
    legacy_fallback: bool = False           # pad-to-batch path was cheaper

    @property
    def lowered_cells(self) -> int:
        """Cells whose full runs launch below the top menu size."""
        if not self.full_parts:
            return 0
        top = max(self.menu)
        return sum(1 for parts in self.full_parts.values()
                   if parts and parts[0] < top)

    @property
    def lowered_launches(self) -> int:
        if not self.full_parts:
            return 0
        top = max(self.menu)
        return sum(sum(1 for p in parts if p < top)
                   for parts in self.full_parts.values())


def merge_partial_groups(partials, gbs: int):
    """Improvement-only pairwise merging of partial batch groups (the
    pad-every-straggler path): merge the pair whose union, at the join
    bucket, costs fewer padded pixels than the two apart; stop when no
    merge improves.  Inputs arrive key-sorted and ties pick the first
    pair, so the result is deterministic."""

    def cost(key, n_items):
        return key[0] * key[1] * gbs * (-(-n_items // gbs))

    partials = [(k, list(g)) for k, g in partials]
    full = []
    while len(partials) > 1:
        best = None
        for i in range(len(partials)):
            ki, gi = partials[i]
            for j in range(i + 1, len(partials)):
                kj, gj = partials[j]
                join = (max(ki[0], kj[0]), max(ki[1], kj[1]))
                gain = (cost(ki, len(gi)) + cost(kj, len(gj))
                        - cost(join, len(gi) + len(gj)))
                if gain > 0 and (best is None or gain > best[0]):
                    best = (gain, i, j, join)
        if best is None:
            break
        _, i, j, join = best
        merged = partials[i][1] + partials[j][1]
        partials = [p for t, p in enumerate(partials) if t not in (i, j)]
        # an improving merge never overflows gbs; full batches peel off
        # all the same, so a change of the cost can not emit one
        while len(merged) > gbs:
            full.append((join, merged[:gbs]))
            merged = merged[gbs:]
        if merged:
            partials.append((join, merged))
    return full + partials


class GlobalPlanner:
    """Search the joint plan space for one shape-count histogram.

    mode="cost" (default): full-cell size pricing, exact-size menus,
    merge + move/extract local search, drop-any-size budget lever.
    mode="legacy": the pre-cost-model heuristics — the largest fitting
    full size, no local search, only the smallest menu size dropped.
    """

    def __init__(self, model: PlanCostModel, *, max_buckets: int,
                 mode: str = "cost",
                 warn: Optional[Callable[[str], None]] = None):
        if mode not in ("cost", "legacy"):
            raise ValueError(f"unknown planner mode {mode!r}")
        self.model = model
        self.max_buckets = int(max_buckets)
        self.mode = mode
        self.warn = warn or (lambda msg: None)
        self._parts_cache: Dict[Tuple, Tuple[int, ...]] = {}
        self._floor_warned: set = set()

    def _parts(self, key: Key, count: int,
               menu: Tuple[int, ...]) -> Tuple[int, ...]:
        ck = (key, count, menu)
        got = self._parts_cache.get(ck)
        if got is None:
            got = self._parts_cache[ck] = self.model.parts(key, count, menu)
        return got

    def _cost(self, key: Key, count: int, menu: Tuple[int, ...]) -> float:
        return self.model.parts_cost(key, self._parts(key, count, menu))

    def plan(self, counts: Dict[Key, int]) -> Plan:
        model = self.model
        menu = tuple(sorted(model.menu, reverse=True))

        full_parts: Dict[Key, Tuple[int, ...]] = {}
        pool: List[Tuple[Key, int]] = []  # (cell key, remnant count)
        for k, c in sorted(counts.items()):
            cf = (model.full_size(k, c) if self.mode == "cost"
                  else max(model.fitting(k)))
            if not model.fits(k, min(menu)) and k not in self._floor_warned:
                self._floor_warned.add(k)
                self.warn(
                    f"bucket {k[0]}x{k[1]} exceeds the per-launch pixel cap "
                    f"even at the minimum batch {min(menu)} "
                    f"({min(menu) * model.area(k) / 1e6:.1f} Mpx > "
                    f"{(model.max_launch_px or 0) / 1e6:.1f} Mpx) — "
                    f"launching anyway; expect memory pressure (shrink "
                    f"batch_quantum or image sizes)")
            if c >= cf:
                full_parts[k] = (cf,) * (c // cf)
            if c % cf:
                pool.append((k, c % cf))

        groups: List[FrozenSet[int]] = [frozenset({i})
                                        for i in range(len(pool))]

        def join_of(srcs: FrozenSet[int]) -> Key:
            return (max(pool[i][0][0] for i in srcs),
                    max(pool[i][0][1] for i in srcs))

        def count_of(srcs: FrozenSet[int]) -> int:
            return sum(pool[i][1] for i in srcs)

        def gcost(srcs: FrozenSet[int], m: Tuple[int, ...]) -> float:
            if not srcs:
                return 0.0
            return self._cost(join_of(srcs), count_of(srcs), m)

        def gfits(srcs: FrozenSet[int], m: Tuple[int, ...]) -> bool:
            # the no-OOM promise outranks the program budget: never make a
            # join cell with no launch size under the cap
            return model.fits_any(join_of(srcs), m)

        def programs_of(m: Tuple[int, ...]) -> FrozenSet[Tuple[Key, int]]:
            ps = {(k, s) for k, parts in full_parts.items() for s in parts}
            for g in groups:
                j = join_of(g)
                ps.update((j, s) for s in self._parts(j, count_of(g), m))
            return frozenset(ps)

        def resort():
            # the candidate order (hence tie-breaking) must not depend on
            # the history of the levers
            groups.sort(key=lambda g: (join_of(g), count_of(g),
                                       tuple(sorted(pool[i][0]
                                                    for i in g))))

        # Phase A — steepest descent: MERGE two groups, MOVE one source
        # cell between groups or EXTRACT one, most negative cost delta
        # first; the cost falls strictly over a finite space, so it ends.
        # Cost mode only.
        if self.mode == "cost":
            while True:
                best = None
                for i in range(len(groups)):
                    for j in range(i + 1, len(groups)):
                        u = groups[i] | groups[j]
                        if not gfits(u, menu):
                            continue
                        d = (gcost(u, menu) - gcost(groups[i], menu)
                             - gcost(groups[j], menu))
                        if d < -1e-9 and (best is None or d < best[0]):
                            best = (d, "merge", (i, j))
                    if len(groups[i]) <= 1:
                        continue
                    for s in sorted(groups[i]):
                        rest = groups[i] - {s}
                        base_d = gcost(rest, menu) - gcost(groups[i], menu)
                        for j in range(len(groups)):
                            if j == i:
                                continue
                            u = groups[j] | {s}
                            if not gfits(u, menu):
                                continue
                            d = (base_d + gcost(u, menu)
                                 - gcost(groups[j], menu))
                            if d < -1e-9 and (best is None or d < best[0]):
                                best = (d, "move", (i, j, s))
                        d = base_d + gcost(frozenset({s}), menu)
                        if d < -1e-9 and (best is None or d < best[0]):
                            best = (d, "extract", (i, s))
                if best is None:
                    break
                _, lever, payload = best
                if lever == "merge":
                    i, j = payload
                    groups[i] = groups[i] | groups[j]
                    groups.pop(j)
                elif lever == "move":
                    i, j, s = payload
                    groups[j] = groups[j] | {s}
                    groups[i] = groups[i] - {s}
                    groups = [g for g in groups if g]
                else:
                    i, s = payload
                    groups[i] = groups[i] - {s}
                    groups.append(frozenset({s}))
                    groups = [g for g in groups if g]
                resort()

        # Phase B — the budget loop: improving merges always apply; forced
        # merges and menu drops only while the program count exceeds
        # max_buckets.  Merges shrink the groups and drops the menu, so it
        # ends too.
        while True:
            over = len(programs_of(menu)) > self.max_buckets
            best = None  # (delta, lever, payload)
            for i in range(len(groups)):
                for j in range(i + 1, len(groups)):
                    u = groups[i] | groups[j]
                    if not gfits(u, menu):
                        continue
                    d = (gcost(u, menu)
                         - gcost(groups[i], menu) - gcost(groups[j], menu))
                    if (d < -1e-9 or over) and (best is None or d < best[0]):
                        best = (d, "merge", (i, j))
            if over and len(menu) > 1:
                # drop a menu size but the quantum, if every current group
                # keeps a launch size under the cap: any size in cost
                # mode, only the smallest (the last) in legacy mode
                droppable = (range(len(menu) - 1) if self.mode == "cost"
                             else (len(menu) - 1,))
                for di in droppable:
                    m2 = menu[:di] + menu[di + 1:]
                    if not all(gfits(g, m2) for g in groups):
                        continue
                    d = (sum(gcost(g, m2) for g in groups)
                         - sum(gcost(g, menu) for g in groups))
                    if best is None or d < best[0]:
                        best = (d, "drop", di)
            if best is None or (best[0] >= -1e-9 and not over):
                if over:
                    self.warn(
                        f"{len(programs_of(menu))} programs exceed "
                        f"max_buckets={self.max_buckets} — the per-launch "
                        f"pixel cap prevents further merging")
                break
            _, lever, payload = best
            if lever == "merge":
                i, j = payload
                groups[i] = groups[i] | groups[j]
                groups.pop(j)
            else:
                menu = menu[:payload] + menu[payload + 1:]
            resort()

        planned = tuple(sorted(
            PlannedGroup(join_of(g),
                         tuple(sorted({pool[i][0] for i in g})),
                         count_of(g),
                         self._parts(join_of(g), count_of(g), menu))
            for g in groups))
        scheduled = (sum(model.area(k) * sum(parts)
                         for k, parts in full_parts.items())
                     + sum(model.area(pg.key) * sum(pg.parts)
                           for pg in planned))
        launches = (sum(len(p) for p in full_parts.values())
                    + sum(len(pg.parts) for pg in planned))
        return Plan(full_parts=full_parts, groups=planned, menu=menu,
                    programs=programs_of(menu),
                    cost=scheduled + model.launch_cost_px * launches,
                    scheduled_px=float(scheduled), launches=launches)

    def plan_with_fallback(self, counts: Dict[Key, int]) -> Plan:
        """``plan``, unless (without a cap) padding every straggler group
        to the full batch costs less: then that schedule, as a Plan with
        its real pixels, launches and programs.  Under a cap the net is
        skipped (the full batch is what a capped cell must not launch)."""
        plan = self.plan(counts)
        if self.model.max_launch_px is not None:
            return plan
        legacy = self._pad_plan(counts)
        if legacy is not None and legacy.cost < plan.cost:
            return legacy
        return plan

    def _pad_plan(self, counts: Dict[Key, int]) -> Optional[Plan]:
        """The pad-every-straggler-to-the-batch schedule as a Plan."""
        gbs = max(self.model.menu)
        lc = self.model.launch_cost_px
        partials = [(k, [(k, True)] * (c % gbs))
                    for k, c in sorted(counts.items()) if c % gbs]
        if not partials:
            return None
        merged = merge_partial_groups(partials, gbs)
        full = {k: (gbs,) * (c // gbs)
                for k, c in sorted(counts.items()) if c >= gbs}
        launches = (sum(len(p) for p in full.values())
                    + sum(-(-len(g) // gbs) for _, g in merged))
        scheduled = (sum(self.model.area(k) * sum(p)
                         for k, p in full.items())
                     + sum(self.model.area(k) * gbs * (-(-len(g) // gbs))
                           for k, g in merged))
        programs = frozenset({(k, gbs) for k in full}
                             | {(k, gbs) for k, _ in merged})
        return Plan(full_parts=full, groups=(), menu=(gbs,),
                    programs=programs, cost=scheduled + lc * launches,
                    scheduled_px=float(scheduled), launches=launches,
                    legacy_fallback=True)


def schedule_coverage(schedule) -> Dict[int, int]:
    """Valid-slot occurrences per item index over a schedule: a correct
    epoch covers each item exactly once (fill slots excluded)."""
    seen: Dict[int, int] = {}
    for _key, group in schedule:
        for idx, valid in group:
            if valid:
                seen[int(idx)] = seen.get(int(idx), 0) + 1
    return seen


def remnant_menu(gbs: int, quantum: int, *, mode: str = "cost") -> Tuple[int, ...]:
    """Legal launch sizes, descending.  Cost mode: every multiple of the
    quantum up to the batch.  Legacy mode: the batch and quantum * 2^j
    below it."""
    if mode == "cost":
        return tuple(range(gbs, 0, -quantum))
    menu = {gbs}
    size = quantum
    while size < gbs:
        menu.add(size)
        size *= 2
    return tuple(sorted(menu, reverse=True))
