"""can_tpu_torch.sched — the cost-priced scheduling core the batch-
formation engines consume (offline ShardedBatcher, serve MicroBatcher,
train/eval prefetch; counterpart of ``can_tpu/sched``).  See core.py."""

from .core import (
    DEFAULT_LAUNCH_COST_SLOTS,
    DEFAULT_MENU_BUDGET,
    ServeSched,
    costs_match,
    cover_cost,
    default_serve_menu,
    normalize_sizes,
    offline_planner,
    pick_work,
    prefetch_depth,
    prefetch_depth_for,
    select_menu,
)

__all__ = [
    "DEFAULT_LAUNCH_COST_SLOTS",
    "DEFAULT_MENU_BUDGET",
    "ServeSched",
    "costs_match",
    "cover_cost",
    "default_serve_menu",
    "normalize_sizes",
    "offline_planner",
    "pick_work",
    "prefetch_depth",
    "prefetch_depth_for",
    "select_menu",
]
