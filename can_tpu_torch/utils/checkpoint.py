"""Checkpoints of the full train state on ``torch.save`` (counterpart of
``can_tpu/utils/checkpoint.py``: ``CheckpointManager`` :136 and the
run-config drift guard).

A checkpoint is everything a resume needs to continue the run exactly:
the model's state dict (parameters and BN running statistics), the
optimizer's (momentum buffers), the step, the epoch and its eval MAE.
Layout: ``<directory>/<epoch>/state.pt`` beside ``metrics.json``
(integer-named step directories, as the JAX package's Orbax layout), each
written to a temporary directory and renamed into place, so a crash
leaves a whole checkpoint or none.  Retention keeps the ``max_to_keep``
latest checkpoints plus the best-MAE one, so a resume never rolls back
behind the latest save and the best model is never lost.

I/O retries transient filesystem errors with exponential backoff and
jitter; past the retry budget it raises the typed ``CheckpointIOError``.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import time
from typing import List, Optional

import torch

RUN_CONFIG_NAME = "run_config.json"
STATE_NAME = "state.pt"
METRICS_NAME = "metrics.json"


class ConfigDriftError(ValueError):
    """A schedule-bearing flag differs from the checkpoint's run config."""


class CheckpointIOError(OSError):
    """Checkpoint save/restore I/O failed past the retry budget; carries
    ``op`` and ``attempts``."""

    def __init__(self, op: str, attempts: int, cause: BaseException):
        self.op = op
        self.attempts = attempts
        super().__init__(
            f"checkpoint {op} failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}")


def save_run_config(directory: str, config: dict) -> str:
    """Persist the schedule-bearing run config (lr, lrf, epochs, batch,
    seed, syncBN, bf16) beside the checkpoints, atomically: a resume with
    a silently changed ``--epochs`` would reshape the cosine schedule the
    restored optimizer state was built for."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, RUN_CONFIG_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(config, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _epochs(directory: str) -> List[int]:
    try:
        return sorted(int(e) for e in os.listdir(directory)
                      if e.isdigit()
                      and os.path.isfile(os.path.join(directory, e, STATE_NAME)))
    except OSError:
        return []


def has_checkpoint(directory: str) -> bool:
    """Is there anything to resume: a complete integer-named checkpoint."""
    return bool(_epochs(directory))


def load_run_config(directory: str) -> Optional[dict]:
    """The saved run config, or None when the directory has none."""
    path = os.path.join(directory, RUN_CONFIG_NAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_resume_config(saved: dict, current: dict, *,
                        allow: bool = False) -> List[str]:
    """Compare a checkpoint's saved run config with the resuming run's;
    returns the sorted drifted keys, raising ``ConfigDriftError`` naming
    each ``key: saved -> current`` unless ``allow``."""
    keys = sorted(set(saved) | set(current))
    drifted = [k for k in keys if saved.get(k) != current.get(k)]
    if drifted and not allow:
        detail = ", ".join(f"{k}: {saved.get(k)!r} -> {current.get(k)!r}"
                           for k in drifted)
        raise ConfigDriftError(
            f"resume config drift vs the checkpoint's run ({detail})")
    return drifted


class CheckpointManager:
    """Latest-N plus best-MAE checkpointing of a ``TrainState`` under
    ``directory``."""

    #: transient classes worth retrying; anything else fails at once
    TRANSIENT = (OSError, TimeoutError)

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 retries: int = 3, backoff_s: float = 0.25):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self.retries = max(1, int(retries))
        self.backoff_s = float(backoff_s)
        os.makedirs(self.directory, exist_ok=True)

    def _with_retries(self, op: str, fn):
        last: Optional[BaseException] = None
        for attempt in range(1, self.retries + 1):
            try:
                return fn()
            except FileNotFoundError:
                raise  # a missing checkpoint is not transient
            except self.TRANSIENT as e:
                last = e
                if attempt < self.retries:
                    # jitter desynchronises processes retrying against one
                    # overloaded filesystem; it never touches the numerics
                    delay = (self.backoff_s * (2 ** (attempt - 1))
                             * (1.0 + random.random()))
                    print(f"[checkpoint] transient {op} failure (attempt "
                          f"{attempt}/{self.retries}): {type(e).__name__}: "
                          f"{e} — retrying in {delay:.2f}s", flush=True)
                    time.sleep(delay)
        raise CheckpointIOError(op, self.retries, last) from last

    def _metrics(self, epoch: int) -> Optional[dict]:
        path = os.path.join(self.directory, str(epoch), METRICS_NAME)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, epoch: int, state, *, mae: float,
             extra: Optional[dict] = None) -> bool:
        """Save the state as checkpoint ``epoch`` with its eval metrics,
        then apply the retention policy.  Returns True."""
        metrics = {"mae": float(mae)}
        metrics.update({k: float(v) for k, v in (extra or {}).items()})
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step), "epoch": int(epoch)}

        def write():
            final = os.path.join(self.directory, str(epoch))
            tmp = os.path.join(self.directory, f".tmp-{epoch}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_NAME))
            with open(os.path.join(tmp, METRICS_NAME), "w") as f:
                json.dump(metrics, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)

        self._with_retries("save", write)
        self._prune()
        return True

    def _prune(self) -> None:
        epochs = _epochs(self.directory)
        keep = set(epochs[-self.max_to_keep:])
        best = self.best_epoch()
        if best is not None:
            keep.add(best)
        for e in epochs:
            if e not in keep:
                shutil.rmtree(os.path.join(self.directory, str(e)),
                              ignore_errors=True)

    def restore(self, state, *, epoch: Optional[int] = None):
        """Load checkpoint ``epoch`` (default: the latest) into ``state``
        in place — model, BN buffers, optimizer, step — and return it."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self.directory, str(epoch), STATE_NAME)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {epoch} under {self.directory}")
        device = next(state.model.parameters()).device
        payload = self._with_retries("restore", lambda: torch.load(
            path, map_location=device, weights_only=True))
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def latest_epoch(self) -> Optional[int]:
        epochs = _epochs(self.directory)
        return epochs[-1] if epochs else None

    def best_epoch(self) -> Optional[int]:
        """The epoch with the lowest saved MAE (the later one on a tie)."""
        best = None
        for e in _epochs(self.directory):
            m = self._metrics(e)
            if m is not None and (best is None or m["mae"] <= best[1]):
                best = (e, m["mae"])
        return None if best is None else best[0]

    def best_metric(self) -> Optional[float]:
        """The best saved MAE, or None, so a resumed run reports the run's
        best and not its own."""
        e = self.best_epoch()
        return None if e is None else float(self._metrics(e)["mae"])
