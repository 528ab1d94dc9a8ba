"""Checkpoints of the full train state on ``torch.save`` (counterpart of
``can_tpu/utils/checkpoint.py``: ``CheckpointManager`` :136, the
run-config drift guard and the rollout's ``check_serve_config`` :93).

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
A ``ckpt_io`` fault of ``testing/faults.py`` (``CAN_TPU_FAULTS``) fails
the matching attempts from inside the retry loop.

Under several processes (DDP) rank 0 writes and every rank then waits at
a bounded barrier (``parallel.runtime.barrier``), so no rank reads a
checkpoint before it exists; every rank restores from the same
directory.  The state dict is the bare model's (``state.model``, never
the DDP wrapper): no ``module.`` prefix, so a DDP checkpoint, a
one-process checkpoint and the reference ``.pth`` export interchange.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import time
from typing import List, Optional

import torch

from can_tpu_torch.parallel.runtime import barrier, is_main_process, process_index
from can_tpu_torch.testing.faults import active_injector

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
    seed, syncBN, bf16, world_size) beside the checkpoints, atomically: a
    resume with a silently changed ``--epochs`` would reshape the cosine
    schedule the restored optimizer state was built for.  Rank 0 writes;
    the path is returned on every rank."""
    path = os.path.join(directory, RUN_CONFIG_NAME)
    if not is_main_process():
        return path
    os.makedirs(directory, exist_ok=True)
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


# the keys an elastic transition legitimately changes: the world shrank,
# so dp (and the lr peak and global batch derived from it) differs by
# construction.  Everything else must still match: elastic is a world
# change, never a licence for schedule drift.
ELASTIC_DRIFT_KEYS = ("world_size",)


def check_resume_config(saved: dict, current: dict, *,
                        allow: bool = False,
                        allow_elastic: bool = False) -> List[str]:
    """Compare a checkpoint's saved run config with the resuming run's;
    returns the sorted drifted keys, raising ``ConfigDriftError`` naming
    each ``key: saved -> current`` unless ``allow`` — or the drift is
    confined to ``ELASTIC_DRIFT_KEYS`` and ``allow_elastic`` (a live
    elastic manifest explains a dp-only change)."""
    keys = sorted(set(saved) | set(current))
    drifted = [k for k in keys if saved.get(k) != current.get(k)]
    if drifted and not allow:
        if allow_elastic and all(k in ELASTIC_DRIFT_KEYS for k in drifted):
            return drifted
        detail = ", ".join(f"{k}: {saved.get(k)!r} -> {current.get(k)!r}"
                           for k in drifted)
        raise ConfigDriftError(
            f"resume config drift vs the checkpoint's run ({detail})")
    return drifted



# The run-config keys that change what a checkpoint IS for serving: the
# model variant (syncBN decides whether BN running statistics exist, so
# the served tree's signature) and the training compute dtype.  Schedule
# keys (lr, epochs, batch, seed) are training-only — a fleet rollout
# between checkpoints of one run must not trip on a mid-run --lr change.
SERVE_CONFIG_KEYS = ("syncBN", "bf16")


def check_serve_config(serving: dict, incoming: dict, *,
                       allow: bool = False) -> List[str]:
    """Rollout drift guard: compare only the serve-relevant keys of the
    fleet's current run config against the incoming checkpoint's.  Same
    contract as :func:`check_resume_config` — returns the drifted keys,
    raises :class:`ConfigDriftError` unless ``allow``."""
    sub = {k: serving.get(k) for k in SERVE_CONFIG_KEYS}
    cur = {k: incoming.get(k) for k in SERVE_CONFIG_KEYS}
    return check_resume_config(sub, cur, allow=allow)

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
                inj = active_injector()
                if inj is not None:
                    # a scheduled ckpt_io fault fails INSIDE the attempt,
                    # so the retry path runs for real
                    inj.on_ckpt_io(op, rank=process_index())
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
        then apply the retention policy (rank 0), and wait at a bounded
        barrier until it is on disk (every rank).  Returns True."""
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

        if is_main_process():
            self._with_retries("save", write)
            self._prune()
        barrier(f"checkpoint-save-{epoch}")
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

    def model_state_dict(self, epoch: int) -> dict:
        """The model's state dict of checkpoint ``epoch``, on the CPU (the
        eval and serve CLIs need no optimizer)."""
        path = os.path.join(self.directory, str(epoch), STATE_NAME)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {epoch} under {self.directory}")
        payload = self._with_retries("restore", lambda: torch.load(
            path, map_location="cpu", weights_only=True))
        return payload["model"]

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
