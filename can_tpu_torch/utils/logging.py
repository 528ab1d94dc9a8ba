"""Metric logging: stdout plus wandb where it is installed (counterpart
of ``can_tpu/utils/logging.py:34-88``).

The reference logs scalars and eval images to wandb.  Here wandb is
optional: absent, or failing to start, logging falls back to stdout and
the run goes on.  A run id kept beside the checkpoints makes a resumed
run continue the same wandb run.
"""

from __future__ import annotations

import os
import uuid
from typing import Optional

import numpy as np


def _stable_run_id(run_id_file: str) -> str:
    """Read (or mint and keep) the wandb run id in ``run_id_file``."""
    if os.path.isfile(run_id_file):
        with open(run_id_file) as f:
            rid = f.read().strip()
        if rid:
            return rid
    rid = uuid.uuid4().hex[:12]
    os.makedirs(os.path.dirname(run_id_file) or ".", exist_ok=True)
    with open(run_id_file, "w") as f:
        f.write(rid)
    return rid


class MetricLogger:
    """Scalars to stdout (``[metrics]`` lines) and to wandb when asked for
    and available; images to wandb only."""

    def __init__(self, *, use_wandb: bool = False, project: str = "CANNet-torch",
                 group: str = "gpu", name: Optional[str] = None,
                 config: Optional[dict] = None, enabled: bool = True,
                 run_id_file: Optional[str] = None):
        self.enabled = enabled
        self._wandb = None
        if enabled and use_wandb:
            try:
                import wandb

                kwargs = {}
                if run_id_file:
                    kwargs = dict(id=_stable_run_id(run_id_file), resume="allow")
                wandb.init(project=project, group=group, name=name,
                           config=config or {}, **kwargs)
                self._wandb = wandb
            except ImportError:
                print("[logging] wandb not installed; falling back to stdout")
            except Exception as e:
                # wandb raises its own errors (no network, no credentials):
                # logging falls back to stdout and the run goes on
                print(f"[logging] wandb.init failed ({type(e).__name__}: "
                      f"{e}); falling back to stdout")

    def log(self, metrics: dict, *, step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        line = " ".join(f"{k}={v:.6g}"
                        if isinstance(v, (float, np.floating)) else f"{k}={v}"
                        for k, v in metrics.items())
        print(f"[metrics]{'' if step is None else f' step {step}'} {line}",
              flush=True)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, paths: list, *, caption: str = "",
                   step: Optional[int] = None) -> None:
        # the step rides along: a step-less wandb.log would commit the row
        # and file these images under the next epoch
        if self.enabled and self._wandb is not None:
            self._wandb.log({caption or "images": [self._wandb.Image(p) for p in paths]},
                            step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
