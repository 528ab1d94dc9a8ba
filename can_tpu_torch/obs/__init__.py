"""can_tpu_torch.obs — the observability package (counterpart of
``can_tpu/obs``).  Only ``lifecycle.py`` is ported so far: the supervised
loop the serving fleet and the autoscaler run on, and the teardown order
(ROADMAP Queue 1 item 5 brings the rest)."""

from can_tpu_torch.obs.lifecycle import shutdown_telemetry, supervised_loop

__all__ = ["shutdown_telemetry", "supervised_loop"]
