"""Checkpoint loading and timing helpers.  The profiling hooks are
re-exported here, as the JAX package's ``can_tpu.utils`` does."""

from can_tpu_torch.utils.profiling import (
    StepTimer,
    await_devices,
    device_watchdog,
    emit_null_result,
    profile_trace,
)

__all__ = [
    "StepTimer",
    "await_devices",
    "device_watchdog",
    "emit_null_result",
    "profile_trace",
]
