"""Test harness shared by the port's chaos paths (counterpart of
``can_tpu/testing``) and its checks that a given fleet replica serves."""

from can_tpu_torch.testing.faults import (
    FAULTS_ENV,
    FaultInjector,
    InjectedFault,
    active_injector,
    make_kill_schedule,
)
from can_tpu_torch.testing.steer import serve_on

__all__ = [
    "FAULTS_ENV",
    "FaultInjector",
    "InjectedFault",
    "active_injector",
    "make_kill_schedule",
    "serve_on",
]
