"""Steering a fleet's queued work to one replica, for checks that a given
replica serves (a scale-up's new replica, each replica of a burst)."""

from __future__ import annotations

import time


def serve_on(fleet, service, index: int, image, *,
             timeout_s: float = 60.0) -> list:
    """Lone requests of ``image`` through ``service`` until replica
    ``index`` of ``fleet`` has served one batch more; returns their
    results.  Every other replica's dispatch lock is held meanwhile: each
    of them takes at most one queued batch and then waits on its lock, so
    a later batch can only go to replica ``index``.  The held batches are
    served once the locks are released."""
    target = next(r for r in fleet.replicas if r.index == index)
    others = [r for r in fleet.replicas if r is not target]
    start, tickets = target.batches, []
    deadline = time.monotonic() + timeout_s
    for r in others:
        r.lock.acquire()
    try:
        while target.batches == start:
            if time.monotonic() > deadline:
                raise TimeoutError(f"replica {index} served no batch in "
                                   f"{timeout_s} s")
            tickets.append(service.submit(image))
            wait = time.monotonic() + 0.2
            while target.batches == start and time.monotonic() < wait:
                time.sleep(0.005)
    finally:
        for r in others:
            r.lock.release()
    return [t.result(timeout=timeout_s) for t in tickets]
