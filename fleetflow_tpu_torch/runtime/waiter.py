"""Dependency readiness waiting (the port's copy of
``fleetflow_tpu/runtime/waiter.py``).

Analog of fleetflow-container waiter.rs:24-97: poll a container until it is
Running (and Healthy, when a healthcheck is configured), with the service's
exponential backoff schedule (WaitConfig, model/service.rs:337-348:
1s -> 2s -> 4s ... capped at 30s, 23 retries ≈ 10 min budget).

`sleep` is injectable so tests run the full 23-attempt schedule in
microseconds (the reference tests the backoff math the same way,
waiter.rs:103-117).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..core.errors import FlowError
from ..core.model import Service, WaitConfig
from .backend import ContainerBackend

__all__ = ["wait_for_service", "check_container_health", "WaitTimeout"]


class WaitTimeout(FlowError):
    pass


def check_container_health(backend: ContainerBackend, name: str,
                           require_healthy: bool) -> bool:
    """One readiness probe: Running + (health == healthy if configured)
    (waiter.rs:68-97)."""
    info = backend.inspect(name)
    if info is None or not info.running:
        return False
    if require_healthy:
        return info.health == "healthy"
    # containers without a healthcheck count as ready once running
    return info.health in (None, "healthy")


def wait_for_service(backend: ContainerBackend, container: str,
                     svc: Service, *,
                     sleep: Callable[[float], None] = time.sleep,
                     on_attempt: Optional[Callable[[int, float], None]] = None,
                     ) -> int:
    """Block until `container` is ready; returns the attempt count.

    Raises WaitTimeout after WaitConfig.max_retries attempts
    (waiter.rs:24-53).
    """
    wait = svc.wait or WaitConfig()
    require_healthy = bool(svc.healthcheck and svc.healthcheck.test)
    for attempt in range(wait.max_retries):
        if check_container_health(backend, container, require_healthy):
            return attempt
        delay = wait.delay_for_attempt(attempt)
        if on_attempt:
            on_attempt(attempt, delay)
        sleep(delay)
    if check_container_health(backend, container, require_healthy):
        return wait.max_retries
    raise WaitTimeout(
        f"service {svc.name!r} ({container}) not ready after "
        f"{wait.max_retries} attempts (~{wait.total_budget():.0f}s)")
