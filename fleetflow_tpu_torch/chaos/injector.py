"""Fault delivery: the bridge between a fault schedule and the hook
points threaded through the production code.

The port's copy of ``fleetflow_tpu/chaos/injector.py``.

No monkeypatching — every fault lands through an explicit, documented
extension point that exists in the real control plane:

  AgentRegistry.delivery_hook   partitions + slow agents (a raised
                                ControlPlaneError surfaces to callers
                                exactly like a dead-agent send failure)
  DeployEngine.fault_hook       armed DeployFail faults (a raised
                                BackendError fails the service through
                                the engine's normal error path)
  MockBackend.fault_hook        per-op backend faults (reserved for
                                scenario packs that fail pulls/creates)
  AppState.chaos                the injector itself, so anything holding
                                AppState can consult the active fault set

The injector is pure state + hook callables; the runner mutates it as it
replays the schedule (partition_start/end, slow_start/end, arm counts).
"""

from __future__ import annotations

from ..core.errors import ControlPlaneError
from ..runtime.backend import BackendError
from ..cp.agent_registry import (BUILD_TIMEOUT, DEFAULT_TIMEOUT,
                                 DEPLOY_TIMEOUT)

__all__ = ["FaultInjector"]

_TIMEOUTS = {"deploy.execute": DEPLOY_TIMEOUT, "deploy.down": DEPLOY_TIMEOUT,
             "build": BUILD_TIMEOUT}


class FaultInjector:
    """Active-fault state + the hook implementations that deliver it."""

    def __init__(self, clock=None, on_fire=None):
        self.clock = clock                    # VirtualClock or None
        self.on_fire = on_fire                # fn(kind, **detail) -> None
        self.partitioned: set[str] = set()    # slugs the CP cannot reach
        self.slow: dict[str, float] = {}      # slug -> delay (virtual s)
        self.deploy_fail_budget: int = 0      # armed service-start failures
        self.fired: list[tuple[str, str]] = []   # (kind, target) audit

    # ------------------------------------------------------------------
    # schedule-driven state transitions (called by the runner)
    # ------------------------------------------------------------------

    def partition(self, slug: str) -> None:
        self.partitioned.add(slug)

    def heal_partition(self, slug: str) -> None:
        self.partitioned.discard(slug)

    def slow_agent(self, slug: str, delay: float) -> None:
        self.slow[slug] = float(delay)

    def heal_slow(self, slug: str) -> None:
        self.slow.pop(slug, None)

    def arm_deploy_fail(self, count: int) -> None:
        self.deploy_fail_budget += int(count)

    # ------------------------------------------------------------------
    # hook implementations
    # ------------------------------------------------------------------

    def _fire(self, kind: str, target: str) -> None:
        self.fired.append((kind, target))
        if self.on_fire is not None:
            self.on_fire(kind, target)

    def delivery_hook(self, slug: str, command: str) -> None:
        """AgentRegistry.delivery_hook: raise = the send failed."""
        if slug in self.partitioned:
            self._fire("partition", slug)
            raise ControlPlaneError(
                f"chaos: agent {slug!r} unreachable (partition)")
        delay = self.slow.get(slug)
        if delay is not None:
            timeout = _TIMEOUTS.get(command, DEFAULT_TIMEOUT)
            if delay >= timeout:
                self._fire("slow-timeout", slug)
                raise ControlPlaneError(
                    f"chaos: agent {slug!r} command {command!r} timed out "
                    f"after {timeout:.0f}s (slow agent, {delay:.0f}s)")
            self._fire("slow", slug)
            if self.clock is not None:
                self.clock.advance(delay)

    def engine_hook(self, slug: str):
        """Per-node DeployEngine.fault_hook closure."""
        def hook(step: str, row: str) -> None:
            if self.deploy_fail_budget > 0:
                self.deploy_fail_budget -= 1
                self._fire("deploy-fail", f"{slug}/{row}")
                raise BackendError(
                    f"chaos: injected {step} failure for {row} on {slug}")
        return hook

    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        return {"partitioned": sorted(self.partitioned),
                "slow": dict(sorted(self.slow.items())),
                "deploy_fail_budget": self.deploy_fail_budget,
                "fired": len(self.fired)}
