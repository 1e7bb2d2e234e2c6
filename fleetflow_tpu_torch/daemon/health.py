"""Background health checker.

Analog of fleetflowd health.rs:18-69: a recurring loop that resolves every
server's liveness and bulk-updates statuses. Liveness = agent connection
OR fresh heartbeat (within `stale_after_s`); with `use_tailscale` the
checker additionally polls `tailscale status` and matches peers by
hostname (health.rs:34-69 exactly) — the fallback signal for SSH-managed
servers that run no agent. Status transitions feed
`PlacementService.node_event`, which is the churn trigger for streaming
re-solves (BASELINE config 5) — the piece the reference's health loop
doesn't have.
"""

from __future__ import annotations

import asyncio
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..cp.server import AppState

__all__ = ["HealthChecker"]


class HealthChecker:
    def __init__(self, state: "AppState", *, interval_s: float = 60.0,
                 stale_after_s: float = 90.0, clock=time.time,
                 use_tailscale: bool = False, tailscale_runner=None):
        self.state = state
        self.interval_s = interval_s
        self.stale_after_s = stale_after_s
        self.clock = clock
        self.use_tailscale = use_tailscale
        self.tailscale_runner = tailscale_runner
        self._task = None

    def _tailscale_statuses(self) -> dict[str, str]:
        """slug -> online/offline from `tailscale status` peers matched by
        hostname (health.rs:34-69). Empty on any CLI failure — a broken
        tailscale must not mark the fleet offline."""
        from ..cloud.tailscale import get_peers, resolve_peer_status
        try:
            peers = get_peers(runner=self.tailscale_runner)
        except Exception:
            return {}
        out: dict[str, str] = {}
        for p in peers:
            status = resolve_peer_status(p, now=self.clock())
            # hostname collisions (a re-provisioned node's expired key
            # lingers as an offline peer): online wins, a stale entry must
            # not shadow the live one and trigger spurious churn
            if out.get(p.hostname) != "online":
                out[p.hostname] = status
        return out

    def resolve_statuses(self) -> dict[str, str]:
        """health.rs resolve_peer_status analog."""
        now = self.clock()
        ts = self._tailscale_statuses() if self.use_tailscale else {}
        out = {}
        for s in self.state.store.list("servers"):
            if self.state.agent_registry.is_connected(s.slug):
                out[s.slug] = "online"
            elif s.last_heartbeat and now - s.last_heartbeat < self.stale_after_s:
                out[s.slug] = "online"
            elif ts.get(s.slug.lower()) == "online":
                # agentless server reachable over the tailnet
                out[s.slug] = "online"
            else:
                out[s.slug] = "offline"
        return out

    def run_check(self) -> list[str]:
        """One sweep (health.rs run_check:34-69): bulk status update +
        churn events for transitions. Returns the slugs that changed."""
        statuses = self.resolve_statuses()
        changed = []
        for s in self.state.store.list("servers"):
            new = statuses.get(s.slug)   # may have registered mid-sweep
            if new is not None and s.status != new:
                changed.append(s.slug)
        self.state.store.bulk_server_status(statuses)
        if changed:
            # one coalesced burst: a sweep that finds 3 dead nodes costs
            # one warm re-solve per stage, not three sequential ones
            self.state.placement.node_events(
                [(slug, statuses[slug] == "online") for slug in changed])
        return changed

    async def run_loop(self) -> None:
        import logging
        log = logging.getLogger("fleetflow.health")
        while True:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.run_check)
            except Exception:
                log.exception("health sweep failed")
            await asyncio.sleep(self.interval_s)

    def spawn(self) -> asyncio.Task:
        """health.rs spawn:18."""
        self._task = asyncio.ensure_future(self.run_loop())
        return self._task

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
