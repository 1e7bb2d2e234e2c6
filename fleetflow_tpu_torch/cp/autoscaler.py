"""Worker-pool autoscaler: the elastic worker lifecycle.

The port's copy of ``fleetflow_tpu/cp/autoscaler.py``.

Analog of the reference's worker provisioning + idle-shutdown pair
(scripts/spawn-build-worker.sh:1-30 spawns Sakura build workers;
scripts/idle-shutdown.sh:1-20 is a systemd timer that powers idle workers
off), folded into the control plane as a background reconciler over
WorkerPool records (model.rs:552-563 min/max):

- below `min_servers`: provision machines through the pool's cloud provider
  (the same ServerProvider path as server.provision) and register them into
  the pool.
- above `min_servers` with idle machines: deprovision the idle surplus,
  newest first, down to the floor ("idle" = online, schedulable, nothing
  allocated or reserved, no containers observed, and past a grace period).

One sweep is pure decision + provider calls with an injectable clock and
provider factory, so the whole policy is unit-testable without a cloud.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from .models import Server, ServerCapacity, WorkerPool
from ..core.model import ResourceSpec, ServerResource
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY

if TYPE_CHECKING:
    from .server import AppState

__all__ = ["Autoscaler", "ScaleAction"]

log = get_logger("cp.autoscaler")

# metric catalog: docs/guide/10-observability.md. The streaming-admission
# feedback signal (cp/admission.py pressure()): seconds the oldest queued
# admission request has waited when the signal is hot, 0 when drained —
# the input that makes the autoscaler provision on SOLVER pressure, not
# just idle counts.
_M_PRESSURE = REGISTRY.gauge(
    "fleet_autoscaler_pressure",
    "Admission queue pressure the autoscaler last planned against "
    "(oldest queued age in seconds; 0 = drained)")

IDLE_GRACE_S = 600.0     # idle-shutdown.sh waits ~10 min before poweroff
PROVISION_TIMEOUT_S = 900.0   # a machine that never came up is a zombie
OFFLINE_REAP_S = 900.0   # a worker offline this long is a corpse: reap the
                         # record (and any surviving VM) so the pool can
                         # replace it instead of counting it against max
# an offline node that still shows workload is given 4x the window for its
# stage to be redeployed elsewhere (which releases the allocations); past
# that the "workload" is bookkeeping residue on a dead machine and keeping
# the record would starve a capped pool below min forever
OFFLINE_BUSY_REAP_S = 4 * OFFLINE_REAP_S


@dataclass
class ScaleAction:
    pool: str
    kind: str               # "provision" | "deprovision"
    slug: str
    ok: bool = True
    error: str = ""


class Autoscaler:
    def __init__(self, state: "AppState", *, interval_s: float = 120.0,
                 idle_grace_s: float = IDLE_GRACE_S, clock=time.time,
                 pressure_source=None):
        self.state = state
        self.interval_s = interval_s
        self.idle_grace_s = idle_grace_s
        self.clock = clock
        # solver-pressure feedback (docs/guide/14-streaming-admission.md):
        # a callable returning cp/admission.py pressure() — defaults to
        # the AppState's admission controller when one is wired
        self.pressure_source = pressure_source
        self._task = None
        self._counter = 0
        # slug -> last time the worker had any workload (allocations or
        # observed containers). Maintained by the sweep itself: idleness is
        # about WORKLOAD, not liveness — a healthy agent heartbeats every
        # 30 s, so heartbeat recency would make idle shutdown unreachable.
        self._last_busy: dict[str, float] = {}

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------

    def _pool_servers(self, pool: WorkerPool) -> list[Server]:
        # pool names are only unique per tenant
        return self.state.store.list(
            "servers", lambda s: s.pool == pool.name
            and s.tenant == pool.tenant)

    def _is_busy(self, s: Server) -> bool:
        alloc = s.allocated
        return bool(alloc.cpu > 0 or alloc.memory > 0 or alloc.disk > 0
                    or alloc.reserved_cpu > 0 or alloc.reserved_memory > 0
                    or alloc.reserved_disk > 0
                    or self.state.store.observed_on(s.slug))

    def _is_idle(self, s: Server) -> bool:
        """Idle = schedulable, no workload now, and no workload since the
        grace period started (tracked in _last_busy by the sweep)."""
        if not s.schedulable or self._is_busy(s):
            return False
        since = self._last_busy.get(s.slug, s.created_at)
        return self.clock() - since >= self.idle_grace_s

    def _pressure(self) -> dict:
        """The admission pressure signal this sweep plans against
        (cp/admission.py pressure()): {} when no source is wired."""
        src = self.pressure_source
        if src is None:
            adm = getattr(self.state, "admission", None)
            src = adm.pressure if adm is not None else None
        if src is None:
            return {}
        try:
            return src() or {}
        except Exception:
            log.exception("pressure source failed; planning without it")
            return {}

    def plan(self, pool: WorkerPool,
             pressure: Optional[dict] = None) -> tuple[int, list[Server]]:
        """(n_to_provision, servers_to_deprovision) for one pool.

        min_servers counts only ALIVE workers (online, or provisioning and
        younger than PROVISION_TIMEOUT_S): a pool whose machines died gets
        replacements, and a machine that never came up is reaped as a
        zombie rather than blocking replenishment forever.

        `pressure` is the streaming-admission feedback (cp/admission.py):
        SUSTAINED queue age or infeasible-parked arrivals mean the solver
        (or the fleet's capacity) is the bottleneck — provision one node
        per sweep beyond the floor and hold idle scale-down; a drained
        queue releases the hold so the normal idle-grace rules resume.
        The max_servers cap applies AFTER the pressure bump: pressure can
        never override the pool ceiling."""
        now = self.clock()
        servers = self._pool_servers(pool)
        zombies = [s for s in servers
                   if s.status == "provisioning"
                   and now - s.created_at >= PROVISION_TIMEOUT_S]
        def offline_age(s):
            return now - max(s.last_heartbeat, s.updated_at)

        corpses = [s for s in servers
                   if s.status == "offline"
                   and (offline_age(s) >= OFFLINE_BUSY_REAP_S
                        # a partitioned-but-working node still carries
                        # workload state: give its stages the longer window
                        or (offline_age(s) >= OFFLINE_REAP_S
                            and not self._is_busy(s)))]
        dead = zombies + corpses
        alive = [s for s in servers
                 if s.status == "online"
                 or (s.status == "provisioning" and s not in zombies)]
        need = max(pool.min_servers - len(alive), 0)
        pressurized = bool(pressure and pressure.get("sustained"))
        victims: list[Server] = list(dead)
        if (not pressurized and need == 0
                and len(alive) > pool.min_servers):
            # idle scale-down only when the admission queue is NOT under
            # sustained pressure: a hot queue means every node is about
            # to be needed, even one that looks idle this instant
            idle = [s for s in alive if self._is_idle(s)]
            # newest first: long-lived workers keep caches warm
            idle.sort(key=lambda s: s.created_at, reverse=True)
            surplus = len(alive) - pool.min_servers
            victims += idle[:surplus]
        if pressurized and need == 0:
            # solver pressure provisions ahead of the floor — one node
            # per sweep (a ratchet, not a thundering herd)
            need = 1
        # max_servers is a hard cap on provisioning (0 = uncapped); dead
        # records being reaped this sweep do not count against it —
        # applied LAST so neither the floor nor pressure can pierce it
        if pool.max_servers > 0:
            room = max(pool.max_servers - (len(servers) - len(dead)), 0)
            need = min(need, room)
        return need, victims

    # ------------------------------------------------------------------
    # one sweep
    # ------------------------------------------------------------------

    def run_sweep(self) -> list[ScaleAction]:
        actions: list[ScaleAction] = []
        pressure = self._pressure()
        _M_PRESSURE.set(float(pressure.get("oldest_age_s", 0.0))
                        if pressure.get("sustained") else 0.0)
        for pool in self.state.store.list("worker_pools"):
            provider_name = pool.preferred_labels.get(
                "provider", pool.required_labels.get("provider", ""))
            if not provider_name:
                continue   # pool without a provider is manually managed
            # refresh workload tracking BEFORE planning: busy workers get
            # their grace window restarted
            now = self.clock()
            for s in self._pool_servers(pool):
                if self._is_busy(s):
                    self._last_busy[s.slug] = now
            need, victims = self.plan(pool, pressure)
            inventory = None
            if victims:
                # one provider listing per pool, not per victim; a failed
                # listing SKIPS the deprovisions (deleting records without
                # deleting VMs would leak running, billing machines)
                try:
                    sp = self.state.server_provider_factory(provider_name)
                    inventory = {i.name: i for i in sp.list_servers()}
                except Exception as e:
                    log.error("provider list failed; deferring scale-down %s",
                              kv(pool=pool.name, error=e))
                    victims = []
                    # the plan assumed those victims were being reaped; with
                    # reaping deferred, re-clamp provisioning against the
                    # FULL record count so a capped pool cannot overshoot
                    if pool.max_servers > 0:
                        servers_now = len(self._pool_servers(pool))
                        need = min(need, max(pool.max_servers - servers_now, 0))
            for _ in range(need):
                actions.append(self._provision(pool, provider_name))
            for s in victims:
                actions.append(self._deprovision(pool, s, provider_name,
                                                 inventory))
        return actions

    def _provision(self, pool: WorkerPool, provider_name: str) -> ScaleAction:
        # slugs must be unique across daemon restarts (the counter resets):
        # probe the store until a free one is found
        while True:
            self._counter += 1
            slug = f"{pool.name}-w{self._counter}"
            if self.state.store.server_by_slug(slug) is None:
                break
        try:
            sp = self.state.server_provider_factory(provider_name)
            spec = ServerResource(name=slug, capacity=ResourceSpec())
            rec = self.state.store.create("servers", Server(
                tenant=pool.tenant, slug=slug, provider=provider_name,
                status="provisioning", pool=pool.name,
                capacity=ServerCapacity()))
            try:
                info = sp.create_server(spec)
            except Exception:
                self.state.store.delete("servers", rec.id)
                raise
            self.state.store.update("servers", rec.id,
                                    hostname=info.ip or "")
            log.info("scaled up %s", kv(pool=pool.name, slug=slug,
                                        provider=provider_name))
            return ScaleAction(pool.name, "provision", slug)
        except Exception as e:
            log.error("scale-up failed %s", kv(pool=pool.name, slug=slug,
                                               error=e))
            return ScaleAction(pool.name, "provision", slug, ok=False,
                               error=str(e))

    def _deprovision(self, pool: WorkerPool, s: Server,
                     provider_name: str,
                     inventory: Optional[dict] = None) -> ScaleAction:
        try:
            sp = self.state.server_provider_factory(provider_name)
            if inventory is None:
                inventory = {i.name: i for i in sp.list_servers()}
            match = inventory.get(s.slug)
            if match is not None and not sp.delete_server(match.id):
                return ScaleAction(pool.name, "deprovision", s.slug,
                                   ok=False, error="provider delete failed")
            self.state.store.delete("servers", s.id)
            self._last_busy.pop(s.slug, None)
            detector = getattr(self.state, "failure_detector", None)
            if detector is not None:
                # deliberate scale-down: stop tracking the lease (a dead
                # verdict for a deprovisioned worker would be noise)
                detector.forget(s.slug)
            self.state.placement.node_event(s.slug, online=False)
            log.info("scaled down %s", kv(pool=pool.name, slug=s.slug))
            return ScaleAction(pool.name, "deprovision", s.slug)
        except Exception as e:
            log.error("scale-down failed %s", kv(pool=pool.name, slug=s.slug,
                                                 error=e))
            return ScaleAction(pool.name, "deprovision", s.slug, ok=False,
                               error=str(e))

    # ------------------------------------------------------------------
    # background loop
    # ------------------------------------------------------------------

    async def run_loop(self) -> None:
        while True:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.run_sweep)
            except Exception:
                log.exception("autoscaler sweep failed")
            await asyncio.sleep(self.interval_s)

    def spawn(self) -> None:
        self._task = asyncio.ensure_future(self.run_loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
