"""Fault algebra: the small, composable vocabulary of things that go
wrong in a fleet, plus seeded schedule generation.

The port's copy of ``fleetflow_tpu/chaos/faults.py``.

Jepsen/Chaos-Monkey shape: a *fault* is a declarative, serializable
description ("node07 crashes at t=60 and revives 240s later"); a
*schedule* is a seeded, sorted list of faults; the *runner* replays a
schedule's expanded primitive timeline against a simulated fleet. The
algebra is deliberately tiny — six fault kinds cover the robustness
machinery the control plane actually carries (churn re-solves, 2-phase
reservations, autoscaler reaping, deploy retry/release):

  NodeCrash      node powers off (containers die); optional revival
  NodeFlap       crash + fast revival (one flap of a flap-storm)
  AgentPartition CP<->agent link drops; the node keeps running
  SlowAgent      agent answers, but after `delay` virtual seconds
  DeployFail     arm the next N service-starts to fail mid-deploy
  ContainerExit  one running container on a node exits unexpectedly
  WorkerKill     crash an autoscaler pool worker (target picked at
                 apply time: the pool's first online worker)
  Redeploy       operator action: redeploy a stage (Jepsen "client op")

The world-simulator pack (chaos/worldgen.py) adds CORRELATED faults —
failures that take out a *domain*, not a random sample:

  SpotReclaim    a provider reclamation storm: warning with lead time
                 (victims cordoned), then the pool members die at once
  ZoneOutage     every node of one region dies in the same instant
  ZoneRevive     the lost region comes back (outage victims reconnect)
  HotspotShift   traffic hotspot migrates onto a tenant (the tenant is
                 marked as deliberately bursting from here on)

Every fault expands into primitive (time, op, params) events; the
runner groups same-instant primitives into one burst so coalesced churn
(`placement.node_events`) is exercised the way production would see it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "Fault", "NodeCrash", "NodeFlap", "AgentPartition", "SlowAgent",
    "DeployFail", "ContainerExit", "WorkerKill", "Redeploy",
    "SilentNodeCrash", "Tick", "PrimaryKill", "AdmissionWave",
    "SpotReclaim", "ZoneOutage", "ZoneRevive", "HotspotShift",
    "FaultSchedule",
]

# primitive ops the runner executes (the fault algebra's normal form)
NODE_DOWN = "node_down"
NODE_UP = "node_up"
NODE_DOWN_SILENT = "node_down_silent"
NODE_UP_SILENT = "node_up_silent"
TICK = "tick"
PARTITION_START = "partition_start"
PARTITION_END = "partition_end"
SLOW_START = "slow_start"
SLOW_END = "slow_end"
ARM_DEPLOY_FAIL = "arm_deploy_fail"
CONTAINER_EXIT = "container_exit"
WORKER_KILL = "worker_kill"
REDEPLOY = "redeploy"
CP_KILL = "cp_kill"
ADMIT = "admit"
SPOT_WARNING = "spot_warning"
SPOT_RECLAIM = "spot_reclaim"
SPOT_REVIVE = "spot_revive"
ZONE_DOWN = "zone_down"
ZONE_UP = "zone_up"
HOTSPOT_SHIFT = "hotspot_shift"


@dataclass(frozen=True)
class Fault:
    """Base fault: `at` is virtual seconds from scenario start."""
    at: float

    def expand(self) -> list[tuple[float, str, dict]]:
        raise NotImplementedError


@dataclass(frozen=True)
class NodeCrash(Fault):
    node: str = ""
    revive_after: Optional[float] = None   # None = stays dead

    def expand(self):
        out = [(self.at, NODE_DOWN, {"node": self.node, "wipe": True})]
        if self.revive_after is not None:
            out.append((self.at + self.revive_after, NODE_UP,
                        {"node": self.node}))
        return out


@dataclass(frozen=True)
class NodeFlap(Fault):
    node: str = ""
    down_for: float = 5.0

    def expand(self):
        return [(self.at, NODE_DOWN, {"node": self.node, "wipe": True}),
                (self.at + self.down_for, NODE_UP, {"node": self.node})]


@dataclass(frozen=True)
class SilentNodeCrash(Fault):
    """NodeCrash WITHOUT the runner informing the placement service: no
    node_event, no operator redeploy — the CP must NOTICE the death by
    itself (missed heartbeats -> lease expiry -> dead verdict,
    cp/failure_detector.py) and the reconverger must re-place and
    redeliver the stranded services. The self-healing scenario's whole
    point: detection is part of the system under test."""
    node: str = ""
    revive_after: Optional[float] = None   # None = stays dead

    def expand(self):
        out = [(self.at, NODE_DOWN_SILENT, {"node": self.node})]
        if self.revive_after is not None:
            out.append((self.at + self.revive_after, NODE_UP_SILENT,
                        {"node": self.node}))
        return out


@dataclass(frozen=True)
class Tick(Fault):
    """Pure pacing: advances the clock to `at` and forces a reconcile
    (heartbeats + detector sweep + heal pass). Lease expiry only fires
    when a sweep OBSERVES it, so silent-crash schedules interleave ticks
    to bound the detection latency on the virtual clock."""

    def expand(self):
        return [(self.at, TICK, {})]


@dataclass(frozen=True)
class AgentPartition(Fault):
    """The CP cannot reach the agent; the node keeps its containers."""
    node: str = ""
    duration: float = 60.0

    def expand(self):
        return [(self.at, PARTITION_START, {"node": self.node}),
                (self.at + self.duration, PARTITION_END,
                 {"node": self.node})]


@dataclass(frozen=True)
class SlowAgent(Fault):
    """Commands to the agent take `delay` virtual seconds; a delay past
    the command's timeout is a timeout failure."""
    node: str = ""
    delay: float = 30.0
    duration: float = 120.0

    def expand(self):
        return [(self.at, SLOW_START, {"node": self.node,
                                       "delay": self.delay}),
                (self.at + self.duration, SLOW_END, {"node": self.node})]


@dataclass(frozen=True)
class DeployFail(Fault):
    """Arm the injector: the next `count` service-starts anywhere in the
    fleet raise at the deploy engine's fault hook."""
    count: int = 1

    def expand(self):
        return [(self.at, ARM_DEPLOY_FAIL, {"count": self.count})]


@dataclass(frozen=True)
class ContainerExit(Fault):
    """One running fleet container on `node` exits (first by sorted
    name — deterministic); the runner's monitor pass restarts it."""
    node: str = ""

    def expand(self):
        return [(self.at, CONTAINER_EXIT, {"node": self.node})]


@dataclass(frozen=True)
class WorkerKill(Fault):
    """Crash an autoscaler pool worker; the target is resolved at apply
    time (first online worker of `pool`, sorted by slug)."""
    pool: str = "workers"

    def expand(self):
        return [(self.at, WORKER_KILL, {"pool": self.pool})]


@dataclass(frozen=True)
class Redeploy(Fault):
    """Operator redeploy of a stage (the Jepsen 'client operation' that
    races whatever else the schedule is doing at this instant)."""
    stage: str = ""

    def expand(self):
        return [(self.at, REDEPLOY, {"stage": self.stage})]


@dataclass(frozen=True)
class PrimaryKill(Fault):
    """Kill the control-plane PRIMARY itself (cp-failover scenario,
    docs/guide/13-cp-replication.md): the warm standby — fed by the
    store's replication stream — must promote (epoch bump, fencing),
    resume the dead primary's convergence debt, and re-home the agents.
    `phase` picks the crash window:

      burst       die in the same instant nodes are dying silently — the
                  verdicts exist nowhere yet; the new primary must
                  re-detect through its primed leases
      redelivery  die BETWEEN enqueuing redelivery work and delivering
                  it — the parked_work rows are on the standby via
                  replication, and the new primary must finish exactly
                  once
      compaction  force a journal compaction (snapshot + truncate), then
                  die — proving the shipped stream and the local journal
                  lifecycle are independent
    """
    phase: str = "burst"     # burst | redelivery | compaction

    def expand(self):
        return [(self.at, CP_KILL, {"phase": self.phase})]


@dataclass(frozen=True)
class AdmissionWave(Fault):
    """One tenant's slice of the continuous arrival stream (the streaming
    admission scenario, cp/admission.py): submit `arrivals` fresh services
    and `departures` of the tenant's oldest live streamed services through
    the admission queue. `burst=True` marks a wave that deliberately
    exceeds the tenant's fair share — the admission-fair invariant exempts
    bursting tenants from the latency bound (they PAY for the burst; the
    point is that nobody else does)."""
    tenant: str = ""
    arrivals: int = 0
    departures: int = 0
    burst: bool = False
    # which stage stream the wave targets, by sorted index (clamped to
    # the flow's stage count at apply time): multi-stage storms drive
    # several different-size streaming problems through one controller
    stage: int = 0

    def expand(self):
        return [(self.at, ADMIT, {"tenant": self.tenant,
                                  "arrivals": self.arrivals,
                                  "departures": self.departures,
                                  "burst": self.burst,
                                  "stage": self.stage})]


@dataclass(frozen=True)
class SpotReclaim(Fault):
    """A spot/preemptible reclamation storm against one declared pool
    (worldgen.SpotPoolSpec): the provider announces at `at` with
    `warning_s` of lead time — the runner resolves the victims THEN
    (first `count` online members, sorted) and cordons them, so new
    placements route around doomed machines — and reclaims them all in
    ONE instant at `at + warning_s` (correlated, silent: the CP's lease
    detector must still notice the deaths). `revive_after` reconnects
    the reclaimed victims that much later (capacity returning to the
    market); None means the pool stays shrunk."""
    pool: str = ""
    count: int = 1
    warning_s: float = 30.0
    revive_after: Optional[float] = None

    def expand(self):
        out = [(self.at, SPOT_WARNING, {"pool": self.pool,
                                        "count": self.count}),
               (self.at + self.warning_s, SPOT_RECLAIM,
                {"pool": self.pool, "count": self.count})]
        if self.revive_after is not None:
            out.append((self.at + self.warning_s + self.revive_after,
                        SPOT_REVIVE, {"pool": self.pool}))
        return out


@dataclass(frozen=True)
class ZoneOutage(Fault):
    """A whole failure DOMAIN dies at once: every online node of
    `region` (schedule.world region membership) disconnects silently in
    one instant — no node_events, no operator help. Only the lost
    domain's work may park; the `degraded-gracefully` invariant judges
    the rest of the fleet through the outage."""
    region: str = ""

    def expand(self):
        return [(self.at, ZONE_DOWN, {"region": self.region})]


@dataclass(frozen=True)
class ZoneRevive(Fault):
    """The lost region comes back: exactly the nodes the matching
    ZoneOutage killed reconnect. Revival must converge — parked stages
    un-park, and no idempotency-keyed redelivery may execute twice."""
    region: str = ""

    def expand(self):
        return [(self.at, ZONE_UP, {"region": self.region})]


@dataclass(frozen=True)
class HotspotShift(Fault):
    """The traffic hotspot migrates onto `tenant`: from this instant the
    generator's arrival waves favor the tenant (already baked into the
    sampled AdmissionWave counts) and the runner marks it as
    deliberately bursting, so `admission-fair` exempts it — the hotspot
    pays for its own flood; the invariant is that nobody else does."""
    tenant: str = ""

    def expand(self):
        return [(self.at, HOTSPOT_SHIFT, {"tenant": self.tenant})]


@dataclass
class FaultSchedule:
    """A seeded, replayable fault plan."""
    scenario: str
    seed: int
    faults: list[Fault] = field(default_factory=list)
    horizon: float = 0.0       # virtual end-of-scenario settle point
    # per-tenant hard admission caps (cp/admission.py tenant_caps) the
    # runner wires into the world's AdmissionConfig; empty = uncapped
    tenant_caps: dict[str, int] = field(default_factory=dict)
    # world topology metadata (chaos/worldgen.py): region -> node INDEX
    # list ("regions"), per-region capacity scale ("capacity_scale"),
    # spot pool -> node INDEX list ("spot_pools"). The runner turns it
    # into region-labeled servers, region-homed stages, and resolvable
    # zone/spot fault targets; empty = the classic single-domain fleet
    world: dict = field(default_factory=dict)

    def events(self) -> list[tuple[float, str, dict]]:
        """Expanded primitive timeline, stably sorted by time (ties keep
        declaration order, so a schedule is exactly reproducible)."""
        prims: list[tuple[float, str, dict]] = []
        for f in self.faults:
            prims.extend(f.expand())
        return sorted(prims, key=lambda e: e[0])

    def describe(self) -> list[str]:
        return [f"t={f.at:>7.1f}s {type(f).__name__} "
                + " ".join(f"{k}={v}" for k, v in vars(f).items()
                           if k != "at" and v is not None)
                for f in sorted(self.faults, key=lambda f: f.at)]
