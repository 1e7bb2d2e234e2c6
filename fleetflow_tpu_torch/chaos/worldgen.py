"""World simulator: production-shape traffic and correlated failure
domains, compiled into deterministic fault schedules.

The port's copy of ``fleetflow_tpu/chaos/worldgen.py``.

The canned scenario pack (chaos/scenarios.py) replays *synthetic*
churn: independent node kills on a cadence, fixed-rate arrival waves.
Production is correlated — diurnal waves with tenant hotspots that
migrate, spot/preemptible pools that get reclaimed a storm at a time,
and zone outages that kill a failure *domain*, not a random sample.
This module closes that gap with a declarative `WorldSpec` and a
compiler:

    compile_world(spec, seed, services, nodes) -> FaultSchedule

The compiler is a pure seeded function: the same (spec, seed, size)
always yields the same schedule, and the runner's replay of it the
same event-log digest — the established chaos contract, now holding
for generated worlds too. Everything the schedule needs to know about
topology (region membership, per-region capacity scale, spot pool
membership) rides in `FaultSchedule.world`; the runner turns it into
region-labeled servers (`ServerLabels.region`), region-homed stages
(stage g lives in region g mod R — one stage is one failure domain's
workload), and resolvable zone/spot fault targets.

Traffic model:

  * arrivals are Poisson per wave with a diurnal rate
    ``base * (1 + amp * sin(2 pi t / period))``, split across tenants
    by weight;
  * the traffic HOTSPOT rotates across tenants every
    ``hotspot_every_s``: the current hotspot's rate is multiplied by
    ``hotspot_boost`` and its waves are marked ``burst`` (it pays for
    its own flood — `admission-fair` judges everyone else);
  * every arrival draws an exponential lifetime with mean
    ``mean_lifetime_s``; departures are bucketed into the tenant's
    later waves (an over-count safely no-ops at apply time);
  * arrival waves go QUIET around a zone outage (30 s before the
    domain dies until 30 s after it revives) — the production front
    door fails traffic away from a dying zone, and the streams homed
    there drain before the lights go out.

`validate_schedule` is the feasibility pre-check the sizing rule in
scenarios.py documents: concurrent dead nodes stay under ~1/3 of the
fleet (whole declared failure domains are allowed to die — that is
what the domain is FOR) and the surviving fleet keeps ~2x capacity
headroom. A mis-sized scenario fails fast with a clear message instead
of surfacing as invariant noise.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Optional

from ..obs.metrics import REGISTRY
from . import faults as F
from .faults import (AdmissionWave, FaultSchedule, HotspotShift,
                     SpotReclaim, Tick, ZoneOutage, ZoneRevive)

__all__ = ["TenantSpec", "RegionSpec", "SpotPoolSpec", "OutageSpec",
           "WorldSpec", "compile_world", "validate_schedule",
           "WORLD_SCENARIOS"]

# world/simulate metric families (docs/guide/10-observability.md): the
# chaos world counts its generator-shaped traffic and correlated-fault
# activity through the ordinary registry, so a chaos run's /metrics
# story matches production's
M_WORLD_ARRIVALS = REGISTRY.counter(
    "fleet_world_arrivals_total",
    "Generator-shaped service arrivals the chaos world submitted "
    "through streaming admission")
M_WORLD_RECLAIMS = REGISTRY.counter(
    "fleet_world_reclaims_total",
    "Spot-pool nodes reclaimed by correlated reclamation storms, "
    "by pool", ["pool"])
M_WORLD_ZONE_OUTAGES = REGISTRY.counter(
    "fleet_world_zone_outages_total",
    "Whole-region zone outages injected by the world simulator, "
    "by region", ["region"])


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of the arrival stream. `weight` is its
    relative share of the diurnal rate; `cap_frac` (fraction of the
    fleet's service count, min 2) becomes a HARD admission quota
    (cp/admission.py tenant_caps) — the quota-pressure knob feeding
    the admission controller's hard caps."""
    name: str
    weight: float = 1.0
    cap_frac: Optional[float] = None


@dataclass(frozen=True)
class RegionSpec:
    """One failure domain. Node indices land in regions round-robin
    (region j gets every R-th node), and stage g is HOMED in region
    g mod R — its candidate servers are exactly that region's nodes,
    so losing the region parks exactly that region's work.
    `capacity_scale` multiplies the baseline per-node capacity."""
    name: str
    capacity_scale: float = 1.0


@dataclass(frozen=True)
class SpotPoolSpec:
    """A spot/preemptible slice of one region: the LAST `fraction` of
    the region's nodes. Each entry of `storms` is a reclamation storm:
    warning at that instant (victims cordoned), the pool's
    `reclaim_fraction` dies together `warning_s` later, and the
    victims return `revive_after` seconds after that."""
    name: str
    region: str
    fraction: float = 0.4
    storms: tuple = ()
    reclaim_fraction: float = 0.6
    warning_s: float = 30.0
    revive_after: Optional[float] = 240.0


@dataclass(frozen=True)
class OutageSpec:
    """One zone outage: every node of `region` dies at `at`, and the
    domain revives `duration` seconds later (None = never)."""
    region: str
    at: float
    duration: Optional[float] = 300.0


@dataclass(frozen=True)
class WorldSpec:
    """A declarative production world. Pure data: compiling it twice
    with one (seed, services, nodes) yields byte-identical schedules."""
    name: str
    tenants: tuple = (TenantSpec("default"),)
    regions: tuple = (RegionSpec("r-main"),)
    duration_s: float = 480.0
    settle_s: float = 300.0
    # arrivals: expected total ~= min(arrivals_per_service * services,
    # max_arrivals), spread over the diurnal curve
    arrivals_per_service: float = 0.5
    max_arrivals: int = 300
    diurnal_amp: float = 0.6
    diurnal_period_s: float = 240.0
    wave_start_s: float = 20.0
    wave_every_s: float = 10.0
    mean_lifetime_s: float = 180.0
    hotspot_every_s: Optional[float] = None
    hotspot_boost: float = 4.0
    spot_pools: tuple = ()
    outages: tuple = ()
    tick_every_s: float = 15.0


def _slug(i: int) -> str:
    # mirrors runner.node_slug (kept local so this module stays
    # import-light for the metrics-surface scripts)
    return f"node{i:03d}"


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth's sampler — exact and cheap for the small per-wave rates
    the generator uses (lambda is a handful at most)."""
    if lam <= 0.0:
        return 0
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def _effective_regions(spec: WorldSpec, nodes: int) -> list[RegionSpec]:
    """A fleet smaller than the region count collapses trailing regions
    (every effective region keeps at least one node)."""
    return list(spec.regions)[:max(1, min(len(spec.regions), nodes))]


def _region_indices(regions: list[RegionSpec],
                    nodes: int) -> dict[str, list[int]]:
    r = len(regions)
    return {reg.name: [i for i in range(nodes) if i % r == j]
            for j, reg in enumerate(regions)}


def _resolve_region(name: str, regions: list[RegionSpec]) -> str:
    """Faults declared against a collapsed region re-home to the last
    effective one (still deterministic per (spec, seed, size))."""
    names = [r.name for r in regions]
    return name if name in names else names[-1]


def compile_world(spec: WorldSpec, seed: int, services: int,
                  nodes: int) -> FaultSchedule:
    """Compile a declarative world into a seeded FaultSchedule."""
    if nodes < 2 or services < 1:
        raise ValueError(
            f"world {spec.name!r} needs at least 2 nodes and 1 service "
            f"(got nodes={nodes}, services={services})")
    rng = random.Random(f"worldgen:{spec.name}:{seed}")
    regions = _effective_regions(spec, nodes)
    region_idx = _region_indices(regions, nodes)

    pools: dict[str, list[int]] = {}
    pool_specs: list[tuple[SpotPoolSpec, str]] = []
    for p in spec.spot_pools:
        home = _resolve_region(p.region, regions)
        members = region_idx[home]
        count = max(1, int(len(members) * p.fraction))
        pools[p.name] = members[-count:]
        pool_specs.append((p, home))

    outages: list[tuple[OutageSpec, str]] = [
        (o, _resolve_region(o.region, regions)) for o in spec.outages]
    # arrival waves go quiet around each outage: traffic fails away
    # from the dying zone before it dies and returns after it revives
    quiet: list[tuple[float, float]] = []
    for o, _home in outages:
        end = (spec.duration_s + spec.settle_s if o.duration is None
               else o.at + o.duration)
        quiet.append((o.at - 30.0, end + 30.0))

    total_weight = sum(t.weight for t in spec.tenants) or 1.0
    expected = min(spec.arrivals_per_service * services,
                   float(spec.max_arrivals))
    base_rate = expected / max(spec.duration_s - spec.wave_start_s, 1.0)

    def hotspot_at(t: float) -> Optional[str]:
        if not spec.hotspot_every_s:
            return None
        slot = int(t // spec.hotspot_every_s)
        if slot == 0:
            return None          # the day starts balanced
        return spec.tenants[(slot - 1) % len(spec.tenants)].name

    faults: list = []
    departures: dict[str, list[float]] = {t.name: [] for t in spec.tenants}
    t = spec.wave_start_s
    wave_i = 0
    while t < spec.duration_s:
        in_quiet = any(a <= t <= b for a, b in quiet)
        rate = base_rate * (1.0 + spec.diurnal_amp
                            * math.sin(2.0 * math.pi * t
                                       / spec.diurnal_period_s))
        hot = hotspot_at(t)
        for j, tenant in enumerate(spec.tenants):
            lam = max(rate, 0.0) * spec.wave_every_s \
                * tenant.weight / total_weight
            is_hot = tenant.name == hot
            if is_hot:
                lam *= spec.hotspot_boost
            n = 0 if in_quiet else _poisson(rng, lam)
            for _ in range(n):
                heapq.heappush(
                    departures[tenant.name],
                    t + rng.expovariate(1.0 / spec.mean_lifetime_s))
            due = 0
            dq = departures[tenant.name]
            while dq and dq[0] <= t:
                heapq.heappop(dq)
                due += 1
            if n or due:
                faults.append(AdmissionWave(
                    at=t, tenant=tenant.name, arrivals=n, departures=due,
                    burst=is_hot, stage=(wave_i + j) % 3))
        wave_i += 1
        t += spec.wave_every_s

    if spec.hotspot_every_s:
        shift_t = spec.hotspot_every_s
        while shift_t < spec.duration_s:
            tenant = hotspot_at(shift_t)
            if tenant:
                faults.append(HotspotShift(at=shift_t, tenant=tenant))
            shift_t += spec.hotspot_every_s

    for p, _home in pool_specs:
        members = pools[p.name]
        count = max(1, int(len(members) * p.reclaim_fraction))
        for storm_at in p.storms:
            faults.append(SpotReclaim(
                at=float(storm_at), pool=p.name, count=count,
                warning_s=p.warning_s, revive_after=p.revive_after))

    for o, home in outages:
        faults.append(ZoneOutage(at=o.at, region=home))
        if o.duration is not None:
            faults.append(ZoneRevive(at=o.at + o.duration, region=home))

    horizon = spec.duration_s + spec.settle_s
    tick = 15.0
    while tick < horizon:
        faults.append(Tick(at=tick))
        tick += spec.tick_every_s

    tenant_caps = {
        t.name: max(2, int(services * t.cap_frac))
        for t in spec.tenants if t.cap_frac is not None}
    world = {
        "regions": {r.name: region_idx[r.name] for r in regions},
        "capacity_scale": {r.name: r.capacity_scale for r in regions},
        "spot_pools": dict(pools),
    }
    return FaultSchedule(spec.name, seed, faults, horizon=horizon,
                         tenant_caps=tenant_caps, world=world)


# --------------------------------------------------------------------------
# schedule feasibility pre-check (the scenarios.py sizing rule, enforced)
# --------------------------------------------------------------------------

# the make_flow demand distribution: mean per-service demand, and the
# baseline per-node capacity the runner provisions (runner._bootstrap)
_MEAN_CPU = (0.05 + 0.1 + 0.2) / 3.0
_MEAN_MEM = (32.0 + 64.0 + 128.0) / 3.0
_NODE_CPU = 4.0
_NODE_MEM = 8192.0
_HEADROOM = 2.0


def validate_schedule(schedule, *, services: int, nodes: int) -> None:
    """Fail fast on a mis-sized schedule (ValueError) instead of letting
    an infeasible re-solve surface as invariant noise. Enforces the
    scenarios.py sizing rule over the expanded primitive timeline:

      * concurrent dead nodes stay under ~1/3 of the fleet — except a
        declared failure domain (a region with a zone outage) is
        allowed to die whole: that is what the domain boundary is for;
      * the worst-case surviving fleet keeps ~2x capacity headroom for
        the synthetic demand distribution.

    Pure over (schedule.events(), schedule.world) — no world is built.
    """
    world = dict(getattr(schedule, "world", {}) or {})
    regions = {name: [_slug(i) for i in idxs if i < nodes]
               for name, idxs in (world.get("regions") or {}).items()}
    pools = {name: [_slug(i) for i in idxs if i < nodes]
             for name, idxs in (world.get("spot_pools") or {}).items()}

    down: set[str] = set()
    reclaimed: dict[str, list[str]] = {}
    outage_killed: dict[str, list[str]] = {}
    max_dead, peak_t = 0, 0.0
    domain = 0
    for t, op, p in schedule.events():
        if op in (F.NODE_DOWN, F.NODE_DOWN_SILENT):
            down.add(p["node"])
        elif op in (F.NODE_UP, F.NODE_UP_SILENT):
            down.discard(p["node"])
        elif op == F.SPOT_RECLAIM:
            members = [s for s in pools.get(p["pool"], [])
                       if s not in down]
            victims = members[:int(p.get("count", len(members)))]
            reclaimed.setdefault(p["pool"], []).extend(victims)
            down.update(victims)
        elif op == F.SPOT_REVIVE:
            down.difference_update(reclaimed.pop(p["pool"], []))
        elif op == F.ZONE_DOWN:
            members = [s for s in regions.get(p["region"], [])
                       if s not in down]
            outage_killed[p["region"]] = members
            domain = max(domain, len(regions.get(p["region"], [])))
            down.update(members)
        elif op == F.ZONE_UP:
            down.difference_update(outage_killed.pop(p["region"], []))
        # WORKER_KILL targets autoscaler pool workers, which are
        # provisioned on top of the base fleet — not counted here
        if len(down) > max_dead:
            max_dead, peak_t = len(down), t

    allowed = max(2, nodes // 3, domain)
    if max_dead > allowed:
        raise ValueError(
            f"schedule {schedule.scenario!r} is mis-sized for "
            f"nodes={nodes}: up to {max_dead} nodes concurrently dead "
            f"(at t={peak_t:.0f}s) exceeds the ~1/3 sizing rule "
            f"(allowed {allowed}; see chaos/scenarios.py) — grow the "
            f"fleet or thin the schedule")
    survivors = nodes - max_dead
    need_cpu = services * _MEAN_CPU * _HEADROOM
    need_mem = services * _MEAN_MEM * _HEADROOM
    if (need_cpu > survivors * _NODE_CPU
            or need_mem > survivors * _NODE_MEM):
        raise ValueError(
            f"schedule {schedule.scenario!r} is mis-sized for "
            f"services={services}, nodes={nodes}: the {survivors} "
            f"worst-case surviving nodes cannot carry the fleet with "
            f"2x headroom (need ~{need_cpu:.0f} cpu / {need_mem:.0f} "
            f"MiB, have {survivors * _NODE_CPU:.0f} cpu / "
            f"{survivors * _NODE_MEM:.0f} MiB)")


# --------------------------------------------------------------------------
# the production scenario pack
# --------------------------------------------------------------------------

_DIURNAL_HOTSPOT = WorldSpec(
    name="diurnal-hotspot",
    tenants=(TenantSpec("team-ap"), TenantSpec("team-eu"),
             TenantSpec("team-us")),
    regions=(RegionSpec("r-east"), RegionSpec("r-west")),
    duration_s=480.0, diurnal_period_s=240.0,
    arrivals_per_service=0.5, mean_lifetime_s=180.0,
    hotspot_every_s=120.0, hotspot_boost=4.0)

_SPOT_STORM = WorldSpec(
    name="spot-storm",
    tenants=(TenantSpec("team-od"), TenantSpec("team-spot")),
    regions=(RegionSpec("r-east"), RegionSpec("r-west")),
    duration_s=480.0, diurnal_period_s=240.0,
    arrivals_per_service=0.35, max_arrivals=200, mean_lifetime_s=200.0,
    spot_pools=(
        SpotPoolSpec("spot-east", "r-east", fraction=0.5,
                     storms=(120.0,), reclaim_fraction=0.6,
                     warning_s=30.0, revive_after=240.0),
        SpotPoolSpec("spot-west", "r-west", fraction=0.5,
                     storms=(300.0,), reclaim_fraction=0.6,
                     warning_s=30.0, revive_after=240.0)))

_ZONE_OUTAGE = WorldSpec(
    name="zone-outage",
    tenants=(TenantSpec("team-a"), TenantSpec("team-b")),
    regions=(RegionSpec("r-a"), RegionSpec("r-b"), RegionSpec("r-c")),
    duration_s=600.0, diurnal_period_s=300.0,
    arrivals_per_service=0.3, max_arrivals=160, mean_lifetime_s=200.0,
    outages=(OutageSpec("r-b", at=150.0, duration=240.0),))

_PRODUCTION_WEEK = WorldSpec(
    name="production-week",
    tenants=(TenantSpec("team-ap"), TenantSpec("team-eu"),
             TenantSpec("team-us", cap_frac=0.12)),
    regions=(RegionSpec("r-east", capacity_scale=1.25),
             RegionSpec("r-west"), RegionSpec("r-central")),
    duration_s=700.0, settle_s=300.0,
    diurnal_period_s=100.0,          # one compressed "day" per 100 s
    arrivals_per_service=0.5, mean_lifetime_s=150.0,
    hotspot_every_s=175.0, hotspot_boost=3.0,
    spot_pools=(
        # revive_after keeps the storm's dead window CLEAR of the zone
        # outage at 430 s: overlapping correlated faults would push
        # concurrent-dead past the ~1/3 sizing rule validate_schedule
        # enforces
        SpotPoolSpec("spot-east", "r-east", fraction=0.5,
                     storms=(220.0,), reclaim_fraction=0.6,
                     warning_s=30.0, revive_after=140.0),),
    outages=(OutageSpec("r-central", at=430.0, duration=200.0),))


def _diurnal_hotspot(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Two regions, three tenants, a compressed diurnal day: Poisson
    arrivals ride a sine curve while the traffic hotspot rotates across
    the tenants every 120 s at 4x boost (marked bursting — everyone
    ELSE must stay fairly served), with exponential service lifetimes
    driving continuous departures.

    Sizing: services=200 nodes=20 stages=4
    """
    return compile_world(_DIURNAL_HOTSPOT, seed, services, nodes)


def _spot_storm(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Spot reclamation storms under live traffic: each region's spot
    pool (the last half of its nodes) gets a provider warning — victims
    cordoned, new placements route around them — then 60% of the pool
    dies in ONE instant, returning 240 s later. Staggered east then
    west; the lease detector + reconverger absorb each storm.

    Sizing: services=200 nodes=20 stages=4
    """
    return compile_world(_SPOT_STORM, seed, services, nodes)


def _zone_outage(seed: int, services: int, nodes: int) -> FaultSchedule:
    """A whole failure domain dies: three regions, stage workloads homed
    per region, and region r-b drops off the map for 240 s mid-run.
    Only r-b's work may park (`degraded-gracefully`); survivors' SLOs
    hold; revival converges with zero doubled executions. Traffic fails
    away from the dying zone 30 s ahead and returns after revival.

    Sizing: services=200 nodes=21 stages=4
    """
    return compile_world(_ZONE_OUTAGE, seed, services, nodes)


def _production_week(seed: int, services: int, nodes: int) -> FaultSchedule:
    """The composed world: seven compressed diurnal days across three
    regions (one oversized 1.25x), hotspot rotation, a capped tenant
    under quota pressure, a spot reclamation storm on day 2, and a zone
    outage on day 4 — every pressure the simulator models in one run.

    Sizing: services=200 nodes=21 stages=4
    """
    return compile_world(_PRODUCTION_WEEK, seed, services, nodes)


# name -> (builder, one-line description); merged into SCENARIOS by
# chaos/scenarios.py so `fleet chaos run/list` sees one namespace
WORLD_SCENARIOS = {
    "diurnal-hotspot": (_diurnal_hotspot,
                        "diurnal Poisson arrivals with a 4x tenant "
                        "hotspot rotating across two regions — "
                        "fairness + SLOs judged under production-shape "
                        "traffic"),
    "spot-storm": (_spot_storm,
                   "correlated spot reclamation storms: warning, "
                   "cordon, then 60% of a pool dies at once (twice, "
                   "staggered by region) under live traffic"),
    "zone-outage": (_zone_outage,
                    "a whole region dies for 240s: only the lost "
                    "domain's work may park, survivors hold their "
                    "SLOs, revival converges with zero doubled "
                    "executions (degraded-gracefully)"),
    "production-week": (_production_week,
                        "seven compressed diurnal days composing "
                        "hotspot migration, quota pressure, a spot "
                        "storm and a zone outage — the full "
                        "production world in one seeded run"),
}
