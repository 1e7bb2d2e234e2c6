"""Canned scenario pack: seeded schedule generators.

The port's copy of ``fleetflow_tpu/chaos/scenarios.py``.

Each scenario is a pure function (seed, services, nodes) -> FaultSchedule
— the same triple always yields the same schedule, and the runner's
replay of it the same event log, so every scenario run is a shareable
repro ("rolling-kill seed 7 at 1000x100").

Sizing rule: scenarios must stay *feasible by construction* — the
synthetic fleet carries roughly 2x capacity headroom, so schedules keep
concurrent dead nodes under ~a third of the fleet. An infeasible
re-solve is a sizing bug in the scenario, not a robustness finding.
"""

from __future__ import annotations

import random
from typing import Callable

from .faults import (AdmissionWave, AgentPartition, ContainerExit,
                     DeployFail, FaultSchedule, NodeCrash, NodeFlap,
                     PrimaryKill, Redeploy, SilentNodeCrash, SlowAgent,
                     Tick, WorkerKill)
from .runner import node_slug
from .worldgen import WORLD_SCENARIOS, validate_schedule

__all__ = ["SCENARIOS", "build_schedule", "scenario_names",
           "scenario_info", "validate_schedule"]


def _rolling_kill(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Kill nodes one at a time on a cadence, each revived later; a pool
    worker dies mid-roll and a few containers exit on survivors. At most
    ~4 nodes are dead at once.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    # never make every node a victim: survivors must exist to absorb the
    # displaced services (and to host the container-exit faults)
    kills = min(max(2, min(nodes // 10, 8)), nodes - 1)
    victims = rng.sample(range(nodes), kills)
    survivors = [n for n in range(nodes) if n not in victims]
    faults = []
    t = 30.0
    for i, v in enumerate(victims):
        faults.append(NodeCrash(at=t, node=node_slug(v),
                                revive_after=240.0))
        if i == kills // 2:
            faults.append(WorkerKill(at=t + 5.0))
        if i % 2 == 0:
            faults.append(ContainerExit(at=t + 10.0,
                                        node=node_slug(rng.choice(survivors))))
        t += 60.0
    return FaultSchedule("rolling-kill", seed, faults, horizon=t + 300.0)


def _rolling_kill_selfheal(seed: int, services: int,
                           nodes: int) -> FaultSchedule:
    """Rolling SILENT kills: nodes die without any operator RPC or runner
    assistance — missed heartbeats are the only signal. The lease-based
    failure detector must notice each death (suspect -> dead on the
    virtual clock) and the reconverger must warm re-solve and redeliver
    the stranded services to survivors (the `selfheal-converged`
    invariant judges the outcome). Ticks pace the replay so detector
    sweeps observe lease expiry with bounded latency; each victim
    revives later, exercising the node-online unpark path.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    kills = min(max(2, min(nodes // 10, 6)), nodes - 1)
    victims = rng.sample(range(nodes), kills)
    faults: list = []
    t = 30.0
    for v in victims:
        faults.append(SilentNodeCrash(at=t, node=node_slug(v),
                                      revive_after=400.0))
        t += 120.0
    horizon = t + 600.0
    # lease 60s + grace 30s (runner config): 30s ticks bound detection
    # at ~2 sweeps past expiry
    tick = 15.0
    while tick < horizon:
        faults.append(Tick(at=tick))
        tick += 30.0
    return FaultSchedule("rolling-kill-selfheal", seed, faults,
                         horizon=horizon)


def _cp_failover(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Kill the control-plane PRIMARY three times — mid-redelivery,
    mid-burst, and mid-compaction — while nodes die silently around it.
    Each kill promotes the warm standby (journal-shipping replication),
    which must resume the dead primary's convergence debt, re-detect
    in-flight node deaths through primed leases, and finish every
    redelivery exactly once; a zombie write from each dead primary must
    bounce off the fencing epoch. Judged by `cp-failover-converged` on
    top of the standard invariant pack.

    Timeline choreography (lease 60s + grace 30s on the world clock):
      * A dies at 95 with NO ticks until the kill at 130, so A's dead
        verdict fires INSIDE the kill's half-step — genuine
        mid-redelivery death (PrimaryKill phase="redelivery");
      * B dies in the same instant as the second kill — the burst is in
        flight, nobody has observed it; only the new primary's primed
        leases can find B (phase="burst");
      * the third kill compacts the journal first (phase="compaction");
      * C dies and revives afterwards, exercising plain self-healing +
        unpark on the twice-promoted primary.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    # survivors must exist: at most nodes-1 victims (tiny fleets get
    # fewer node kills but always all three primary kills)
    k = min(3, nodes - 1)
    victims = [node_slug(v) for v in rng.sample(range(nodes), k)]
    faults: list = [
        SilentNodeCrash(at=95.0, node=victims[0], revive_after=500.0),
        PrimaryKill(at=130.0, phase="redelivery"),
        PrimaryKill(at=250.0, phase="burst"),
        PrimaryKill(at=500.0, phase="compaction"),
    ]
    if k >= 2:   # dies in the same instant as the burst kill
        faults.insert(2, SilentNodeCrash(at=250.0, node=victims[1]))
    if k >= 3:   # plain self-heal + unpark on the final primary
        faults.append(SilentNodeCrash(at=560.0, node=victims[2],
                                      revive_after=240.0))
    horizon = 1000.0
    # ticks pace detector sweeps — EXCEPT inside (95, 130): a sweep
    # there would consume A's verdict before the mid-redelivery kill
    tick = 15.0
    while tick < horizon:
        if not (95.0 < tick < 130.0):
            faults.append(Tick(at=tick))
        tick += 30.0
    return FaultSchedule("cp-failover", seed, faults, horizon=horizon)


def _flap_storm(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Waves of short node flaps (the churn-coalescing stress): each wave
    flaps ~20% of the fleet within one instant, down for 5-20s, plus
    container exits during the instability.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    per_wave = max(1, min(nodes // 5, nodes - 1))
    faults = []
    t = 20.0
    for _wave in range(3):
        flappers = rng.sample(range(nodes), per_wave)
        survivor = node_slug(rng.choice(
            [n for n in range(nodes) if n not in flappers]))
        for v in flappers:
            faults.append(NodeFlap(at=t, node=node_slug(v),
                                   down_for=float(rng.choice((5, 10, 20)))))
        faults.append(ContainerExit(at=t + 2.0, node=survivor))
        faults.append(WorkerKill(at=t + 3.0))
        t += 90.0
    # horizon past the autoscaler's corpse-reap window: the killed
    # workers' offline records must get reaped AND replaced before the
    # pools-at-min verdict
    return FaultSchedule("flap-storm", seed, faults, horizon=t + 960.0)


def _partition_during_deploy(seed: int, services: int,
                             nodes: int) -> FaultSchedule:
    """Partition a slice of the fleet, then redeploy INTO the partition:
    the deploy must fail cleanly (reservation released, nothing
    half-committed) and succeed after the partition heals.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    cut = rng.sample(range(nodes), max(1, min(nodes // 5, nodes - 1)))
    faults = [AgentPartition(at=10.0, node=node_slug(v), duration=120.0)
              for v in cut]
    faults.append(SlowAgent(at=10.0, node=node_slug(
        rng.choice([n for n in range(nodes) if n not in cut])),
        delay=30.0, duration=120.0))
    # redeploy every stage while the partition stands, and again after
    faults.append(Redeploy(at=20.0, stage="app0"))
    faults.append(Redeploy(at=200.0, stage="app0"))
    return FaultSchedule("partition-during-deploy", seed, faults,
                         horizon=400.0)


def _deploy_fail_burst(seed: int, services: int,
                       nodes: int) -> FaultSchedule:
    """Arm a burst of injected service-start failures, then redeploy:
    each failed deploy must release its reservation; once the burst is
    spent the redeploy lands. A crash mid-burst stacks churn on top.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    faults = [
        DeployFail(at=10.0, count=3),
        Redeploy(at=15.0, stage="app0"),
        NodeCrash(at=60.0, node=node_slug(rng.randrange(nodes)),
                  revive_after=180.0),
        DeployFail(at=90.0, count=2),
        Redeploy(at=100.0, stage="app0"),
        Redeploy(at=260.0, stage="app0"),
    ]
    return FaultSchedule("deploy-fail-burst", seed, faults, horizon=420.0)


def _arrival_storm(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Continuous service arrivals/departures through the streaming
    admission pipeline (cp/admission.py), with one tenant bursting 10x
    its weight mid-storm. Three steady tenants submit small waves every
    10 s; `team-a` floods between t=80 and t=200. The admission queue
    must stay fair (DRR: the flood queues behind team-a's own backlog,
    never behind the others' — `admission-fair`) and complete (every
    submitted request ends placed/parked/shed/departed, and every live
    streamed service is in the committed placement — `admission-converged`).
    Ticks keep draining after the last wave so the backlog is judged
    drained, not abandoned.

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    tenants = ["team-a", "team-b", "team-c"]
    faults: list = []
    t = 20.0
    while t < 320.0:
        for tenant in tenants:
            burst = tenant == "team-a" and 80.0 <= t < 200.0
            n = 10 if burst else rng.choice((1, 1, 2))
            # departures only once the tenant has built up live services
            dep = rng.choice((0, 1)) if t >= 60.0 else 0
            faults.append(AdmissionWave(at=t, tenant=tenant, arrivals=n,
                                        departures=dep, burst=burst))
        t += 10.0
    horizon = t + 300.0
    tick = 15.0
    while tick < horizon:
        faults.append(Tick(at=tick))
        tick += 15.0
    return FaultSchedule("arrival-storm", seed, faults, horizon=horizon)


def _tenant_storm(seed: int, services: int, nodes: int) -> FaultSchedule:
    """Hard-quota storm across MULTIPLE stage streams with a primary
    kill in the middle. `team-cap` carries a hard cap of 6 and floods
    well past it: the overflow must PARK with the quota reason —
    accepted and journaled, never shed — while two uncapped tenants
    stream normally on rotating stages. Mid-storm the CP PRIMARY dies
    with quota parks outstanding; the promoted standby must restore the
    journaled parked arrivals and place them as the capped tenant's
    drain-phase departures free headroom (admission-quota +
    admission-converged + slo-met judged).

    Sizing: services=60 nodes=10 stages=2
    """
    rng = random.Random(seed)
    faults: list = []
    t = 20.0
    i = 0
    while t < 300.0:
        for j, tenant in enumerate(("team-cap", "team-d", "team-e")):
            stage = (i + j) % 3   # clamped to the flow's stage count
            if tenant == "team-cap":
                # flood phase: pile up quota parks; drain phase: pure
                # departures so headroom frees and the parks place
                n, dep = (2, 0) if t < 140.0 else (0, 1)
            else:
                n = rng.choice((1, 1, 2))
                dep = rng.choice((0, 1)) if t >= 60.0 else 0
            if n or dep:
                faults.append(AdmissionWave(at=t, tenant=tenant,
                                            arrivals=n, departures=dep,
                                            stage=stage))
        i += 1
        t += 10.0
    # die while the capped tenant's overflow is parked: the journaled
    # parked arrivals (admission_parked table) ride the replication
    # stream and must be restored by the promoted CP
    faults.append(PrimaryKill(at=145.0, phase="burst"))
    horizon = t + 300.0
    tick = 15.0
    while tick < horizon:
        faults.append(Tick(at=tick))
        tick += 15.0
    return FaultSchedule("tenant-storm", seed, faults, horizon=horizon,
                         tenant_caps={"team-cap": 6})


SCENARIOS: dict[str, tuple[Callable, str]] = {
    "rolling-kill": (_rolling_kill,
                     "serial node kills with revival + a pool worker "
                     "death + container exits"),
    "rolling-kill-selfheal": (_rolling_kill_selfheal,
                              "SILENT serial kills: only missed "
                              "heartbeats signal them — the lease "
                              "detector + reconverger must heal the "
                              "fleet unassisted"),
    "cp-failover": (_cp_failover,
                    "kill the CP PRIMARY mid-redelivery, mid-burst and "
                    "mid-compaction — the journal-shipping standby must "
                    "promote, fence the zombie, and finish every "
                    "redelivery exactly once"),
    "flap-storm": (_flap_storm,
                   "waves of coalesced short flaps across ~20% of the "
                   "fleet"),
    "partition-during-deploy": (_partition_during_deploy,
                                "deploys into a standing agent partition "
                                "+ one slow agent"),
    "deploy-fail-burst": (_deploy_fail_burst,
                          "injected mid-deploy service failures with a "
                          "crash stacked on top"),
    "arrival-storm": (_arrival_storm,
                      "continuous arrivals/departures through streaming "
                      "admission with one tenant bursting 10x its weight "
                      "— DRR fairness + completeness judged"),
    "tenant-storm": (_tenant_storm,
                     "hard-quota storm over rotating stage streams: a "
                     "capped tenant floods past its quota (overflow "
                     "parks, journaled) and the CP primary dies with "
                     "parks outstanding — the promoted standby must "
                     "restore and place them"),
}

# the world-simulator production pack (chaos/worldgen.py): declarative
# WorldSpecs compiled into the SAME FaultSchedule contract, so they list
# and run exactly like the hand-written scenarios above
SCENARIOS.update(WORLD_SCENARIOS)


def scenario_names() -> list[str]:
    return sorted(SCENARIOS)


def scenario_info(name: str) -> dict:
    """Description plus default sizing for `fleet chaos list`, read from
    the generator's docstring (the `Sizing: ...` convention every
    builder follows)."""
    builder, desc = SCENARIOS[name]
    sizing = ""
    for line in (builder.__doc__ or "").splitlines():
        line = line.strip()
        if line.startswith("Sizing:"):
            sizing = line[len("Sizing:"):].strip()
            break
    return {"name": name, "description": desc, "sizing": sizing}


def build_schedule(name: str, seed: int, services: int,
                   nodes: int) -> FaultSchedule:
    if nodes < 2 or services < 1:
        raise ValueError(
            f"chaos scenarios need at least 2 nodes and 1 service "
            f"(got nodes={nodes}, services={services}): every scenario "
            f"keeps survivors to absorb displaced services")
    try:
        builder, _desc = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: "
            f"{', '.join(scenario_names())}") from None
    return builder(seed, services, nodes)
