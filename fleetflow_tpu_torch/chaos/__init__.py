"""Chaos harness: deterministic fault injection + fleet-wide invariant
checking (the port's copy of ``fleetflow_tpu/chaos``;
docs/guide/08-chaos-harness.md).

    from fleetflow_tpu_torch.chaos import run_scenario
    report = run_scenario("rolling-kill", seed=7, services=1000, nodes=100)
    assert report.ok, report.violations

Same seed -> same schedule -> same event log (`report.digest()`): every
robustness claim becomes a replayable repro. The world places on the card
(`device=None`); `device="cpu"` runs the card scheduler's plain PyTorch
versions and `use_gpu=False` the host greedy path, the reference's own
world.
"""

from .faults import (AgentPartition, ContainerExit, DeployFail, Fault,
                     FaultSchedule, HotspotShift, NodeCrash, NodeFlap,
                     Redeploy, SilentNodeCrash, SlowAgent, SpotReclaim,
                     Tick, WorkerKill, ZoneOutage, ZoneRevive)
from .injector import FaultInjector
from .invariants import FINAL_INVARIANTS, INSTANT_INVARIANTS
from .runner import ChaosReport, ChaosWorld, VirtualClock, run_schedule
from .scenarios import (SCENARIOS, build_schedule, scenario_info,
                        scenario_names, validate_schedule)
from .worldgen import WorldSpec, compile_world

__all__ = [
    "Fault", "NodeCrash", "NodeFlap", "AgentPartition", "SlowAgent",
    "DeployFail", "ContainerExit", "WorkerKill", "Redeploy",
    "SilentNodeCrash", "Tick", "SpotReclaim", "ZoneOutage", "ZoneRevive",
    "HotspotShift",
    "FaultSchedule", "FaultInjector", "ChaosReport", "ChaosWorld",
    "VirtualClock", "run_schedule", "run_scenario", "SCENARIOS",
    "build_schedule", "scenario_names", "scenario_info",
    "validate_schedule", "WorldSpec", "compile_world",
    "INSTANT_INVARIANTS", "FINAL_INVARIANTS",
]


def run_scenario(name: str, *, seed: int, services: int, nodes: int,
                 stages: int = 4, pool_min: int = 2, device=None,
                 use_gpu: bool = True) -> ChaosReport:
    """Build the named scenario's seeded schedule and replay it, placing
    on the card unless `device` or `use_gpu=False` says otherwise."""
    schedule = build_schedule(name, seed, services, nodes)
    return run_schedule(schedule, services=services, nodes=nodes,
                        stages=stages, pool_min=pool_min, device=device,
                        use_gpu=use_gpu)
