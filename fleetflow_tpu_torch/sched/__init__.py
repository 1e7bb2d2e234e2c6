"""Scheduler layer: ProblemTensors in, Placement out (port of
``fleetflow_tpu.sched``). Three backends return the same Placement:

  HostGreedyScheduler    pure-numpy first-fit-decreasing (tiny instances)
  NativeGreedyScheduler  the host placer's C++ FFD (fleetflow_tpu_torch
                         .native; raises when it cannot be built)
  GpuSolverScheduler     the device-resident annealing solver on the card

``place_with_fallback`` wraps any of them with the relaxation ladder.
"""

from .base import Placement, Scheduler, level_schedule
from .fallback import place_with_fallback, relax_problem
from .gpu import GpuSolverScheduler
from .host import HostGreedyScheduler

__all__ = ["Placement", "Scheduler", "level_schedule",
           "place_with_fallback", "relax_problem", "HostGreedyScheduler",
           "GpuSolverScheduler", "pick_scheduler"]


def pick_scheduler(S: int, N: int, *, prefer_gpu: bool = True) -> Scheduler:
    """Default backend policy, by instance size only (the reference's
    thresholds): single-node or tiny instances run the host greedy placer,
    fleet-scale host instances the C++ placer, the card's solver the rest.
    GpuSolverScheduler raises without a card; nothing here falls back."""
    if not prefer_gpu or N <= 1 or S * N < 512:
        if S * N >= 50_000:
            from ..native import NativeGreedyScheduler
            return NativeGreedyScheduler()
        return HostGreedyScheduler()
    return GpuSolverScheduler()
