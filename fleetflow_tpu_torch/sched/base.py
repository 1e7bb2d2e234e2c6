"""The Placement result, the Scheduler protocol and the dependency level
schedule (copy of ``fleetflow_tpu/sched/base.py``; the metrics registry is
not ported: ``record_placement`` keeps plain counters)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

from ..lower.tensors import ProblemTensors

__all__ = ["Placement", "Scheduler", "level_schedule", "assemble_placement",
           "record_placement", "PLACEMENTS"]

# placements produced, by solver source (host-greedy, cpp-greedy, ...),
# kept as plain counters until the metrics registry is ported
PLACEMENTS: dict[str, int] = {}


def level_schedule(pt: ProblemTensors) -> list[list[str]]:
    """Dependency level buckets in start order: all services at depth d can
    start concurrently once depth d-1 is ready."""
    depth = np.asarray(pt.dep_depth)
    levels: list[list[str]] = []
    for d in range(int(depth.max()) + 1 if depth.size else 0):
        levels.append([pt.service_names[i] for i in np.flatnonzero(depth == d)])
    return levels


@dataclass
class Placement:
    """A solved placement: where each service row runs and in what order."""
    assignment: dict[str, str]       # service row name -> node name
    levels: list[list[str]]          # start-order level buckets
    feasible: bool
    violations: int = 0
    soft: float = 0.0
    source: str = "gpu-anneal"
    solve_ms: float = 0.0
    raw: np.ndarray | None = field(default=None, repr=False)  # (S,) node idx


def record_placement(placement: Placement) -> None:
    """Count one solved Placement under its source (every greedy backend
    calls this once per solve)."""
    PLACEMENTS[placement.source] = PLACEMENTS.get(placement.source, 0) + 1


def assemble_placement(pt: ProblemTensors, assignment: np.ndarray,
                       violations: int, source: str,
                       solve_ms: float) -> Placement:
    """Shared Placement assembly for the greedy backends (host + native)."""
    placement = Placement(
        assignment={pt.service_names[i]: pt.node_names[int(assignment[i])]
                    for i in range(pt.S)},
        levels=level_schedule(pt),
        feasible=violations == 0,
        violations=violations,
        source=source,
        solve_ms=solve_ms,
        raw=assignment,
    )
    record_placement(placement)
    return placement


class Scheduler(Protocol):
    """Placement backend: ProblemTensors in, Placement out."""

    def place(self, pt: ProblemTensors) -> Placement: ...
