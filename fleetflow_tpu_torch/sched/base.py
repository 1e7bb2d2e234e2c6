"""The Placement result, the Scheduler protocol and the dependency level
schedule (copy of ``fleetflow_tpu/sched/base.py``); ``record_placement``
folds each placement into the port's metrics registry."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

from ..lower.tensors import ProblemTensors
from ..obs.metrics import REGISTRY

__all__ = ["Placement", "Scheduler", "level_schedule", "assemble_placement",
           "record_placement"]

# one entry per scheduler backend: host-greedy, cpp-greedy, gpu-anneal and
# the relaxed sources — whatever `source` says
_M_PLACEMENTS = REGISTRY.counter(
    "fleet_placements_total", "Placements produced, by solver source",
    labels=("source",))
_M_PLACE_S = REGISTRY.histogram(
    "fleet_placement_duration_seconds", "Placement solve wall time by source",
    labels=("source",))
_M_PLACE_VIOL = REGISTRY.gauge(
    "fleet_placement_violations",
    "Hard violations of the most recent placement, by source",
    labels=("source",))


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

    def services_on(self, node: str) -> list[str]:
        """Rows assigned to `node`, in level-schedule order."""
        order = {name: i for i, lvl in enumerate(self.levels) for name in lvl}
        mine = [s for s, n in self.assignment.items() if n == node]
        return sorted(mine, key=lambda s: (order.get(s, 0), s))

    def node_levels(self, node: str) -> list[list[str]]:
        """The level schedule restricted to one node (what that node's
        executor runs, wave by wave: the deploy engine's slice)."""
        mine = {s for s, n in self.assignment.items() if n == node}
        return [[s for s in lvl if s in mine] for lvl in self.levels
                if any(s in mine for s in lvl)]


def record_placement(placement: Placement) -> None:
    """Fold one solved Placement into the placement families (every
    scheduler backend calls this exactly once per solve)."""
    _M_PLACEMENTS.inc(source=placement.source)
    _M_PLACE_S.observe(placement.solve_ms / 1e3, source=placement.source)
    _M_PLACE_VIOL.set(placement.violations, source=placement.source)


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
