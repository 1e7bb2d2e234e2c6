"""Native scheduler backend (the counterpart of
``fleetflow_tpu/native/sched.py``)."""

from __future__ import annotations

import time

from ..lower.tensors import ProblemTensors
from ..sched.base import Placement, assemble_placement

__all__ = ["NativeGreedyScheduler"]


class NativeGreedyScheduler:
    """The host placer's C++ FFD through ctypes, with the semantics of
    HostGreedyScheduler. Raises SolverError when the library cannot be
    built (the reference falls back to the Python placer; the port does
    not)."""

    def place(self, pt: ProblemTensors) -> Placement:
        from .lib import native_place
        t0 = time.perf_counter()
        assignment, violations = native_place(
            pt.demand, pt.capacity, pt.eligible, pt.node_valid,
            pt.dep_depth, pt.port_ids, pt.volume_ids, pt.anti_ids,
            strategy=pt.strategy.value)
        ms = (time.perf_counter() - t0) * 1e3
        return assemble_placement(pt, assignment, violations,
                                  "cpp-greedy", ms)
