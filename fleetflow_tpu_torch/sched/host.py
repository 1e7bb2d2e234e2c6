"""Host-side greedy placer: pure numpy (copy of
``fleetflow_tpu/sched/host.py``).

First-fit-decreasing over dependency-depth order, honoring every hard
constraint the device solver enforces (eligibility, node validity,
capacity, port/volume/anti-affinity exclusivity). The backend for small
instances (``pick_scheduler``), and the float recipe the host placer
(``csrc/host/placer.cpp``) mirrors.

Strategy scoring mirrors solver/kernels.py:
  spread_across_pool  pick the least-utilized eligible node
  pack_into_dedicated pick the most-utilized node that still fits
  fill_lowest         pick the lowest-indexed node that fits
"""

from __future__ import annotations

import time

import numpy as np

from ..core.model import PlacementStrategy
from ..lower.tensors import ProblemTensors
from .base import Placement, assemble_placement

__all__ = ["HostGreedyScheduler", "greedy_host_place"]


def greedy_host_place(pt: ProblemTensors) -> tuple[np.ndarray, int]:
    """(assignment (S,), violations). Services that cannot be placed without
    violating a hard constraint are put on their least-bad node and counted."""
    S, N = pt.S, pt.N
    demand = np.asarray(pt.demand, dtype=np.float64)
    capacity = np.asarray(pt.capacity, dtype=np.float64)
    load = np.zeros_like(capacity)
    # reciprocal once; the scoring below multiplies instead of divides.
    # csrc/host/placer.cpp mirrors this float recipe (multiply + plain sum,
    # no mean) so the two backends keep identical argmins at R=3 (numpy's
    # axis-sum is sequential at this width; pairwise summation above ~8
    # resources would round differently from the C loop) — edit both
    # together or the parity tests fail on near-ties.
    inv_cap = 1.0 / np.maximum(capacity, 1e-9)
    # conflict registries: (node, kind, group_id) occupancy
    occupied: set[tuple[int, str, int]] = set()

    def conflict_groups(s: int):
        for kind, arr in (("p", pt.port_ids), ("v", pt.volume_ids),
                          ("a", pt.anti_ids)):
            for g in arr[s]:
                if g >= 0:
                    yield kind, int(g)

    # order: dependency depth first (parents before children keeps waves
    # balanced), then biggest demand first within a level
    order = np.lexsort((-demand.sum(axis=1), np.asarray(pt.dep_depth)))

    assignment = np.zeros(S, dtype=np.int32)
    violations = 0
    valid = np.asarray(pt.node_valid, dtype=bool)
    eligible = np.asarray(pt.eligible, dtype=bool)

    for s in order:
        cands = np.flatnonzero(eligible[s] & valid)
        # falling back to ineligible/invalid nodes places the service but
        # IS a hard violation (kernels.violation_stats eligibility row) —
        # report it so fallback-policy relaxation can kick in upstream
        inelig = False
        if cands.size == 0:
            cands = np.flatnonzero(valid)
            inelig = True
        if cands.size == 0:
            cands = np.arange(N)
            inelig = True
        fits = []
        for n in cands:
            if np.any(load[n] + demand[s] > capacity[n]):
                continue
            if any((int(n), k, g) in occupied for k, g in conflict_groups(s)):
                continue
            fits.append(int(n))
        if fits:
            # sum, not mean: a constant 1/R factor cannot change the
            # argmin/argmax, and skipping it keeps the float recipe
            # identical to the native placer's loop
            util = (load[fits] * inv_cap[fits]).sum(axis=1)
            if pt.strategy == PlacementStrategy.PACK_INTO_DEDICATED:
                n = fits[int(np.argmax(util))]
            elif pt.strategy == PlacementStrategy.FILL_LOWEST:
                n = min(fits)
            else:  # spread
                n = fits[int(np.argmin(util))]
            if inelig:
                violations += 1
        else:
            # least-bad: minimize overflow on an eligible node
            over = (np.maximum(load[cands] + demand[s] - capacity[cands], 0)
                    * inv_cap[cands]).sum(axis=1)
            n = int(cands[int(np.argmin(over))])
            violations += 1
        assignment[s] = n
        load[n] += demand[s]
        occupied.update((n, k, g) for k, g in conflict_groups(s))

    return assignment, violations


class HostGreedyScheduler:
    """Default host placer (see module docstring)."""

    def place(self, pt: ProblemTensors) -> Placement:
        t0 = time.perf_counter()
        assignment, violations = greedy_host_place(pt)
        ms = (time.perf_counter() - t0) * 1e3
        return assemble_placement(pt, assignment, violations,
                                  "host-greedy", ms)
