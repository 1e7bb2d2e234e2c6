"""Dense placement tensors and the synthetic fleet generator.

The port's own copy of the parts of ``fleetflow_tpu/lower/tensors.py`` the
solver path needs: ``ProblemTensors``, ``dependency_depths``, ``_pad_ids``
and ``synthetic_problem`` (numpy only). For the same seed the generator
gives arrays bit-identical to the reference's, which the parity tests pin.
``lower_stage`` (the KDL front end) is not ported yet.

  demand        (S, R) f32   per-service resource demand (cpu, memMiB, diskMiB)
  capacity      (N, R) f32   per-node capacity
  dep_adj       (S, S) bool  dep_adj[i, j] = i depends on j (start ordering)
  dep_depth     (S,)   i32   topological depth (Kahn levels; cycles rejected)
  port_ids      (S, P) i32   host-port conflict ids, -1 padded (anti-affinity)
  volume_ids    (S, V) i32   exclusive-volume conflict ids, -1 padded
  anti_ids      (S, A) i32   explicit anti-affinity group ids, -1 padded
  coloc_ids     (S, C) i32   colocation group ids, -1 padded (soft)
  eligible      (S, N) bool  label/tier eligibility mask
  node_valid    (N,)   bool  membership/health mask (churn flips bits here)
  node_topology (N,)   i32   topology-domain id for the spread constraint
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.errors import SolverError
from ..core.model import RESOURCE_AXES, PlacementStrategy

__all__ = ["ProblemTensors", "dependency_depths", "synthetic_problem",
           "SYNTH_CPU_RANGE", "SYNTH_MEM_RANGE", "SYNTH_DISK_RANGE",
           "ELIGIBILITY_RELAX_CLASSES", "SPREAD_RELAX_CLASSES",
           "PREF_RELAX_CLASSES"]

# fallback-policy constraint-class aliases (sched/fallback.py): the ones
# that relax the eligibility mask, the spread constraint, the preferences
ELIGIBILITY_RELAX_CLASSES = ("tier", "required_labels", "labels",
                             "eligibility")
SPREAD_RELAX_CLASSES = ("spread", "spread_constraint")
PREF_RELAX_CLASSES = ("preferred_labels", "preferred")
_R = len(RESOURCE_AXES)  # cpu, memory, disk


@dataclass
class ProblemTensors:
    service_names: list[str]
    node_names: list[str]
    demand: np.ndarray          # (S, R) f32
    capacity: np.ndarray        # (N, R) f32
    dep_adj: np.ndarray         # (S, S) bool
    dep_depth: np.ndarray       # (S,) i32
    port_ids: np.ndarray        # (S, P) i32, -1 pad
    volume_ids: np.ndarray      # (S, V) i32, -1 pad
    anti_ids: np.ndarray        # (S, A) i32, -1 pad
    coloc_ids: np.ndarray       # (S, C) i32, -1 pad
    eligible: np.ndarray        # (S, N) bool
    node_valid: np.ndarray      # (N,) bool
    node_topology: np.ndarray   # (N,) i32
    strategy: PlacementStrategy = PlacementStrategy.SPREAD_ACROSS_POOL
    max_skew: int = 0           # 0 = no spread constraint
    preferred: Optional[np.ndarray] = None  # (S, N) f32 soft preference, or None
    replica_of: list[str] = field(default_factory=list)  # base service per row
    # constraint classes to relax, in order, when infeasible (stage
    # placement fallback{}; reference model.rs:49 FallbackPolicy)
    relax_order: list[str] = field(default_factory=list)

    @property
    def S(self) -> int:
        return self.demand.shape[0]

    @property
    def N(self) -> int:
        return self.capacity.shape[0]

    def validate(self) -> None:
        S, N = self.S, self.N
        shapes = {"demand": (self.demand.shape, (S, _R)),
                  "capacity": (self.capacity.shape, (N, _R)),
                  "dep_adj": (self.dep_adj.shape, (S, S)),
                  "dep_depth": (self.dep_depth.shape, (S,)),
                  "eligible": (self.eligible.shape, (S, N)),
                  "node_valid": (self.node_valid.shape, (N,)),
                  "node_topology": (self.node_topology.shape, (N,))}
        for name, (got, want) in shapes.items():
            if tuple(got) != want:
                raise SolverError(f"{name} has shape {got}, expected {want}")
        for name in ("port_ids", "volume_ids", "anti_ids", "coloc_ids"):
            arr = getattr(self, name)
            if arr.ndim != 2 or arr.shape[0] != S:
                raise SolverError(f"{name} has shape {arr.shape}, "
                                  f"expected ({S}, k)")


def dependency_depths(dep_adj: np.ndarray,
                      names: Optional[list[str]] = None,
                      edges: Optional[list[tuple[int, int]]] = None,
                      ) -> np.ndarray:
    """Kahn-style level assignment: depth(s) = 1 + max(depth(deps)), 0 for
    roots. Rejects cycles. This replaces the reference's single-pass
    partition (engine.rs:67-85 `order_by_dependencies`, which is NOT a true
    topo sort) with an exact level schedule that vectorizes: all services at
    depth d can start concurrently once depth d-1 is ready."""
    S = dep_adj.shape[0]
    # Kahn over the edge LIST, not the dense matrix: per-level scans of a
    # fancy-indexed (S, unresolved) submatrix copy are O(S^2) per level;
    # with E edges this is O(S + E) after one pass extracting the edges. A
    # caller that already holds the (src, dst) pairs passes `edges` to skip
    # the full-matrix nonzero scan.
    if edges is not None:
        # two accepted forms: a (src_array, dst_array) PAIR — required to
        # actually be arrays, so a tuple of exactly two (src, dst) edge
        # pairs can never be misread as one — or any sequence of pairs
        if (isinstance(edges, tuple) and len(edges) == 2
                and isinstance(edges[0], np.ndarray)
                and isinstance(edges[1], np.ndarray)):
            src = edges[0].astype(np.int64, copy=False)
            dst = edges[1].astype(np.int64, copy=False)
        else:
            src = np.fromiter((e[0] for e in edges), dtype=np.int64,
                              count=len(edges))
            dst = np.fromiter((e[1] for e in edges), dtype=np.int64,
                              count=len(edges))
    else:
        src, dst = np.nonzero(dep_adj)      # src depends on dst
    indeg = np.bincount(src, minlength=S).astype(np.int64)
    # CSR adjacency dst -> [dependents]: each level then processes ALL its
    # outgoing edges with array gathers/scatters instead of a per-edge
    # Python loop
    order = np.argsort(dst, kind="stable")
    src_by_dst = src[order]
    counts = np.bincount(dst, minlength=S)
    indptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    depth = np.zeros(S, dtype=np.int32)
    level = np.flatnonzero(indeg == 0)
    resolved = int(level.size)
    while level.size:
        starts, ends = indptr[level], indptr[level + 1]
        n_out = ends - starts
        if not n_out.any():
            break
        # flatten this level's CSR ranges: edge i runs from dep d=level[k]
        # to dependent s=src_by_dst[starts[k] + j]
        reps = np.repeat(level, n_out)
        offs = np.arange(int(n_out.sum())) - np.repeat(
            np.cumsum(n_out) - n_out, n_out)
        ss = src_by_dst[np.repeat(starts, n_out) + offs]
        np.maximum.at(depth, ss, depth[reps] + 1)
        np.subtract.at(indeg, ss, 1)
        cand = np.unique(ss)
        level = cand[indeg[cand] == 0]
        resolved += int(level.size)
    if resolved < S:
        cyc = np.flatnonzero(indeg > 0)
        label = ([names[i] for i in cyc[:5]] if names else cyc[:5].tolist())
        raise SolverError(f"dependency cycle among services {label}")
    return depth


def _pad_ids(groups: list[list[int]], pad_to_multiple: int = 1) -> np.ndarray:
    """list-of-id-lists → (S, K) int32 padded with -1 (vectorized, no
    per-row loop)."""
    n = len(groups)
    lens = np.fromiter(map(len, groups), dtype=np.int64, count=n)
    total = int(lens.sum())
    k = max(int(lens.max(initial=0)), 1)
    if pad_to_multiple > 1:
        k = ((k + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    out = np.full((n, k), -1, dtype=np.int32)
    if total:
        flat = np.fromiter(
            (g for row in groups for g in row), dtype=np.int32, count=total)
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        out[rows, cols] = flat
    return out


# Synthetic problem generator (the reference's BASELINE.json eval shapes)
# --------------------------------------------------------------------------

# Demand distribution of the synthetic instances: the same ranges as the
# reference's generator, so the same seed gives the same fleet.
SYNTH_CPU_RANGE = (0.05, 0.5)
SYNTH_MEM_RANGE = (32.0, 512.0)       # MiB
SYNTH_DISK_RANGE = (0.0, 1024.0)      # MiB


def synthetic_problem(S: int, N: int, seed: int = 0,
                      dep_depth_max: int = 5,
                      port_fraction: float = 0.2,
                      volume_fraction: float = 0.1,
                      n_tenants: int = 1,
                      strategy: PlacementStrategy = PlacementStrategy.SPREAD_ACROSS_POOL,
                      ) -> ProblemTensors:
    """Generate a synthetic placement instance shaped like the BASELINE.json
    eval configs: depends_on chains of depth ≤ dep_depth_max, a fraction of
    services publishing host ports (mutual anti-affinity per port), exclusive
    volumes, and optional multi-tenant eligibility blocks (config 4's
    registry-aggregation analog: tenants share the node pool but only see a
    slice)."""
    rng = np.random.default_rng(seed)

    demand = np.stack([
        rng.uniform(*SYNTH_CPU_RANGE, S),
        rng.uniform(*SYNTH_MEM_RANGE, S),
        rng.uniform(*SYNTH_DISK_RANGE, S),
    ], axis=1).astype(np.float32)

    # dependency chains: partition services into chains of length ≤ depth max
    dep_adj = np.zeros((S, S), dtype=bool)
    order = rng.permutation(S)
    i = 0
    while i < len(order):
        chain_len = int(rng.integers(1, dep_depth_max + 1))
        chain = order[i : i + chain_len]
        for a, b in zip(chain[1:], chain[:-1]):
            dep_adj[a, b] = True
        i += chain_len
    dep_depth = dependency_depths(dep_adj)

    # port conflicts: port_fraction of services publish 1-2 host ports drawn
    # from a pool sized so each port is shared by a handful of services
    # Each port id is capped at N-1 members: a group of k services needs k
    # distinct nodes, and the cap keeps instances solvable even after a
    # single-node churn event (BASELINE config 5 kills one node).
    n_ports = max(int(S * port_fraction / 4), 1)
    members = np.zeros(n_ports, dtype=np.int64)
    port_groups: list[list[int]] = []
    for s in range(S):
        if rng.random() < port_fraction:
            k = int(rng.integers(1, 3))
            open_ids = np.flatnonzero(members < N - 1)
            pick = open_ids[rng.permutation(open_ids.size)[:k]].tolist()
            members[pick] += 1
            port_groups.append(pick)
        else:
            port_groups.append([])
    n_vols = max(int(S * volume_fraction / 3), 1)
    vol_groups = [([int(rng.integers(0, n_vols))] if rng.random() < volume_fraction else [])
                  for _ in range(S)]

    # multi-tenant eligibility: tenant t's services may only use its node slice
    eligible = np.ones((S, N), dtype=bool)
    if n_tenants > 1:
        svc_tenant = rng.integers(0, n_tenants, S)
        node_tenant = rng.integers(0, n_tenants, N)
        # shared pool: a third of nodes serve everyone
        shared = rng.random(N) < 0.33
        eligible = (svc_tenant[:, None] == node_tenant[None, :]) | shared[None, :]
        # guarantee every service has at least one eligible node
        for s in np.flatnonzero(~eligible.any(axis=1)):
            eligible[s, int(rng.integers(0, N))] = True

    # Capacity sized from a feasibility witness: place every service on an
    # eligible node with no port/volume conflict (round-robin least-loaded),
    # then set capacity = witness load / 0.7. This makes the instance feasible
    # BY CONSTRUCTION even when tenant eligibility slices the pool unevenly —
    # a tenant with many services and few eligible nodes gets bigger nodes,
    # the way a real operator would size a dedicated pool.
    w_load = np.zeros((N, _R), dtype=np.float64)
    occupied: set[tuple[int, str, int]] = set()
    for s in np.argsort(-demand.sum(axis=1)):  # biggest first
        cands = np.flatnonzero(eligible[s])
        free = [n for n in cands
                if not any((int(n), "p", g) in occupied for g in port_groups[s])
                and not any((int(n), "v", g) in occupied for g in vol_groups[s])]
        if not free:  # drop this service's conflicts rather than go infeasible
            port_groups[s], vol_groups[s] = [], []
            free = list(cands)
        util = w_load[free].sum(axis=1)
        n = int(free[int(np.argmin(util))])
        w_load[n] += demand[s]
        occupied.update((n, "p", g) for g in port_groups[s])
        occupied.update((n, "v", g) for g in vol_groups[s])
    floor = demand.max(axis=0)  # every node can host any single service
    capacity = np.maximum(w_load / 0.7, floor[None, :]).astype(np.float32)
    capacity *= rng.uniform(1.0, 1.15, (N, _R)).astype(np.float32)

    pt = ProblemTensors(
        service_names=[f"svc{s}" for s in range(S)],
        node_names=[f"node{n}" for n in range(N)],
        demand=demand,
        capacity=capacity,
        dep_adj=dep_adj,
        dep_depth=dep_depth,
        port_ids=_pad_ids(port_groups),
        volume_ids=_pad_ids(vol_groups),
        anti_ids=_pad_ids([[] for _ in range(S)]),
        coloc_ids=_pad_ids([[] for _ in range(S)]),
        eligible=eligible,
        node_valid=np.ones(N, dtype=bool),
        node_topology=np.arange(N, dtype=np.int32),
        strategy=strategy,
        replica_of=[f"svc{s}" for s in range(S)],
    )
    pt.validate()
    return pt
