"""Lowering: Flow + stage -> dense constraint tensors, and the synthetic
fleet generator.

The port's own copy of ``fleetflow_tpu/lower/tensors.py`` (numpy only):
``lower_stage`` turns a stage of a parsed Flow into ``ProblemTensors``
bit-identical to the reference's, and for the same seed
``synthetic_problem`` gives arrays bit-identical to the reference's; the
parity tests pin both.

Replicas are expanded at lowering time: `service "w" { replicas 3 }` becomes
rows w#0, w#1, w#2 sharing demand/ports/volumes; replica host-port conflicts
make replicas of a port-publishing service mutually anti-affine exactly like
the reference's one-host-port-per-node reality.

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

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.errors import SolverError
from ..core.model import (RESOURCE_AXES, Flow, PlacementPolicy,
                          PlacementStrategy, ResourceSpec, ServerResource,
                          Service, ServiceType)

__all__ = ["ProblemTensors", "lower_stage", "dependency_depths",
           "LOCAL_NODE_NAME", "local_node", "synthetic_problem",
           "SYNTH_CPU_RANGE", "SYNTH_MEM_RANGE", "SYNTH_DISK_RANGE",
           "ELIGIBILITY_RELAX_CLASSES", "SPREAD_RELAX_CLASSES",
           "PREF_RELAX_CLASSES"]

LOCAL_NODE_NAME = "local"

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


def _server_matches(policy: Optional[PlacementPolicy],
                    server: ServerResource) -> bool:
    if policy is None:
        return True
    labels = server.labels.as_dict()
    if policy.tier is not None and labels.get("tier") not in (None, policy.tier):
        return False
    for k, v in policy.required_labels.items():
        if labels.get(k) != v:
            return False
    return True


def _preference_row(policy: Optional[PlacementPolicy],
                    server: ServerResource) -> float:
    if policy is None or not policy.preferred_labels:
        return 0.0
    labels = server.labels.as_dict()
    hits = sum(1 for k, v in policy.preferred_labels.items()
               if labels.get(k) == v)
    return hits / max(len(policy.preferred_labels), 1)


def local_node(name: str = LOCAL_NODE_NAME) -> ServerResource:
    """The single implicit node of local execution (`fleet up` / CP-local
    deploys) or an agent's synthetic level-schedule node: generous
    capacity, so placement degenerates to ordering."""
    return ServerResource(
        name=name,
        capacity=ResourceSpec(cpu=1e6, memory=1e9, disk=1e9))


def lower_stage(flow: Flow, stage_name: str,
                nodes: Optional[list[ServerResource]] = None,
                local: bool = False) -> ProblemTensors:
    """Lower one stage of a Flow into ProblemTensors.

    Node set: explicit `nodes` arg > stage.servers > all flow.servers > a
    single implicit "local" node with generous capacity (the `fleet up local`
    story, where placement degenerates to ordering).

    `local=True` lowers for single-machine execution: node-targeting
    constraints (label/tier eligibility, explicit anti-affinity, spread)
    are dropped — they describe cross-node placement and would otherwise
    fail a local deploy of a policied stage — while port/volume conflicts
    stay (two containers genuinely cannot bind one host port here).
    """
    stage = flow.stage(stage_name)
    # static sites ship via wrangler Pages, not containers: they consume no
    # node capacity and must not occupy port/conflict groups in the solve;
    # dependencies pointing AT them are vacuous for placement (the static
    # build/deploy runs before the container loop)
    resolved = stage.resolved_services(flow)
    static_names = {s.name for s in resolved
                    if s.service_type is ServiceType.STATIC}
    services = [s for s in resolved if s.name not in static_names]
    if not services and static_names:
        raise SolverError(
            f"stage {stage_name!r} is static-only (services "
            f"{sorted(static_names)} deploy via Pages); nothing to place")
    policy = stage.placement
    if local:
        # single-machine execution: the policy's node-targeting parts
        # (eligibility/preference/spread) describe a fleet this machine
        # isn't; quotas still apply (they bound the stage, not a node)
        policy = None if stage.placement is None else dataclasses.replace(
            stage.placement, tier=None, required_labels={},
            preferred_labels={}, spread_constraint=None)

    if nodes is None:
        if stage.servers:
            missing = [s for s in stage.servers if s not in flow.servers]
            if missing:
                raise SolverError(
                    f"stage {stage_name!r} references unknown servers {missing}")
            nodes = [flow.servers[s] for s in stage.servers]
        elif flow.servers:
            nodes = list(flow.servers.values())
        else:
            nodes = [local_node()]

    # ---- replica expansion -------------------------------------------------
    if all(s.replicas <= 1 for s in services):
        # no expansion at all (the fleet-scale aggregation shape): rows
        # ARE the services, and every per-row list is built in one pass
        rows = list(services)
        row_names = [s.name for s in services]
        replica_of = row_names
        base_index = {n: [i] for i, n in enumerate(row_names)}
    else:
        rows: list[Service] = []
        row_names, replica_of = [], []
        base_index = {}
        for svc in services:
            reps = max(svc.replicas, 1)
            name = svc.name
            if reps == 1:
                base_index[name] = [len(rows)]
                rows.append(svc)
                row_names.append(name)
                replica_of.append(name)
                continue
            idxs = list(range(len(rows), len(rows) + reps))
            rows.extend([svc] * reps)
            row_names.extend(f"{name}#{r}" for r in range(reps))
            replica_of.extend([name] * reps)
            base_index[name] = idxs
    S, N = len(rows), len(nodes)
    if S == 0:
        raise SolverError(f"stage {stage_name!r} has no services")

    # ---- demand / capacity -------------------------------------------------
    # per BASE service, expanded to rows with np.repeat: replicas share
    # demand, so the 10k-row as_tuple loop collapses to one per service
    reps_arr = np.fromiter((max(s.replicas, 1) for s in services),
                           dtype=np.int64, count=len(services))
    base_demand = np.array([s.resources.as_tuple() for s in services],
                           dtype=np.float32).reshape(len(services), _R)
    demand = np.repeat(base_demand, reps_arr, axis=0)
    capacity = np.array([n.capacity.as_tuple() for n in nodes], dtype=np.float32)

    # ---- dependency DAG over expanded rows ---------------------------------
    # edge endpoints are COLLECTED in python (dict lookups) but written to
    # the dense matrix in one fancy-index scatter: per-edge scalar
    # dep_adj[i, j] = True assignments cost ~1 us each in numpy, which at
    # ~15k edges was a visible slice of every fleet-scale lowering
    dep_adj = np.zeros((S, S), dtype=bool)
    esrc: list[int] = []
    edst: list[int] = []
    for svc in services:
        deps = svc.depends_on
        if not deps:
            continue
        rows_of = base_index[svc.name]
        single = len(rows_of) == 1
        for dep in deps:
            if dep in static_names:
                continue   # static targets ship before the container loop
            targets = base_index.get(dep)
            if targets is None:
                raise SolverError(
                    f"service {svc.name!r} depends on unknown service {dep!r}")
            if single and len(targets) == 1:   # common case: no replicas
                esrc.append(rows_of[0])
                edst.append(targets[0])
            else:
                for i in rows_of:
                    esrc.extend([i] * len(targets))
                    edst.extend(targets)
    src_a = np.asarray(esrc, dtype=np.int64)
    dst_a = np.asarray(edst, dtype=np.int64)
    dep_adj[src_a, dst_a] = True
    dep_depth = dependency_depths(dep_adj, row_names, edges=(src_a, dst_a))

    # ---- conflict id groups ------------------------------------------------
    port_key_ids: dict[tuple, int] = {}
    vol_key_ids: dict[str, int] = {}
    anti_key_ids: dict = {}   # str labels + ('pair', ...) tuples
    coloc_key_ids: dict[str, int] = {}

    # colocation groups are keyed by the TARGET service name, and the
    # target's own rows are members too: one-sided `a colocate_with b`
    # otherwise lowers to the singleton group {a}, whose coloc score
    # cc*(cc-1)/2 is identically 0 — the declared preference would have
    # no effect at all (the production example's api colocate-with cache
    # was such a no-op). anti_affinity gets
    # the symmetric treatment: its keys are group LABELS (all declarers
    # of "db-tier" mutually exclude), but when a key names a service,
    # that service joins the group too, so one-sided target-style
    # `a anti_affinity "db"` separates a from db instead of silently
    # doing nothing.
    coloc_targets = {k for svc in services for k in svc.colocate_with}
    unknown_coloc = coloc_targets - {s.name for s in services}
    if unknown_coloc:
        # unlike depends_on (hard error), colocation is a soft preference
        # and static services legitimately drop out of the container rows
        # — but a typo'd target means the declaration scores nothing, so
        # say so instead of silently lowering a dead preference
        from ..obs import get_logger
        get_logger("lower").warning(
            "colocate_with targets not in stage %r: %s (preference has "
            "no effect)", stage_name, sorted(unknown_coloc))

    # Target-style anti-affinity — a key naming a stage service means
    # "separate ME from THAT service" — lowers to one 2-member group per
    # (declarer row, target row) PAIR. Any shared-group formulation
    # over-constrains someone: a single group per target forces the
    # target's replicas apart from each other, and a group shared by all
    # declarer rows forces the declarer's replicas apart too — hard
    # constraints nobody declared (web anti_affinity
    # "db" with db replicas=2 on 2 nodes went infeasible). Pair groups
    # encode exactly the declared relation. `svc anti_affinity "<own
    # name>"` (self-anti, i.e. hard replica spreading) is special-cased:
    # mutual exclusion among all R replicas is exactly ONE shared group,
    # and lowering it pairwise would add R(R-1)/2 groups per service —
    # inflating the dense (N, G) group-counts plane on device at fleet
    # scale for identical semantics.
    anti_pair_ids: dict[int, list[int]] = {}
    if not local:
        for i, svc in enumerate(rows):
            for k in svc.anti_affinity:
                if k not in base_index:
                    continue
                if k == replica_of[i]:
                    # self-anti: all replicas of k share one group
                    gid = anti_key_ids.setdefault(("self", k),
                                                  len(anti_key_ids))
                    anti_pair_ids.setdefault(i, []).append(gid)
                    continue
                for j in base_index[k]:
                    if j == i:
                        continue
                    pair = ("pair", k, min(i, j), max(i, j))
                    gid = anti_key_ids.setdefault(pair, len(anti_key_ids))
                    anti_pair_ids.setdefault(i, []).append(gid)
                    anti_pair_ids.setdefault(j, []).append(gid)

    # Per BASE service (replicas share ports/volumes/labels/colocation, so
    # the id-assignment loop runs once per service, not once per row —
    # at 10k rows the per-row version was a visible slice of lower_ms);
    # only the pairwise anti groups are per-row and merged below.
    port_groups, vol_groups, anti_groups, coloc_groups = [], [], [], []
    _empty: list[int] = []     # shared by constraint-free rows, never mutated
    i = 0
    for svc, reps in zip(services, reps_arr):
        pg = ([port_key_ids.setdefault(p.key(), len(port_key_ids))
               for p in svc.ports] if svc.ports else _empty)
        vg = _empty
        if svc.volumes:
            vg = []
            for v in svc.volumes:
                ck = v.conflict_key()
                if ck is not None:
                    vg.append(vol_key_ids.setdefault(ck, len(vol_key_ids)))
        # anti_affinity keys that do NOT name a stage service stay
        # LABEL-style: all declarers of "db-tier" mutually exclude.
        # Target-style keys (naming a service) are handled via the
        # pairwise groups prepared above the loop.
        base_ag = ([anti_key_ids.setdefault(k, len(anti_key_ids))
                    for k in svc.anti_affinity if k not in base_index]
                   if svc.anti_affinity and not local else _empty)
        cg = _empty
        if svc.colocate_with or svc.name in coloc_targets:
            cg = [coloc_key_ids.setdefault(k, len(coloc_key_ids))
                  for k in svc.colocate_with]
            if svc.name in coloc_targets:
                cg.append(coloc_key_ids.setdefault(svc.name,
                                                   len(coloc_key_ids)))
            cg = list(dict.fromkeys(cg))
        for _ in range(reps):
            port_groups.append(pg)
            vol_groups.append(vg)
            if base_ag or i in anti_pair_ids:
                ag = base_ag + anti_pair_ids.get(i, [])
                anti_groups.append(list(dict.fromkeys(ag)))
            else:
                anti_groups.append(base_ag)
            coloc_groups.append(cg)
            i += 1

    # ---- eligibility / preference / validity / topology --------------------
    # policy matching is per-NODE (every service row in a stage shares the
    # stage's placement policy), so compute one row of N verdicts and
    # broadcast — a per-element Python loop here is O(S*N) = 10M iterations
    # at north-star scale and dominated the whole lowering
    node_ok = np.fromiter((_server_matches(policy, n) for n in nodes),
                          dtype=bool, count=N)
    node_pref = np.fromiter((_preference_row(policy, n) for n in nodes),
                            dtype=np.float32, count=N)
    eligible = (np.ones((S, N), dtype=bool) if node_ok.all()
                else np.broadcast_to(node_ok, (S, N)).copy())
    # the dense (S, N) f32 preference plane is 40 MB at 10k x 1k; only
    # materialize it when some node actually scores (node_pref decides —
    # the plane is a row broadcast, so an all-zero row means an all-zero
    # plane, which ProblemTensors represents as preferred=None)
    preferred = (np.broadcast_to(node_pref, (S, N)).copy()
                 if node_pref.any() else None)
    # quota enforcement (model.rs:40 ResourceQuota, FSC-26 Phase B-3): the
    # stage's aggregate demand must fit the declared ceiling — a violated
    # quota is a config error, reported at lowering with the excess named
    if policy and policy.resource_quota:
        q = policy.resource_quota
        if q.max_services is not None and S > q.max_services:
            raise SolverError(
                f"stage exceeds quota: {S} service rows > "
                f"max-services {q.max_services}")
        # float64 sum + float32-epsilon slack: ten services of float32 cpu
        # 0.1 must not "exceed" a quota of exactly 1
        totals = demand.astype(np.float64).sum(axis=0)
        for i, (name, cap_q) in enumerate(
                (("cpu", q.cpu), ("memory", q.memory), ("disk", q.disk))):
            if cap_q is not None and totals[i] > cap_q * (1 + 1e-6) + 1e-9:
                raise SolverError(
                    f"stage exceeds quota: total {name} demand "
                    f"{totals[i]:g} > quota {cap_q:g}")

    relax_order = list(policy.fallback_policy.relax_order) \
        if policy and policy.fallback_policy else []
    if not eligible.any(axis=1).all():
        # with an eligibility-class fallback declared, the solve pipeline
        # relaxes the mask instead of lowering failing outright
        can_relax = any(w in ELIGIBILITY_RELAX_CLASSES for w in relax_order)
        if not can_relax:
            bad = [row_names[i]
                   for i in np.flatnonzero(~eligible.any(axis=1))[:5]]
            raise SolverError(
                f"services {bad} have no eligible node under the placement "
                f"policy (declare a fallback{{}} to relax)")
    node_valid = np.ones(N, dtype=bool)

    topo_key = (policy.spread_constraint.topology_key
                if policy and policy.spread_constraint else None)
    topo_ids: dict[str, int] = {}
    node_topology = np.zeros(N, dtype=np.int32)
    if topo_key and topo_key != "node":
        for j, node in enumerate(nodes):
            lbl = node.labels.as_dict().get(topo_key, f"__node_{j}")
            node_topology[j] = topo_ids.setdefault(lbl, len(topo_ids))
    else:
        node_topology = np.arange(N, dtype=np.int32)

    pt = ProblemTensors(
        service_names=row_names,
        node_names=[n.name for n in nodes],
        demand=demand,
        capacity=capacity,
        dep_adj=dep_adj,
        dep_depth=dep_depth,
        port_ids=_pad_ids(port_groups),
        volume_ids=_pad_ids(vol_groups),
        anti_ids=_pad_ids(anti_groups),
        coloc_ids=_pad_ids(coloc_groups),
        eligible=eligible,
        node_valid=node_valid,
        node_topology=node_topology,
        strategy=policy.strategy if policy else PlacementStrategy.SPREAD_ACROSS_POOL,
        max_skew=(policy.spread_constraint.max_skew
                  if policy and policy.spread_constraint else 0),
        preferred=preferred,
        relax_order=relax_order,
        replica_of=replica_of,
    )
    pt.validate()
    return pt


# --------------------------------------------------------------------------
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
