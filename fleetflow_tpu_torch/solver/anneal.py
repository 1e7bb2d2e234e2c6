"""Simulated-annealing refinement on C chains (port of ``solver/anneal.py``).

Each chain keeps an incremental view of the placement — node loads (N, R),
conflict-group occupancy (N, G), colocation occupancy (N, Gc), topology
counts (T,) — so one proposal costs O(R + K + T), not a full re-score. The
chain axis is a batch dimension written out: every state tensor here is
(C, ...), where the reference vmapped one chain.

Two kernels live in this module, each beside its plain PyTorch version:

  K1 :func:`batched_step_apply`  one parallel-Metropolis sweep, given the
        drawn proposals (replaces ``_batched_step``, ``_proposal_delta`` and
        ``_move_delta_core``). Drawing stays outside the kernel, in
        :func:`draw_proposals`, so the tests can hand both packages the same
        proposals. Plain version: :func:`batched_step_plain`. The anneal
        loops bind it once a call (:func:`sweep_launcher`).
  K2 :func:`prerepair_state_counted`  the fused churn pre-repair loop.
        Plain version: :func:`prerepair_plain`.

The block loops (``anneal_adaptive_states``, ``anneal_states``) are driven
from the host, one launch per sweep and one host sync per block, where the
reference ran ``lax.while_loop``/``lax.scan`` on the device. Chain ranking
reads the carried state (plain PyTorch reductions); the winner's final
stats are rebuilt from scratch by K3 (solver/kernels.py).

The tenant multiplexer (solver/multiplex.py) stacks L same-tier problems on
a leading lane axis: K1 and K2 then take lane-stacked states (L, C, ...)
in one launch, and ``anneal_adaptive_lanes`` runs the adaptive loop of
every lane at once, each lane exiting on its own. The solo anneal is its
one-lane case.

On a chain mesh (``solve(mesh=)``, the ranks of a process group) each rank
anneals its :class:`ChainSlice` of the C chains: it draws the whole chain
set's proposals from the one generator and keeps its own chains' rows
(:func:`draw_proposals` with ``on_mesh``), so its chains walk exactly as
they do in a one-card anneal of all C; the adaptive exit is agreed over
the ranks once a block.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _ext
from .kernels import CAP_TOL, k3_rebuild
from .problem import TorchProblem, eligible_lookup, eligible_row

__all__ = ["ChainState", "TRACE_COLS", "W_CAP", "W_CONF", "W_ELIG", "W_SKEW",
           "chain_states_from_assignment", "prerepair_state",
           "prerepair_state_counted", "anneal", "anneal_adaptive",
           "prerepair_plain", "state_violation_stats",
           "violation_total_from_parts", "state_soft_score",
           "draw_proposals", "batched_step_apply", "batched_step_plain",
           "SweepLauncher", "sweep_launcher",
           "default_proposals_per_step",
           "backend_proposals_per_step", "anneal_states",
           "anneal_adaptive_states", "anneal_adaptive_lanes",
           "solve_trace_blocks", "temperature", "ChainSlice"]

W_CAP = 1e3     # per-unit overflow mass (normalized units)
W_CONF = 1e4    # per conflicting co-placement
W_ELIG = 1e6    # per ineligible placement
W_SKEW = 1e3    # per unit of excess skew

# one f32 row per sweep-block of the adaptive anneal (the flight deck)
TRACE_COLS = ("sweep", "temperature", "best_violations", "best_soft",
              "live_violations", "accepted")


def solve_trace_blocks(default: int = 16) -> int:
    """Telemetry buffer length in sweep-blocks, from FLEET_SOLVE_TRACE_BLOCKS
    (default 16; 0 disables the buffer)."""
    try:
        v = int(os.environ.get("FLEET_SOLVE_TRACE_BLOCKS", "") or default)
    except ValueError:
        v = default
    return max(0, min(v, 512))


class ChainSlice(NamedTuple):
    """A rank's chains on a chain mesh: rows [c0, c0 + per) of C, and the
    mesh's collectives group (``collectives.Group``)."""
    group: object
    c0: int
    C: int

    @property
    def per(self) -> int:
        return self.C // self.group.size


class ChainState(NamedTuple):
    assignment: torch.Tensor   # (C, S) i32
    load: torch.Tensor         # (C, N, R) f32
    used: torch.Tensor         # (C, N, G) i32   conflict-group occupancy
    coloc: torch.Tensor        # (C, N, Gc) i32  colocation occupancy (Gc>=1)
    topo: torch.Tensor         # (C, T) i32      services per topology domain

    def clone(self) -> "ChainState":
        return ChainState(*(t.clone() for t in self))

    def expand(self, chains: int) -> "ChainState":
        """C copies of a one-chain state (owned, not views)."""
        return ChainState(*(t.expand((chains,) + t.shape[1:]).clone()
                            for t in self))

    # a lane-stacked state (the multiplexer) carries a leading (L,) axis:
    # assignment (L, C, S), load (L, C, N, R), ...

    def lane(self, i: int) -> "ChainState":
        """Lane i of a lane-stacked state (views: updates land in it)."""
        return ChainState(*(t[i] for t in self))

    def as_lanes(self) -> "ChainState":
        """A state as a lane-stacked state of one lane (views)."""
        return ChainState(*(t.unsqueeze(0) for t in self))

    def expand_lanes(self, chains: int) -> "ChainState":
        """C copies of each lane's one-chain state (owned, not views)."""
        return ChainState(*(t.expand((t.shape[0], chains) + t.shape[2:])
                            .clone() for t in self))


def chain_states_from_assignment(prob: TorchProblem, assignment: torch.Tensor,
                                 base: Optional[tuple] = None) -> ChainState:
    """The carried state of each chain of `assignment` ((C, S) or (S,)),
    rebuilt by K3; `base` is an optional frozen (load0, used0, coloc0,
    topo0) remainder the rows accumulate onto. A lane-stacked problem
    takes (L, C, S) or (L, S) and gives a lane-stacked state."""
    if prob.lanes:
        a = assignment[:, None] if assignment.dim() == 2 else assignment
    else:
        a = assignment[None] if assignment.dim() == 1 else assignment
    load, used, coloc, topo, _ = k3_rebuild(prob, a, base)
    return ChainState(a.to(torch.int32).clone(), load, used, coloc, topo)


# -- K2: fused churn pre-repair -------------------------------------------

def prerepair_plain(prob: TorchProblem, st: ChainState,
                    max_moves: int) -> tuple[ChainState, torch.Tensor]:
    """Plain PyTorch version of K2; see :func:`prerepair_state_counted`. A
    lane-stacked problem runs the solo version lane by lane."""
    if prob.lanes:
        moves = [prerepair_plain(prob.lane(i), st.lane(i), max_moves)[1]
                 for i in range(prob.lanes)]
        return st, torch.cat(moves)
    a = st.assignment[0]
    load, used, coloc, topo = st.load[0], st.used[0], st.coloc[0], st.topo[0]
    rows = torch.arange(prob.S, device=a.device)
    stranded = (~eligible_lookup(prob.eligible, rows, a.long())
                | ~prob.node_valid[a.long()])
    # a service's stranded bit depends only on its own assignment, which
    # changes only when the loop takes it: the reference's "first stranded,
    # not yet attempted" walk is the initial stranded set in index order
    todo = torch.nonzero(stranded).flatten()[:max_moves].tolist()
    cap_tol = prob.capacity * CAP_TOL
    moves = 0
    for s in todo:
        d = prob.demand[s]
        ids = prob.conflict_ids[s]
        valid = ids >= 0
        safe = torch.where(valid, ids, 0).long()
        cids = prob.coloc_ids[s]
        cvalid = cids >= 0
        csafe = torch.where(cvalid, cids, 0).long()
        fits = ((load + d[None, :]) <= cap_tol).all(-1)
        conf_free = (used[:, safe] * valid).sum(-1) == 0
        elig = eligible_row(prob.eligible, s, prob.N) & prob.node_valid
        ok = fits & conf_free & elig
        util = (load / torch.clamp(prob.capacity, min=1e-6)).max(-1).values
        inf = torch.full_like(util, float("inf"))
        score = torch.where(ok, util, torch.where(elig, util + 1e6, inf))
        b = int(torch.argmin(score))
        if not bool(torch.isfinite(score[b])):
            continue                  # genuinely unplaceable: not a move
        src = int(a[s])
        load[src] = load[src] + (-d)
        load[b] = load[b] + d
        vi = valid.to(torch.int32)
        used[src].index_add_(0, safe, -vi)
        used[b].index_add_(0, safe, vi)
        ci = cvalid.to(torch.int32)
        coloc[src].index_add_(0, csafe, -ci)
        coloc[b].index_add_(0, csafe, ci)
        r = int(s < prob.real_rows)
        topo[int(prob.node_topology[src])] -= r
        topo[int(prob.node_topology[b])] += r
        a[s] = b
        moves += 1
    return st, torch.tensor([moves], dtype=torch.int32, device=a.device)


def prerepair_state_counted(prob: TorchProblem, st: ChainState,
                            max_moves: int) -> tuple[ChainState, torch.Tensor]:
    """K2, the fused churn pre-repair: relocate services stranded on
    invalid or ineligible nodes, in index order, at most `max_moves` of
    them, each to the least-utilized node that fits cleanly (capacity,
    conflicts, eligibility) or else the least-utilized eligible node; the
    first index wins ties. Updates the one-chain state `st` in place and
    returns (st, applied moves as a (1,) int32 device tensor); no host
    sync. A lane-stacked problem takes a lane-stacked one-chain state
    (L, 1, ...) and returns (L,) moves, one launch for all lanes."""
    chains = st.assignment.shape[1 if prob.lanes else 0]
    if chains != 1:
        raise ValueError("prerepair_state_counted takes a one-chain state")
    if st.assignment.device.type == "cpu":
        return prerepair_plain(prob, st, max_moves)
    dev = st.assignment.device
    L = prob.lanes or 1
    K, Kc = prob.conflict_ids.shape[-1], prob.coloc_ids.shape[-1]
    size = _ext.library("k2_prerepair").ff_k2_scratch_ints
    size.restype = ctypes.c_longlong
    moves = torch.empty(L, dtype=torch.int32, device=dev)
    scratch = torch.empty(L * size(prob.S, prob.N, K, Kc, int(max_moves)),
                          dtype=torch.int32, device=dev)
    n_real, _sticky = prob.lane_scalars()
    _ext.check_inputs("prerepair_state_counted", *st, prob.demand,
                      prob.capacity, prob.conflict_ids, prob.coloc_ids,
                      prob.eligible, prob.node_valid, prob.node_topology,
                      lanes=prob.lanes or None)
    _ext.launch(
        "k2_prerepair", "ff_k2_prerepair", dev,
        L, prob.S, prob.N, prob.G, st.coloc.shape[-1], prob.T,
        prob.demand, prob.capacity, prob.conflict_ids, K, prob.coloc_ids, Kc,
        prob.eligible, int(prob.eligible_packed), prob.eligible.shape[-1],
        prob.node_valid, prob.node_topology, _ext.lanes_arg(n_real),
        st.assignment, st.load, st.used, st.coloc, st.topo,
        int(max_moves), moves, scratch)
    return st, moves


def prerepair_state(prob: TorchProblem, st: ChainState,
                    max_moves: int) -> ChainState:
    """K2 (see :func:`prerepair_state_counted`), returning only the
    repaired state."""
    st, _moves = prerepair_state_counted(prob, st, max_moves)
    return st


# -- carried-state stats and soft score (plain PyTorch reductions) ---------

def violation_total_from_parts(prob: TorchProblem, load: torch.Tensor,
                               used: torch.Tensor, topo: torch.Tensor,
                               inelig_count: torch.Tensor) -> torch.Tensor:
    """(C,) total hard violations from node-state planes plus a count of
    services on ineligible or invalid nodes."""
    cap_cells = (load > prob.capacity * CAP_TOL).sum((1, 2))
    u = used.long()
    pairs = (u * (u - 1) // 2).sum((1, 2))
    total = cap_cells + pairs + inelig_count
    if prob.max_skew > 0:
        spread = (topo.max(1).values - topo.min(1).values).long()
        total = total + torch.clamp(spread - prob.max_skew, min=0)
    return total.to(torch.float32)


def _inelig_count(prob: TorchProblem, assignment: torch.Tensor) -> torch.Tensor:
    a = assignment.long()
    rows = torch.arange(prob.S, device=a.device)[None]
    return ((~eligible_lookup(prob.eligible, rows, a)).sum(1)
            + (~prob.node_valid[a]).sum(1))


def state_violation_stats(prob: TorchProblem, st: ChainState) -> dict:
    """Exact hard-violation stats of each chain from its CARRIED state:
    (C,) f32 tensors keyed capacity/conflicts/eligibility/skew/total."""
    cap_cells = (st.load > prob.capacity * CAP_TOL).sum((1, 2))
    u = st.used.long()
    pairs = (u * (u - 1) // 2).sum((1, 2))
    elig = _inelig_count(prob, st.assignment)
    if prob.max_skew > 0:
        spread = (st.topo.max(1).values - st.topo.min(1).values).long()
        skew = torch.clamp(spread - prob.max_skew, min=0)
    else:
        skew = torch.zeros_like(elig)
    f = torch.float32
    return {"capacity": cap_cells.to(f), "conflicts": pairs.to(f),
            "eligibility": elig.to(f), "skew": skew.to(f),
            "total": (cap_cells + pairs + elig + skew).to(f)}


def state_soft_score(prob: TorchProblem, st: ChainState) -> torch.Tensor:
    """(C,) soft score from the carried state; with `prob.sticky_prev` set,
    staying on the previous (still eligible and valid) node earns
    `sticky_w` per service."""
    u = st.load / torch.clamp(prob.capacity, min=1e-6)
    usq = (u * u).sum((1, 2))
    denom = float(max(prob.N, 1))
    if prob.strategy == 0:
        strat = usq / denom
    elif prob.strategy == 1:
        strat = -usq / denom
    else:
        strat = (st.assignment.to(torch.float32) / denom).mean(1)
    a = st.assignment.long()
    rows = torch.arange(prob.S, device=a.device)
    pref = torch.zeros_like(strat)
    if prob.preferred is not None:
        pref = -prob.preferred[rows[None], a].mean(1)
    if prob.sticky_prev is not None:
        prev = prob.sticky_prev.long()
        anchored = (eligible_lookup(prob.eligible, rows, prev)
                    & prob.node_valid[prev])
        at_prev = (a == prev[None]) & anchored[None]
        pref = pref - prob.sticky_w * at_prev.sum(1).to(torch.float32)
    soft = strat + pref
    if prob.Gc > 0:
        cc = st.coloc.to(torch.float32)
        soft = soft + (-(cc * (cc - 1.0) / 2.0).sum((1, 2))
                       / float(max(prob.S, 1)))
    return soft


# -- K1: one parallel-Metropolis sweep -------------------------------------

def draw_proposals(prob: TorchProblem, st: ChainState,
                   gen: torch.Generator, M: int,
                   on_mesh: Optional[ChainSlice] = None):
    """Draw one sweep's proposals for every chain: (s_idx (C,M) i32, b_idx
    (C,M) i32, u (C,M) f32). The first M//2 services are drawn
    categorically, weight 1 on services sitting on an overloaded,
    conflicted, ineligible or invalid node and e^-30 elsewhere (the
    reference's logits 0 / -30); the rest uniformly. Targets are uniform
    nodes, u is uniform on [0, 1).

    With `on_mesh` the state holds a rank's chains of a chain mesh: the
    whole chain set's proposals are drawn (the other chains' rows weighted
    as cold; a row's draws depend on that row's weights only) and this
    rank's rows are returned, as a one-card draw of all C would give
    them."""
    C = st.assignment.shape[0]
    dev = st.assignment.device
    over_node = (st.load > prob.capacity * CAP_TOL).any(-1)       # (C, N)
    conf_node = (st.used * (st.used - 1)).sum(-1) > 0             # (C, N)
    hot_node = over_node | conf_node
    a = st.assignment.long()
    rows = torch.arange(prob.S, device=dev)[None]
    svc_bad = (~eligible_lookup(prob.eligible, rows, a)
               | ~prob.node_valid[a])
    hot = torch.gather(hot_node, 1, a) | svc_bad                  # (C, S)
    if on_mesh is not None:
        full = torch.zeros((on_mesh.C, prob.S), dtype=torch.bool,
                           device=dev)
        full[on_mesh.c0:on_mesh.c0 + C] = hot
        hot, C = full, on_mesh.C
    weights = torch.where(hot, 1.0, float(np.exp(-30.0))).to(torch.float32)
    half = M // 2
    parts = []
    if half:
        parts.append(torch.multinomial(weights, half, replacement=True,
                                       generator=gen))
    parts.append(torch.randint(0, prob.S, (C, M - half), generator=gen,
                               device=dev))
    s_idx = torch.cat(parts, 1).to(torch.int32)
    b_idx = torch.randint(0, prob.N, (C, M), generator=gen, device=dev,
                          dtype=torch.int32)
    u = torch.rand((C, M), generator=gen, device=dev, dtype=torch.float32)
    if on_mesh is not None:
        mine = slice(on_mesh.c0, on_mesh.c0 + on_mesh.per)
        return (s_idx[mine].contiguous(), b_idx[mine].contiguous(),
                u[mine].contiguous())
    return s_idx, b_idx, u


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3, left to right (the order both the
    reference and the kernel use)."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _overflow_mass(load_rows, cap_rows):
    return _sum3(torch.clamp(load_rows - cap_rows, min=0.0)
                 / torch.clamp(cap_rows, min=1e-6))


def _soft_rows(prob: TorchProblem, load_a, load_b, cap_a, cap_b):
    """Strategy soft term restricted to the two touched node rows."""
    if prob.strategy not in (0, 1):
        return torch.zeros(load_a.shape[:-1], dtype=torch.float32,
                           device=load_a.device)
    ua = load_a / torch.clamp(cap_a, min=1e-6)
    ub = load_b / torch.clamp(cap_b, min=1e-6)
    usq = _sum3(ua * ua) + ub[..., 0] * ub[..., 0] + ub[..., 1] * ub[..., 1] \
        + ub[..., 2] * ub[..., 2]
    return usq / prob.N if prob.strategy == 0 else -usq / prob.N


def _skew_pen(prob: TorchProblem, tmax, tmin):
    skew = (tmax - tmin).to(torch.float32)
    return torch.clamp(skew - prob.max_skew, min=0.0) * W_SKEW


def _proposal_delta(prob: TorchProblem, st: ChainState, s, a, b):
    """(C, M) annealing-cost delta of moving service s from a to b against
    the pre-sweep state (the reference's _proposal_delta + _move_delta_core,
    term for term and in the same order)."""
    C = s.shape[0]
    dev = s.device
    cix = torch.arange(C, device=dev)[:, None]
    elig_a = eligible_lookup(prob.eligible, s, a) & prob.node_valid[a]
    elig_b = eligible_lookup(prob.eligible, s, b) & prob.node_valid[b]
    d_pref = torch.zeros(s.shape, dtype=torch.float32, device=dev)
    if prob.preferred is not None:
        d_pref = (prob.preferred[s, a] - prob.preferred[s, b]) / prob.S
    if prob.sticky_prev is not None:
        prev = prob.sticky_prev.long()[s]
        anchored = (eligible_lookup(prob.eligible, s, prev)
                    & prob.node_valid[prev])
        d_pref = d_pref + prob.sticky_w * (
            ((a == prev) & anchored).to(torch.float32)
            - ((b == prev) & anchored).to(torch.float32))
    d = prob.demand[s]                                          # (C, M, R)
    ids = prob.conflict_ids[s]                                  # (C, M, K)
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    cids = prob.coloc_ids[s]
    cvalid = cids >= 0
    csafe = torch.where(cvalid, cids, 0).long()

    cap_a, cap_b = prob.capacity[a], prob.capacity[b]
    load_a, load_b = st.load[cix, a], st.load[cix, b]
    over_before = (_overflow_mass(load_a, cap_a)
                   + _overflow_mass(load_b, cap_b))
    load_a2, load_b2 = load_a - d, load_b + d
    over_after = (_overflow_mass(load_a2, cap_a)
                  + _overflow_mass(load_b2, cap_b))
    d_cap = (over_after - over_before) * W_CAP

    c3 = cix[:, :, None]
    conf_a = ((st.used[c3, a[..., None], safe] - 1) * valid).sum(-1)
    conf_b = (st.used[c3, b[..., None], safe] * valid).sum(-1)
    d_conf = (conf_b - conf_a).to(torch.float32) * W_CONF
    d_elig = (elig_a.to(torch.float32) - elig_b.to(torch.float32)) * W_ELIG

    if prob.max_skew > 0:
        r = (s < prob.real_rows).to(torch.int32)
        ta = prob.node_topology.long()[a]
        tb = prob.node_topology.long()[b]
        topo2 = st.topo[:, None, :].expand(-1, s.shape[1], -1).clone()
        topo2.scatter_add_(2, ta[..., None], -r[..., None])
        topo2.scatter_add_(2, tb[..., None], r[..., None])
        t_max = st.topo.max(1).values[:, None]
        t_min = st.topo.min(1).values[:, None]
        d_skew = (_skew_pen(prob, topo2.max(2).values, topo2.min(2).values)
                  - _skew_pen(prob, t_max, t_min))
    else:
        d_skew = torch.zeros_like(d_pref)

    soft_before = _soft_rows(prob, load_a, load_b, cap_a, cap_b)
    soft_after = _soft_rows(prob, load_a2, load_b2, cap_a, cap_b)
    col_a = ((st.coloc[c3, a[..., None], csafe] - 1) * cvalid).sum(-1)
    col_b = (st.coloc[c3, b[..., None], csafe] * cvalid).sum(-1)
    d_coloc = (col_a - col_b).to(torch.float32) / max(prob.S, 1)
    return (d_cap + d_conf + d_elig + d_skew
            + (soft_after - soft_before) + d_pref + d_coloc)


def batched_step_plain(prob: TorchProblem, st: ChainState,
                       s_idx: torch.Tensor, b_idx: torch.Tensor,
                       u: torch.Tensor, temp, active=None):
    """Plain PyTorch version of K1; see :func:`batched_step_apply`. A
    lane-stacked problem runs the solo version on each active lane."""
    if prob.lanes:
        applied = torch.zeros(s_idx.shape[:2], dtype=torch.int32,
                              device=s_idx.device)
        for i in range(prob.lanes):
            if active is None or active[i]:
                applied[i] = batched_step_plain(
                    prob.lane(i), st.lane(i), s_idx[i], b_idx[i], u[i],
                    temp[i])[1]
        return st, applied
    C, M = s_idx.shape
    S, N = prob.S, prob.N
    dev = s_idx.device
    s, b = s_idx.long(), b_idx.long()
    a = torch.gather(st.assignment, 1, s).long()
    delta = _proposal_delta(prob, st, s, a, b)
    t = torch.clamp(torch.tensor(temp, dtype=torch.float32, device=dev),
                    min=1e-8)
    accept = ((delta < 0) | (u < torch.exp(-delta / t))) & (a != b)

    # winner per service: the lowest accepted proposal index; then at most
    # one arrival per target node (keeps a feasible chain feasible)
    order = torch.arange(M, dtype=torch.int64, device=dev).expand(C, M)
    none = torch.full_like(order, M)
    winner = torch.full((C, S), M, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, s, torch.where(accept, order, none), "amin")
    applied = accept & (torch.gather(winner, 1, s) == order)
    tgt = torch.full((C, N), M, dtype=torch.int64, device=dev)
    tgt.scatter_reduce_(1, b, torch.where(applied, order, none), "amin")
    applied = applied & (torch.gather(tgt, 1, b) == order)
    w = applied.to(torch.float32)
    wi = applied.to(torch.int32)

    cix = torch.arange(C, device=dev)[:, None]
    d = prob.demand[s]                                          # (C, M, R)
    R = d.shape[-1]
    flat_load = st.load.view(C * N, R)
    flat_load.index_add_(0, (cix * N + a).reshape(-1),
                         (-d * w[..., None]).reshape(-1, R))
    flat_load.index_add_(0, (cix * N + b).reshape(-1),
                         (d * w[..., None]).reshape(-1, R))

    def occupancy(plane, ids):
        width = plane.shape[2]
        v = (ids >= 0).to(torch.int32) * wi[..., None]
        sf = torch.where(ids >= 0, ids, 0).long()
        flat = plane.view(-1)
        flat.index_add_(0, ((cix * N + a)[..., None] * width + sf).reshape(-1),
                        -v.reshape(-1))
        flat.index_add_(0, ((cix * N + b)[..., None] * width + sf).reshape(-1),
                        v.reshape(-1))

    occupancy(st.used, prob.conflict_ids[s])
    occupancy(st.coloc, prob.coloc_ids[s])
    wt = wi * (s < prob.real_rows).to(torch.int32)
    T = st.topo.shape[1]
    topo_flat = st.topo.view(-1)
    topo_flat.index_add_(0, (cix * T + prob.node_topology.long()[a]).reshape(-1),
                         -wt.reshape(-1))
    topo_flat.index_add_(0, (cix * T + prob.node_topology.long()[b]).reshape(-1),
                         wt.reshape(-1))
    flat_assign = st.assignment.view(-1)
    pos = (cix * S + s)[applied]
    flat_assign[pos] = b_idx[applied]
    return st, wi.sum(1).to(torch.int32)


class SweepLauncher:
    """K1 bound to one problem and one state for the sweeps of one anneal
    call: the inputs are checked, the C arguments built and the library
    looked up once, and each sweep passes only its draws, temperatures and
    active lanes. It launches on the stream current when it was built,
    into one `applied` buffer it returns from every call (read it before
    the next sweep; stream order makes that safe). Build one per call and
    drop it with the call: a replaced or merged problem must never be
    launched through its pointers. `st` is (C, ...), or (L, C, ...) with a
    lane-stacked problem; every sweep draws M proposals a chain."""

    def __init__(self, prob: TorchProblem, st: ChainState, M: int):
        lead = st.assignment.shape[:-1]
        self.L = prob.lanes or 1
        if len(lead) != (2 if prob.lanes else 1):
            raise ValueError("SweepLauncher: the state must be (C, ...), or "
                             "(L, C, ...) with a lane-stacked problem")
        _ext.check_inputs("batched_step_apply", *st, prob.demand,
                          prob.capacity, prob.conflict_ids, prob.coloc_ids,
                          prob.eligible, prob.node_valid, prob.node_topology,
                          prob.preferred, prob.sticky_prev,
                          lanes=prob.lanes or None)
        self.dev = st.assignment.device
        self.shape = (*lead, M)
        n_real, sticky_w = prob.lane_scalars()
        if prob.sticky_prev is None:
            sticky_w = None
        self.lanes = _ext.lanes_arg(n_real, sticky_w)
        lib = _ext.library("k1_sweep")
        if lib.ff_k1_static_size() != ctypes.sizeof(_ext.SweepArgs):
            raise RuntimeError("k1_sweep: the C argument struct does not "
                               "match _ext.SweepArgs")
        self.args = _ext.SweepArgs(
            _ext.ProblemArgs(
                prob.S, prob.N, prob.G, st.coloc.shape[-1],
                st.topo.shape[-1], prob.conflict_ids.shape[-1],
                prob.coloc_ids.shape[-1], prob.demand.data_ptr(),
                prob.capacity.data_ptr(), prob.conflict_ids.data_ptr(),
                prob.coloc_ids.data_ptr(), prob.eligible.data_ptr(),
                int(prob.eligible_packed), prob.eligible.shape[-1],
                prob.node_valid.data_ptr(), prob.node_topology.data_ptr(),
                _ptr(prob.preferred), _ptr(prob.sticky_prev), 0.0,
                prob.strategy, prob.max_skew, 0),
            self.L, lead[-1], M, st.assignment.data_ptr(),
            st.load.data_ptr(), st.used.data_ptr(), st.coloc.data_ptr(),
            st.topo.data_ptr())
        self.fn = lib.ff_k1_sweep
        self.fn.argtypes = [ctypes.c_void_p, _ext.Lanes, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p]
        self.stream = torch.cuda.current_stream(self.dev).cuda_stream
        self.applied = torch.empty(lead, dtype=torch.int32, device=self.dev)
        # the prob/state tensors stay alive while the pointers are in use
        self._keep = (prob, st)

    def __call__(self, s_idx: torch.Tensor, b_idx: torch.Tensor,
                 u: torch.Tensor, temps, active=None) -> torch.Tensor:
        """One sweep with `temps` (one temperature a lane) and `active`
        (None: every lane sweeps); returns the applied moves, (C,) or
        (L, C)."""
        for x, dt in ((s_idx, torch.int32), (b_idx, torch.int32),
                      (u, torch.float32)):
            if (x.shape != self.shape or x.dtype != dt
                    or x.device != self.dev or not x.is_contiguous()):
                raise ValueError(
                    "batched_step_apply: proposals must be contiguous "
                    f"{self.shape} i32, i32, f32 on {self.dev}")
        if len(temps) != self.L:
            raise ValueError("batched_step_apply: one temperature per lane")
        lanes = self.lanes
        for i in range(self.L):
            lanes.temp[i] = temps[i]
            lanes.active[i] = 1 if active is None or active[i] else 0
        _ext.raise_on("k1_sweep", self.fn(
            ctypes.addressof(self.args), lanes, s_idx.data_ptr(),
            b_idx.data_ptr(), u.data_ptr(), self.applied.data_ptr(),
            self.stream))
        return self.applied


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def sweep_launcher(prob: TorchProblem, st: ChainState, M: int):
    """The per-sweep K1 call of an anneal loop: a :class:`SweepLauncher`
    on the card, on the CPU the plain version. Called as fn(s_idx, b_idx,
    u, temps, active) with one temperature a lane (one for a solo
    problem); returns the applied moves."""
    if st.assignment.device.type == "cpu":
        def plain(s_idx, b_idx, u, temps, active=None):
            temp = temps if prob.lanes else temps[0]
            return batched_step_plain(prob, st, s_idx, b_idx, u, temp,
                                      active)[1]
        return plain
    return SweepLauncher(prob, st, M)


def batched_step_apply(prob: TorchProblem, st: ChainState,
                       s_idx: torch.Tensor, b_idx: torch.Tensor,
                       u: torch.Tensor, temp, active=None):
    """K1: one parallel-Metropolis sweep of every chain, given M proposals
    per chain (move service s_idx[c, m] to node b_idx[c, m], uniform draw
    u[c, m]). Deltas are evaluated against the pre-sweep state; a proposal
    is accepted when Δ<0 or u<exp(-Δ/T), the lowest accepted index wins per
    service and per target node, and the winners are applied to `st` in
    place (departures in proposal order, then arrivals). Returns (st, the
    applied moves per chain as (C,) int32).

    A lane-stacked problem (L lanes) takes the state (L, C, ...), the
    proposals (L, C, M), one temperature per lane in `temp` and, in
    `active`, which lanes sweep (None: all); an inactive lane is left
    untouched and applies 0 moves. One launch for all lanes; returns (st,
    applied (L, C)). An anneal loop binds K1 once with
    :func:`sweep_launcher` instead."""
    if s_idx.device.type == "cpu":
        return batched_step_plain(prob, st, s_idx, b_idx, u, temp, active)
    temps = list(temp) if prob.lanes else [temp]
    launcher = SweepLauncher(prob, st, s_idx.shape[-1])
    return st, launcher(s_idx, b_idx, u, temps, active)


def default_proposals_per_step(S: int) -> int:
    """Proposals per chain per sweep on the card: 256, halved for tiny
    instances (the reference's accelerator width)."""
    return max(1, min(256, S // 2))


def backend_proposals_per_step(S: int, device: torch.device) -> int:
    """64 on the CPU (sweep cost is ~linear in width there), else the
    card's width."""
    if torch.device(device).type == "cpu":
        return max(1, min(64, S // 2))
    return default_proposals_per_step(S)


def temperature(t0: float, t1: float, max_steps: int, i: int) -> float:
    """The geometric schedule t0 -> t1 over max_steps sweeps, clamped at
    t1, evaluated in float32 as the reference does."""
    decay = (t1 / t0) ** (1.0 / max(max_steps - 1, 1))
    e = np.float32(min(i, max_steps - 1))
    return float(np.float32(t0) * np.power(np.float32(decay), e))


def anneal_states(prob: TorchProblem, init_assignments: torch.Tensor,
                  gen: torch.Generator, steps: int = 2000, t0: float = 1.0,
                  t1: float = 1e-3,
                  proposals_per_step: Optional[int] = None,
                  on_mesh: Optional[ChainSlice] = None) -> ChainState:
    """Fixed-budget anneal: `steps` sweeps on C chains; returns each
    chain's FINAL state (no best-ever tracking). `on_mesh`: the chains are
    a rank's slice of a chain mesh."""
    C, S = init_assignments.shape
    M = (proposals_per_step if proposals_per_step is not None
         else default_proposals_per_step(S))
    states = chain_states_from_assignment(prob, init_assignments)
    sweep = sweep_launcher(prob, states, M)
    for i in range(steps):
        s_idx, b_idx, u = draw_proposals(prob, states, gen, M, on_mesh)
        sweep(s_idx, b_idx, u, [temperature(t0, t1, steps, i)])
    return states


def anneal(prob: TorchProblem, init_assignments: torch.Tensor,
           gen: torch.Generator, steps: int = 2000, t0: float = 1.0,
           t1: float = 1e-3,
           proposals_per_step: Optional[int] = None) -> torch.Tensor:
    """Fixed-budget anneal; returns the refined (C, S) assignments (each
    chain's final state)."""
    return anneal_states(prob, init_assignments, gen, steps=steps, t0=t0,
                         t1=t1,
                         proposals_per_step=proposals_per_step).assignment


def anneal_adaptive(prob: TorchProblem, init_assignments: torch.Tensor,
                    gen: torch.Generator, max_steps: int = 128,
                    block: int = 32, t0: float = 1.0, t1: float = 1e-3,
                    proposals_per_step: Optional[int] = None):
    """Adaptive anneal; returns (assignments (C, S), sweeps_run, accepted
    (C,)): each chain's best-ever state, see
    :func:`anneal_adaptive_states`."""
    best, _viol, _soft, sweeps, accepted, _telem = anneal_adaptive_states(
        prob, init_assignments, gen, max_steps=max_steps, block=block,
        t0=t0, t1=t1, proposals_per_step=proposals_per_step)
    return best, sweeps, accepted


def anneal_adaptive_states(prob: TorchProblem, init_assignments: torch.Tensor,
                           gen: torch.Generator, max_steps: int = 128,
                           block: int = 32, t0: float = 1.0,
                           t1: float = 1e-3,
                           proposals_per_step: Optional[int] = None,
                           init_states: Optional[ChainState] = None,
                           exit_on_feasible_init: bool = False,
                           trace_blocks: int = 0):
    """Anneal in `block`-sweep chunks, stopping after the first block in
    which any chain has SEEN an exactly feasible state (or at max_steps).

    Returns (best_assignments (C, S), best_viols (C,), best_softs (C,),
    sweeps_run int, accepted (C,), telemetry dict) where best is each
    chain's lexicographically lowest (violations, soft) state ever visited.
    The exit check is the one host sync per block. `exit_on_feasible_init`
    (the resident warm path) skips even the first block when a chain
    starts feasible. `trace_blocks` > 0 records one TRACE_COLS row per
    block, the first trace_blocks blocks only. One lane of
    :func:`anneal_adaptive_lanes`."""
    C, S = init_assignments.shape
    M = (proposals_per_step if proposals_per_step is not None
         else default_proposals_per_step(S))
    states = (init_states if init_states is not None else
              chain_states_from_assignment(prob, init_assignments))
    best, viol, soft, sweeps, accepted, telem = anneal_adaptive_lanes(
        prob.as_lanes(), states.as_lanes(), [gen], [t0], [t1],
        max_steps=max_steps, block=block, proposals_per_step=M,
        exit_on_feasible_init=exit_on_feasible_init,
        trace_blocks=trace_blocks)
    return best[0], viol[0], soft[0], sweeps[0], accepted[0], telem[0]


def _agree_seen(seen: torch.Tensor,
                on_mesh: Optional[ChainSlice]) -> torch.Tensor:
    """(L,) "some chain saw a feasible state", over every rank's chains
    of a chain mesh (a MIN of the unseen flags), so every rank exits
    alike; as it is without a mesh."""
    if on_mesh is None:
        return seen
    from .collectives import all_min_
    return all_min_((~seen).to(torch.int32), on_mesh.group) == 0


def _mesh_chain_rows(on_mesh: ChainSlice, rows: list, viol0, soft0):
    """A chain mesh's telemetry, read once after the loop: every rank's
    recorded per-chain columns gathered into the whole chain set and
    reduced as a one-card anneal reduces its rows (in place in `rows`);
    returns the whole set's initial (violations, soft), (1, C) each."""
    from .collectives import all_gather
    recorded = rows[0]
    mine = torch.stack([viol0[0], soft0[0]]
                       + [r for _e, _t, dev_row in recorded
                          for r in dev_row])
    every = all_gather(mine, on_mesh.group)          # (W, 2 + 4B, C/W)
    whole = every.permute(1, 0, 2).reshape(mine.shape[0], on_mesh.C)
    for k, (end, temp, _) in enumerate(recorded):
        bv, bs, v, acc = whole[2 + 4 * k:6 + 4 * k]
        recorded[k] = (end, temp, torch.stack([
            bv.min(), _lead_soft(bv[None], bs[None])[0], v.min(),
            acc.sum()]))
    return whole[0:1], whole[1:2]


def _stack(parts: list) -> torch.Tensor:
    """torch.stack, as a view when there is one part."""
    return parts[0].unsqueeze(0) if len(parts) == 1 else torch.stack(parts)


def _lead_soft(best_viol: torch.Tensor, best_soft: torch.Tensor):
    """(L,) best soft among each lane's least-violating chains."""
    least = best_viol == best_viol.min(1, keepdim=True).values
    return torch.where(least, best_soft,
                       torch.full_like(best_soft, float("inf"))).min(1).values


def anneal_adaptive_lanes(prob: TorchProblem, states: ChainState,
                          gens: list, t0s: list, t1s: list, *,
                          max_steps: int, block: int,
                          proposals_per_step: int,
                          exit_on_feasible_init: bool = False,
                          trace_blocks: int = 0, live: Optional[list] = None,
                          on_mesh: Optional[ChainSlice] = None):
    """The adaptive anneal of L lanes of a lane-stacked problem at once
    (the multiplexer's vmapped while_loop), from the lane-stacked state
    `states` (L, C, ...), which it updates in place.

    Each lane is the solo anneal of its own stage: it draws from its own
    generator `gens[l]` in the solo order, runs its own schedule t0s[l] ->
    t1s[l] and exits on its own. A lane that has exited stays frozen (K1
    skips it, it draws nothing more), so its state, best-ever and sweep
    count are exactly what the solo anneal leaves; lanes not in `live`
    (the ladder's padding) never sweep. The carried scores are computed
    lane by lane, in the solo layout, so their float sums are the solo
    sums. One K1 launch a sweep for all lanes and one host sync a block,
    on the (L,) "seen feasible" vector.

    Returns (best (L, C, S), best_viol (L, C), best_soft (L, C), sweeps
    [L ints], accepted (L, C), [L telemetry dicts]), each lane as
    :func:`anneal_adaptive_states` returns it.

    With `on_mesh` (one lane) the states are a rank's chains of a chain
    mesh:
    the exit is agreed over the mesh once a block (any chain of any rank
    saw a feasible state) and the telemetry reads every rank's chains;
    the per-chain returns are this rank's."""
    L, C, S = states.assignment.shape
    if on_mesh is not None and (L != 1 or C != on_mesh.per):
        raise ValueError("a chain mesh runs one lane of its rank's chains")
    M = proposals_per_step
    live = [True] * L if live is None else [bool(x) for x in live]
    dev = states.assignment.device
    views = [prob.lane(i) for i in range(L)]
    n_blocks = -(-max_steps // block)
    # what a lane that does not sweep contributes: proposals K1 ignores and
    # scores that never improve its best (one lane always sweeps when the
    # loop runs)
    idle = idle_score = None
    if L > 1:
        idle = (torch.zeros((C, M), dtype=torch.int32, device=dev),
                torch.zeros((C, M), dtype=torch.int32, device=dev),
                torch.zeros((C, M), dtype=torch.float32, device=dev))
        idle_score = torch.full((C,), float("inf"), device=dev)

    def lane_scores(i):
        st = states.lane(i)
        return (state_violation_stats(views[i], st)["total"],
                state_soft_score(views[i], st))

    def scores(active):
        per = [lane_scores(i) if active[i] else (idle_score, idle_score)
               for i in range(L)]
        return _stack([v for v, _ in per]), _stack([f for _, f in per])

    viol0, soft0 = scores(live)
    best_assign = states.assignment.clone()
    best_viol, best_soft = viol0.clone(), soft0.clone()
    seen = _agree_seen(viol0.min(1).values == 0, on_mesh)
    accepted = torch.zeros((L, C), dtype=torch.int32, device=dev)
    rows: list = [[] for _ in range(L)]
    ran = [0] * L
    done = seen.tolist() if exit_on_feasible_init else [False] * L
    active = [live[i] and not done[i] for i in range(L)]
    step = None           # K1 bound at the first sweep (many solves run none)
    b = 0
    while any(active) and b < n_blocks:
        for j in range(block):
            sweep = b * block + j
            temps = [temperature(t0s[i], t1s[i], max_steps, sweep)
                     for i in range(L)]
            draws = [draw_proposals(views[i], states.lane(i), gens[i], M,
                                    on_mesh)
                     if active[i] else idle for i in range(L)]
            s_idx, b_idx, u = (_stack([d[k] for d in draws])
                               for k in range(3))
            if step is None:
                step = sweep_launcher(prob, states, M)
            accepted += step(s_idx, b_idx, u, temps, active)
            viol, soft = scores(active)
            # lexicographic (violations, soft): feasibility dominates and
            # soft stays a full-precision tie-break
            better = (viol < best_viol) | ((viol == best_viol)
                                           & (soft < best_soft))
            best_viol = torch.where(better, viol, best_viol)
            best_soft = torch.where(better, soft, best_soft)
            best_assign = torch.where(better[..., None], states.assignment,
                                      best_assign)
            seen = seen | (viol.min(1).values == 0)
        if b < trace_blocks:
            # host numbers stay on the host; the device half of the row is
            # read once, after the loop (no extra sync, no upload)
            end = (b + 1) * block
            if on_mesh is not None:
                # the per-chain columns, reduced over every rank's chains
                # after the loop
                dev_rows = torch.stack([best_viol, best_soft, viol,
                                        accepted.to(torch.float32)], 1)
            else:
                dev_rows = torch.stack([best_viol.min(1).values,
                                        _lead_soft(best_viol, best_soft),
                                        viol.min(1).values,
                                        accepted.sum(1).to(torch.float32)],
                                       1)
            for i in range(L):
                if active[i]:
                    rows[i].append((float(end), temperature(
                        t0s[i], t1s[i], max_steps, end - 1), dev_rows[i]))
        b += 1
        seen = _agree_seen(seen, on_mesh)
        seen_h = seen.tolist()
        for i in range(L):
            if active[i]:
                ran[i] += 1
                active[i] = not seen_h[i]
    if on_mesh is not None:
        viol0, soft0 = _mesh_chain_rows(on_mesh, rows, viol0, soft0)
    init_v = viol0.min(1).values
    init_s = _lead_soft(viol0, soft0)
    telemetry = [{
        # [(sweep, temperature, device (best_violations, best_soft,
        #   live_violations, accepted))] per recorded block
        "blocks": rows[i],
        "init_violations": init_v[i],
        "init_soft": init_s[i],
    } for i in range(L)]
    return (best_assign, best_viol, best_soft, [r * block for r in ran],
            accepted, telemetry)
