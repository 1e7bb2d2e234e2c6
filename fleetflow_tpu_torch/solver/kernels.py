"""Exact rebuild, violation accounting and scoring (port of ``solver/kernels.py``).

Kernel K3 lives here: :func:`k3_rebuild` rebuilds a chain's carried state —
(N, R) load, (N, G) conflict occupancy, (N, Gc) colocation occupancy, (T,)
topology counts — from a dense assignment, optionally onto a frozen base,
and can also return the exact hard-violation stats. It replaces
``fleetflow_tpu/solver/anneal.py::chain_states_from_assignment`` and
``fleetflow_tpu/solver/kernels.py::violation_stats`` (with ``node_loads``,
``group_counts`` and ``_skew_excess``). On a CUDA tensor it launches
``csrc/k3_rebuild.cu`` (3 device launches, 2 without the stats); on a CPU
tensor it runs :func:`k3_rebuild_plain`, the plain PyTorch version the
tests hold against the JAX functions. An assignment past the last node
adds to no plane (the reference's scatter drops it) and counts as off
every node: ineligible and invalid, in no topology domain (the
reference's clamped gathers read node N-1 there: a deliberate difference,
ROADMAP.md).

Violation semantics (the "zero constraint violations" contract):
  - capacity:    count of (node, resource) cells with load > cap·(1+1e-6)
  - conflicts:   count of same-node pairs sharing a conflict id
  - eligibility: count of services placed on ineligible or invalid nodes
  - skew:        relu(max - min services per topology domain - max_skew)
                 over real rows, when a spread constraint is active

The gate must be deterministic: a float sum taken in run-dependent order can
flip a cell at the 1e-6 edge. Both versions therefore sum each node's load
in service-index order, the order of the reference's CPU scatter.

The soft score (lower is better) is plain PyTorch over the rebuilt planes:
spread minimizes Σu²/N, pack maximizes it, fill_lowest prefers low node
indices, plus preferred-label affinity and colocation rewards.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _ext
from .problem import TorchProblem, eligible_lookup

__all__ = ["W_HARD", "STAT_KEYS", "node_loads", "group_counts",
           "real_row_weights", "k3_rebuild", "k3_rebuild_plain",
           "stats_from_planes", "violation_stats", "soft_from_planes",
           "soft_score", "exact_stats_and_soft", "total_violations",
           "total_cost"]

# no TF32 anywhere in the plain versions (the float32 products must stay
# float32 on the card, as on the CPU)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W_HARD = 1e4  # weight of one hard violation vs the soft score range
STAT_KEYS = ("capacity", "conflicts", "eligibility", "skew", "total")
CAP_TOL = 1 + 1e-6
K3_INIT_BLOCKS = 1024  # csrc/k3_rebuild.cu: init blocks a row at most


def node_loads(prob: TorchProblem, assignment: torch.Tensor) -> torch.Tensor:
    """(N, R) resource load per node under one (S,) assignment (K3's load
    plane: rows summed in service-index order)."""
    return k3_rebuild(prob, assignment)[0][0]


def group_counts(prob: TorchProblem, assignment: torch.Tensor,
                 ids: torch.Tensor, G: int) -> torch.Tensor:
    """(N, G) count of services per (node, group id) for any (S, K) id
    table; -1 slots count nothing (integer, exact on any device)."""
    valid = ids >= 0
    flat = assignment.long()[:, None] * G + torch.where(valid, ids, 0).long()
    out = torch.zeros(prob.N * G, dtype=torch.int32, device=ids.device)
    out.index_add_(0, flat.reshape(-1), valid.reshape(-1).to(torch.int32))
    return out.view(prob.N, G)


def real_row_weights(prob: TorchProblem) -> torch.Tensor:
    """(S,) int32: 1 for real service rows, 0 for rows >= n_real."""
    return (torch.arange(prob.S, device=prob.device)
            < prob.real_rows).to(torch.int32)


def _batched(assignment: torch.Tensor) -> torch.Tensor:
    return assignment[None] if assignment.dim() == 1 else assignment


def _lane_batched(assignment: torch.Tensor) -> torch.Tensor:
    """(L, C, S) from a lane-stacked (L, S) or (L, C, S) assignment."""
    return assignment[:, None] if assignment.dim() == 2 else assignment


def k3_rebuild_plain(prob: TorchProblem, assignment: torch.Tensor,
                     base: Optional[tuple] = None, with_stats: bool = False):
    """Plain PyTorch version of K3; see :func:`k3_rebuild`. A lane-stacked
    problem runs the solo version lane by lane."""
    if prob.lanes:
        a = _lane_batched(assignment)
        outs = [k3_rebuild_plain(prob.lane(i), a[i], base, with_stats)
                for i in range(prob.lanes)]
        return tuple(None if parts[0] is None else torch.stack(parts)
                     for parts in zip(*outs))
    a = _batched(assignment).long()
    C, S = a.shape
    N, R, T = prob.N, prob.demand.shape[1], prob.T
    G, Gc1 = prob.G, max(prob.Gc, 1)
    dev = a.device
    # an out-of-range assignment adds to no plane, as XLA's scatter drops it
    inr = (a >= 0) & (a < N)
    a_safe = torch.where(inr, a, 0)
    chain_node = a_safe + (torch.arange(C, device=dev) * N)[:, None]
    keep = inr.reshape(-1)

    def start(b, shape, dtype):
        if b is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return b.to(dtype).expand(shape).clone()

    load0, used0, coloc0, topo0 = base if base is not None else (None,) * 4
    load = start(load0, (C, N, R), torch.float32)
    load.view(C * N, R).index_add_(
        0, chain_node.reshape(-1)[keep], prob.demand.repeat(C, 1)[keep])

    def occupancy(ids, width, b):
        out = start(b, (C, N, width), torch.int32)
        valid = (ids >= 0)[None] & inr[:, :, None]
        flat = (chain_node[:, :, None] * width
                + torch.where(ids >= 0, ids, 0).long()[None])
        out.view(-1).index_add_(0, flat.reshape(-1),
                                valid.to(torch.int32).reshape(-1))
        return out

    used = occupancy(prob.conflict_ids, G, used0)
    coloc = occupancy(prob.coloc_ids, Gc1, coloc0)
    topo = start(topo0, (C, T), torch.int32)
    tnode = prob.node_topology.long()[a_safe] + (torch.arange(C, device=dev)
                                                 * T)[:, None]
    topo.view(-1).index_add_(0, tnode.reshape(-1),
                             (real_row_weights(prob) * inr).reshape(-1))
    stats = (stats_from_planes(prob, a, load, used, topo)
             if with_stats else None)
    return load, used, coloc, topo, stats


def stats_from_planes(prob: TorchProblem, assignment: torch.Tensor,
                      load: torch.Tensor, used: torch.Tensor,
                      topo: torch.Tensor) -> torch.Tensor:
    """(C, 5) f32 exact stats [capacity, conflicts, eligibility, skew,
    total] from rebuilt planes (all counts are integers, exact in f32)."""
    a = _batched(assignment).long()
    cap_cells = (load > prob.capacity * CAP_TOL).sum((1, 2))
    u = used.long()
    conflicts = (u * (u - 1) // 2).sum((1, 2))
    rows = torch.arange(prob.S, device=a.device)[None]
    # an out-of-range assignment is off every node: ineligible and invalid
    inr = (a >= 0) & (a < prob.N)
    a_safe = torch.where(inr, a, 0)
    bad = ((~eligible_lookup(prob.eligible, rows, a_safe)).long()
           + (~prob.node_valid[a_safe]).long())
    elig = torch.where(inr, bad, 2).sum(1)
    if prob.max_skew > 0:
        spread = topo.max(1).values - topo.min(1).values
        skew = torch.clamp(spread.long() - prob.max_skew, min=0)
    else:
        skew = torch.zeros_like(elig)
    total = cap_cells + conflicts + elig + skew
    return torch.stack([cap_cells, conflicts, elig, skew, total],
                       1).to(torch.float32)


def k3_rebuild(prob: TorchProblem, assignment: torch.Tensor,
               base: Optional[tuple] = None, with_stats: bool = False):
    """K3: rebuild the carried planes of C chains from `assignment` (C, S)
    or (S,) i32. `base` = (load0 (N,R), used0 (N,G), coloc0 (N,Gc),
    topo0 (T,)) is a frozen remainder the rows accumulate onto. Returns
    (load (C,N,R) f32, used (C,N,G) i32, coloc (C,N,max(Gc,1)) i32,
    topo (C,T) i32, stats (C,5) f32 or None).

    A lane-stacked problem (L lanes) takes (L, C, S) or (L, S) and returns
    every output with a leading (L,) axis, one launch for all lanes; the
    base, if any, is shared by every lane."""
    if assignment.device.type == "cpu":
        return k3_rebuild_plain(prob, assignment, base, with_stats)
    if prob.lanes:
        a = _lane_batched(assignment).contiguous()
        lead = (prob.lanes,)
    else:
        a = _batched(assignment).contiguous()[None]
        lead = ()
    if a.dtype != torch.int32:
        raise ValueError("k3_rebuild: assignment must be int32")
    L, C, S = a.shape
    if S != prob.S or prob.demand.shape[-1] != 3:
        raise ValueError(f"k3_rebuild: assignment {tuple(a.shape)} does not "
                         f"match S={prob.S}, R=3")
    N, T, G, Gc1 = prob.N, prob.T, prob.G, max(prob.Gc, 1)
    dev = a.device
    load = torch.empty(lead + (C, N, 3), dtype=torch.float32, device=dev)
    used = torch.empty(lead + (C, N, G), dtype=torch.int32, device=dev)
    coloc = torch.empty(lead + (C, N, Gc1), dtype=torch.int32, device=dev)
    topo = torch.empty(lead + (C, T), dtype=torch.int32, device=dev)
    stats = (torch.empty(lead + (C, 5), dtype=torch.float32, device=dev)
             if with_stats else None)
    # 4 u64 accumulators and a done counter a row of the L·C rows, and the
    # base's conflict pairs (K3_INIT_BLOCKS u64 slots)
    R = L * C
    scratch = torch.empty(9 * R + 2 * K3_INIT_BLOCKS, dtype=torch.int32,
                          device=dev)
    load0, used0, coloc0, topo0 = base if base is not None else (None,) * 4
    n_real, _sticky = prob.lane_scalars()
    _ext.check_inputs("k3_rebuild", a, prob.demand, prob.conflict_ids,
                      prob.coloc_ids, prob.node_topology, prob.capacity,
                      prob.eligible, prob.node_valid,
                      lanes=prob.lanes or None)
    _ext.check_inputs("k3_rebuild", a, load0, used0, coloc0, topo0)
    _ext.launch(
        "k3_rebuild", "ff_k3_rebuild", dev,
        a, L, C, S, N, G, Gc1, T,
        prob.demand, prob.conflict_ids, prob.conflict_ids.shape[-1],
        prob.coloc_ids, prob.coloc_ids.shape[-1], prob.node_topology,
        _ext.lanes_arg(n_real),
        load0, used0, coloc0, topo0,
        load, used, coloc, topo,
        prob.capacity, prob.eligible, int(prob.eligible_packed),
        prob.eligible.shape[-1], prob.node_valid, prob.max_skew,
        stats, scratch)
    return load, used, coloc, topo, stats


def _stats_dict(row: torch.Tensor) -> dict:
    return {k: row[i] for i, k in enumerate(STAT_KEYS)}


def violation_stats(prob: TorchProblem, assignment: torch.Tensor) -> dict:
    """Exact hard-violation accounting of one (S,) assignment: a dict of
    0-dim f32 tensors keyed by STAT_KEYS."""
    *_planes, stats = k3_rebuild(prob, assignment, with_stats=True)
    return _stats_dict(stats[0])


def soft_from_planes(prob: TorchProblem, assignment: torch.Tensor,
                     load: torch.Tensor, coloc: torch.Tensor) -> torch.Tensor:
    """(C,) soft score of C assignments from their rebuilt load/coloc
    planes (kernels.soft_score's formulas; no stickiness bonus)."""
    a = _batched(assignment)
    u = load / torch.clamp(prob.capacity, min=1e-6)
    usq = (u * u).sum((1, 2))
    denom = float(max(prob.N, 1))
    if prob.strategy == 0:        # spread_across_pool: balance load
        strat = usq / denom
    elif prob.strategy == 1:      # pack_into_dedicated: concentrate load
        strat = -usq / denom
    else:                         # fill_lowest: prefer low node indices
        strat = (a.to(torch.float32) / denom).mean(1)
    soft = strat
    if prob.preferred is not None:
        rows = torch.arange(prob.S, device=a.device)[None]
        soft = soft - prob.preferred[rows, a.long()].mean(1)
    if prob.Gc > 0:
        cc = coloc.to(torch.float32)
        soft = soft - (cc * (cc - 1.0) / 2.0).sum((1, 2)) / float(
            max(prob.S, 1))
    return soft


def soft_score(prob: TorchProblem, assignment: torch.Tensor) -> torch.Tensor:
    """Strategy-dependent soft objective of one (S,) assignment (0-dim)."""
    load, _used, coloc, _topo, _ = k3_rebuild(prob, assignment)
    return soft_from_planes(prob, assignment, load, coloc)[0]


def exact_stats_and_soft(prob: TorchProblem,
                         assignment: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """From-scratch (stats, soft) of one assignment, from ONE K3 launch:
    the acceptance gate that commits a placement."""
    load, _used, coloc, _topo, stats = k3_rebuild(prob, assignment,
                                                  with_stats=True)
    return (_stats_dict(stats[0]),
            soft_from_planes(prob, assignment, load, coloc)[0])


def total_violations(prob: TorchProblem,
                     assignment: torch.Tensor) -> torch.Tensor:
    """Exact hard-violation total of an (S,) assignment (0-dim f32) or of
    (C, S) assignments ((C,) f32), from one K3 launch."""
    *_planes, stats = k3_rebuild(prob, assignment, with_stats=True)
    total = stats[:, STAT_KEYS.index("total")]
    return total[0] if assignment.dim() == 1 else total


def total_cost(prob: TorchProblem, assignment: torch.Tensor) -> torch.Tensor:
    """The annealing objective, W_HARD · violations + soft score, of an
    (S,) assignment (0-dim f32) or of (C, S) assignments ((C,) f32), from
    one K3 launch."""
    load, _used, coloc, _topo, stats = k3_rebuild(prob, assignment,
                                                  with_stats=True)
    cost = (W_HARD * stats[:, STAT_KEYS.index("total")]
            + soft_from_planes(prob, assignment, load, coloc))
    return cost[0] if assignment.dim() == 1 else cost
