"""Placement explanation: why is service X on node Y, and what else was
possible?

Operator-facing debugging the reference has no analog for (its placer is
an opaque dependency partition, engine.rs:67-85): given the lowered
instance and an assignment, break one service's placement down into the
solver's own terms — hard feasibility per node (eligibility, validity,
capacity fit, conflict-group occupancy) and the soft components the
anneal trades (strategy utilization delta, preference, colocation mates)
— mirroring anneal._proposal_delta term for term, but on the host in
numpy over one (1, N) slice plus the service's own conflict groups, so
an explain costs milliseconds even at fleet scale and needs no device.

The port's copy of ``fleetflow_tpu/solver/explain.py`` (numpy only); the
reference surfaces it as PlacementService.explain -> REST
GET /api/placement/explain?stage=&service= -> CLI
`fleet cp placement explain`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..lower.tensors import ProblemTensors

__all__ = ["explain_assignment"]


def _own_group_hits(ids: np.ndarray, assignment: np.ndarray, N: int,
                    row: int) -> np.ndarray:
    """(N,) count of OTHER members of `row`'s conflict groups per node.

    Iterates row's own ids (typically 1-3) and bincounts each group's
    members — O(K_own * S + N), never the dense (N, G) occupancy plane a
    mega-scale instance would turn into gigabytes per explain request."""
    hits = np.zeros(N, dtype=np.int64)
    if ids.size == 0:
        return hits
    own = ids[row][ids[row] >= 0]
    for g in own:
        members = (ids == g).any(axis=1)
        members[row] = False   # a service never conflicts with itself
        hits += np.bincount(assignment[members], minlength=N)
    return hits


def explain_assignment(pt: ProblemTensors, assignment: np.ndarray,
                       service: str, top_k: int = 5,
                       node_valid: Optional[np.ndarray] = None) -> dict:
    """Explain one service row's placement. Returns a JSON-ready dict:
    the chosen node's full breakdown, the top_k best alternatives by the
    same scoring, and per-category counts of hard-blocked nodes."""
    assignment = np.asarray(assignment)
    try:
        i = pt.service_names.index(service)
    except ValueError:
        raise KeyError(f"unknown service {service!r}; rows are "
                       f"{pt.service_names[:8]}...") from None
    N = pt.capacity.shape[0]
    valid = (np.asarray(node_valid) if node_valid is not None
             else pt.node_valid).astype(bool)
    d = pt.demand[i]                                     # (R,)

    # node load WITHOUT this service — float64 so re-accumulation cannot
    # drift a packed node across the tolerance the solver itself uses
    load = np.zeros((N, pt.capacity.shape[1]), dtype=np.float64)
    np.add.at(load, assignment, pt.demand.astype(np.float64))
    load[assignment[i]] -= d

    new_load = load + d[None, :]                          # (N, R)
    # RELATIVE tolerance, same as every solver feasibility check
    # (kernels/anneal use cap * (1 + 1e-6)): an absolute +1e-6 here made
    # explain contradict the solver's verdict on exactly-packed nodes
    fits = (new_load <= pt.capacity * (1 + 1e-6)).all(axis=1)
    eligible = pt.eligible[i].astype(bool)

    # conflict hits per family, self-excluded
    conflict_hits = np.zeros(N, dtype=np.int64)
    families = {}
    for fam, ids in (("ports", pt.port_ids), ("volumes", pt.volume_ids),
                     ("anti_affinity", pt.anti_ids)):
        hits = _own_group_hits(ids, assignment, N, i)
        families[fam] = hits
        conflict_hits += hits
    conflict_free = conflict_hits == 0

    # soft components (kernels.soft_score orientation: lower = better)
    # Every term carries the SAME scale it has in kernels.soft_score's
    # per-service delta, so the ranking here reproduces the solver's own
    # trade-offs: preference and colocation enter the objective as means
    # over S (one service's contribution is -pref/S, -mates/S), and
    # fill_lowest as (n/N)/S — an unscaled -pref here would overweight
    # preference by a factor of S and misreport the solver's optimal
    # choice as suboptimal.
    S_total = max(pt.demand.shape[0], 1)
    cap_safe = np.maximum(pt.capacity, 1e-6)
    u_before = load / cap_safe
    u_after = new_load / cap_safe
    d_usq = ((u_after * u_after).sum(axis=1)
             - (u_before * u_before).sum(axis=1)) / max(N, 1)
    strat = pt.strategy.value
    if strat == "pack_into_dedicated":
        strategy_term = -d_usq
    elif strat == "fill_lowest":
        strategy_term = (np.arange(N, dtype=np.float64)
                         / max(N, 1)) / S_total
    else:                       # spread_across_pool
        strategy_term = d_usq
    pref = (pt.preferred[i] if pt.preferred is not None
            else np.zeros(N, dtype=np.float32))
    # colocation mates already on each node (soft bonus per mate)
    coloc_mates = _own_group_hits(pt.coloc_ids, assignment, N, i)

    score = (strategy_term - pref / S_total - coloc_mates / S_total)
    ok = eligible & valid & fits & conflict_free

    def node_row(n: int) -> dict:
        return {
            "node": pt.node_names[n],
            "feasible": bool(ok[n]),
            "eligible": bool(eligible[n]),
            "valid": bool(valid[n]),
            "fits_capacity": bool(fits[n]),
            "conflicts": {fam: int(families[fam][n]) for fam in families},
            "strategy_term": round(float(strategy_term[n]), 6),
            "preference": round(float(pref[n]), 6),
            "coloc_mates": int(coloc_mates[n]),
            "score": round(float(score[n]), 6),
            "utilization_after": [round(float(x), 4) for x in u_after[n]],
        }

    chosen = int(assignment[i])
    order = np.argsort(np.where(ok, score, np.inf), kind="stable")
    # top_k best feasible alternatives EXCLUDING chosen (filter first,
    # then slice — slicing first silently returned top_k-1 whenever the
    # chosen node wasn't itself among the top_k)
    alternatives = [node_row(int(n)) for n in order
                    if ok[n] and int(n) != chosen][:top_k]
    # a degraded placement (e.g. the node died and the re-solve is still
    # infeasible) can leave the service on an infeasible node: a "rank"
    # among np.inf ties would be an index-order artifact, not a position
    chosen_rank = (int(np.nonzero(order == chosen)[0][0]) + 1
                   if ok[chosen] else None)
    return {
        "service": service,
        "row": i,
        "replica_of": (pt.replica_of[i] if pt.replica_of else service),
        "demand": [round(float(x), 4) for x in d],
        "strategy": strat,
        "chosen": node_row(chosen),
        "chosen_rank": chosen_rank,
        "alternatives": alternatives,
        "blocked_counts": {
            "ineligible": int((~eligible).sum()),
            "invalid": int((~valid).sum()),
            "capacity": int((eligible & valid & ~fits).sum()),
            "conflicts": int((eligible & valid & fits
                              & ~conflict_free).sum()),
            "feasible": int(ok.sum()),
            "total_nodes": N,
        },
    }
