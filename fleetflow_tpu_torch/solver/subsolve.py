"""Active-set warm solves: churn-localized sub-problem annealing (port of
``solver/subsolve.py``).

Steady-state churn is sparse: the rows that can move are the AFFECTED set
(services stranded on a killed node, arrivals, demand and eligibility
drift, rows on capacity-shrunk nodes) plus their constraint closure. A
warm reschedule therefore first tries to solve exactly that set:

  ActiveIndex   host constraint index, built once per resident staging:
                conflict ids, coloc ids, dependency adjacency and replica
                groups, each inverted id -> rows
  plan_active   the closure rule (affected rows, rows sharing a conflict
                or coloc id, dependency neighbours, replica siblings),
                padded onto a mini tier (256/512/.../4096 rows), with the
                FROZEN remainder's load, conflict/coloc occupancy and
                topology counts as the sub-problem's base state
  subsolve      on the device: gather the closure rows' planes (K5),
                rebuild the mini state onto the frozen base (K3), the
                fused pre-repair (K2) and at most SUB_MAX_STEPS sweeps of
                the adaptive anneal (K1) over the mini tier, pick the
                winning chain and scatter its rows into a FRESH copy of
                the resident assignment (K5), then the exact full-problem
                stats of the result (K3): the gate that decides whether
                the localized result commits

A gate-rejected sub-solve is discarded and the full path re-runs from the
untouched resident assignment, which is why the commit never writes into
it. Closures above FLEET_SUBSOLVE_FRAC of the real rows (or past the tier
ladder) fall back to the full path before any device work.

Knobs, as in the reference: FLEET_SUBSOLVE=0 disables; FLEET_SUBSOLVE_FRAC
(default 0.25); FLEET_SUBSOLVE_MIN / FLEET_SUBSOLVE_MAX (default 256 /
4096) bound the mini tier ladder.

Kernel K5 lives here, two entry points of ``csrc/k5_subsolve.cu``:
:func:`k5_gather` builds the mini problem's planes and seed from the
resident ones, :func:`k5_commit` picks the chain and scatters it. On a CPU
tensor each runs its plain PyTorch version (:func:`k5_gather_plain`,
:func:`k5_commit_plain`), on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import _ext
from .anneal import (anneal_adaptive_states, chain_states_from_assignment,
                     prerepair_state_counted)
from .buckets import subsolve_tier, width_bucket
from .kernels import exact_stats_and_soft
from .problem import TorchProblem, unify_conflict_ids

__all__ = ["SubsolveConfig", "subsolve_config", "ActiveIndex", "ActivePlan",
           "plan_active", "stage_subsolve", "subsolve", "subsolve_dispatch",
           "k5_gather", "k5_gather_plain", "k5_commit", "k5_commit_plain",
           "SUB_OUTCOMES", "SUB_MAX_STEPS", "OUTCOME_COUNTS",
           "record_outcome"]

# the outcome vocabulary: localized = the mini anneal's result passed the
# exact full-problem gate; fallback_closure = the closure exceeded the size
# cap; fallback_small = nothing to localize or the problem is too small;
# fallback_infeasible = the gate rejected the result and the full path ran
SUB_OUTCOMES = ("localized", "fallback_closure", "fallback_small",
                "fallback_infeasible")
OUTCOME_COUNTS: dict[str, int] = {o: 0 for o in SUB_OUTCOMES}


def record_outcome(outcome: str) -> None:
    OUTCOME_COUNTS[outcome] += 1


@dataclass(frozen=True)
class SubsolveConfig:
    enabled: bool = True
    frac: float = 0.25       # closure cap as a fraction of real rows
    min_tier: int = 256      # first mini tier
    max_tier: int = 4096     # largest mini tier (beyond: full path)


def subsolve_config(default_enabled: bool = True) -> SubsolveConfig:
    """The active-set knobs, read from the environment on each call."""
    def _f(name, d):
        try:
            return float(os.environ.get(name, "") or d)
        except ValueError:
            return d
    v = os.environ.get("FLEET_SUBSOLVE", "").strip().lower()
    enabled = (default_enabled if not v
               else v not in ("0", "false", "off", "no"))
    return SubsolveConfig(
        enabled=enabled,
        frac=min(max(_f("FLEET_SUBSOLVE_FRAC", 0.25), 0.0), 1.0),
        min_tier=max(int(_f("FLEET_SUBSOLVE_MIN", 256)), 8),
        max_tier=max(int(_f("FLEET_SUBSOLVE_MAX", 4096)), 8),
    )


def _invert_ids(ids: np.ndarray):
    """CSR inversion of a (S, K) -1-padded id table: (uniq ids, offsets,
    rows) such that rows[offsets[i]:offsets[i+1]] carry uniq[i]."""
    mask = ids >= 0
    if not mask.any():
        return (np.empty(0, np.int64), np.zeros(1, np.int64),
                np.empty(0, np.int64))
    rows = np.nonzero(mask)[0]
    vals = ids[mask]
    order = np.argsort(vals, kind="stable")
    vals, rows = vals[order], rows[order]
    uniq, starts = np.unique(vals, return_index=True)
    offsets = np.append(starts, vals.size)
    return uniq, offsets, rows


class ActiveIndex:
    """Host constraint index over a resident staging's ProblemTensors,
    built once per staging and reused every burst."""

    def __init__(self, pt):
        self.pt = pt
        self.S = pt.S
        self.conflict = unify_conflict_ids(pt)               # (S, K)
        self.coloc = np.asarray(pt.coloc_ids, dtype=np.int32)
        self._conf_inv = _invert_ids(self.conflict)
        self._coloc_inv = _invert_ids(self.coloc)
        self._dep = np.asarray(pt.dep_adj, dtype=bool)
        # replica groups: rows sharing a base service move together
        self._groups: dict[str, list[int]] = {}
        for i, base in enumerate(pt.replica_of or ()):
            self._groups.setdefault(base, []).append(i)

    @staticmethod
    def _rows_sharing(inv, ids: np.ndarray) -> np.ndarray:
        uniq, offs, rows = inv
        ids = np.unique(ids[ids >= 0])
        if not ids.size or not uniq.size:
            return np.empty(0, np.int64)
        pos = np.searchsorted(uniq, ids)
        pos = pos[pos < uniq.size]
        pos = pos[np.isin(uniq[pos], ids)]
        if not pos.size:
            return np.empty(0, np.int64)
        return np.concatenate([rows[offs[p]:offs[p + 1]] for p in pos])

    def closure(self, affected: np.ndarray) -> np.ndarray:
        """One-level constraint closure of `affected` (sorted, unique):
        rows sharing a conflict or coloc id, dependency neighbours (either
        direction), replica siblings. One level suffices: the frozen base
        makes second-order interactions exact in the sub-problem."""
        affected = np.unique(affected)
        inside = affected[affected < self.S]
        out = [affected]
        if inside.size:
            out.append(self._rows_sharing(self._conf_inv,
                                          self.conflict[inside].ravel()))
            out.append(self._rows_sharing(self._coloc_inv,
                                          self.coloc[inside].ravel()))
            if self._dep.size:
                nbr = (self._dep[inside].any(axis=0)
                       | self._dep[:, inside].any(axis=1))
                out.append(np.nonzero(nbr)[0])
            for i in inside:
                base = (self.pt.replica_of[i]
                        if i < len(self.pt.replica_of or ()) else None)
                if base is not None and base in self._groups:
                    out.append(np.asarray(self._groups[base]))
        return np.unique(np.concatenate(out)).astype(np.int64)

    def frozen_occupancy(self, ids: np.ndarray, inv, mirror: np.ndarray,
                         in_sub: np.ndarray, N: int) -> np.ndarray:
        """(N, len(ids)) int32 occupancy of the given ids by frozen rows
        (carriers outside the closure) at their mirror nodes."""
        out = np.zeros((N, max(len(ids), 1)), dtype=np.int32)
        uniq, offs, rows = inv
        if not uniq.size:
            return out
        pos = np.searchsorted(uniq, ids)
        for g, p in enumerate(pos):
            if p >= uniq.size or uniq[p] != ids[g]:
                continue
            carriers = rows[offs[p]:offs[p + 1]]
            carriers = carriers[~in_sub[carriers]]
            if carriers.size:
                np.add.at(out, (mirror[carriers], g), 1)
        return out


@dataclass
class ActivePlan:
    """A localized sub-problem planned on the host, ready for one device
    dispatch. Every array is small (O(tier) rows or O(N) node state): the
    (S, ·) planes stay on the device and K5 gathers the closure rows."""
    rows: np.ndarray          # (tier,) i32, pad slots = padded S (dropped)
    n_sub: int                # real closure rows
    tier: int
    G_sub: int                # conflict-id count of the sub-problem
    Gc_sub: int               # coloc-id count (0 = none)
    sub_conflict: np.ndarray  # (tier, Kc) i32 compact ids, -1 pad
    sub_coloc: np.ndarray     # (tier, Cc) i32 compact ids, -1 pad
    load0: np.ndarray         # (N, R) f32 frozen load
    used0: np.ndarray         # (N, G_sub) i32 frozen conflict occupancy
    coloc0: np.ndarray        # (N, max(Gc_sub, 1)) i32 frozen coloc occ.
    topo0: np.ndarray         # (T,) i32 frozen topology counts
    affected: int = 0         # affected rows before the closure


def plan_active(index: ActiveIndex, pt, mirror: np.ndarray, padded_S: int,
                T: int, pending_rows: np.ndarray,
                cfg: Optional[SubsolveConfig] = None,
                G_full: int = 1 << 30, Gc_full: int = 1 << 30
                ) -> tuple[Optional[ActivePlan], str]:
    """The localized sub-problem for the churn since the last solve.
    Returns (plan, outcome); plan None means the full path runs, and
    `outcome` says why. `mirror` is the host copy of the padded resident
    assignment as of the last solve; `pending_rows` the rows deltas
    touched. Stranded rows are recomputed here from the post-delta
    tensors."""
    cfg = cfg or subsolve_config()
    S = pt.S
    prev = mirror[:S]
    elig = np.asarray(pt.eligible)
    stranded = np.nonzero(~(np.asarray(pt.node_valid)[prev]
                            & elig[np.arange(S), prev]))[0]
    affected = np.unique(np.concatenate(
        [np.asarray(pending_rows, dtype=np.int64), stranded]))
    affected = affected[affected < S]
    if not affected.size:
        return None, "fallback_small"
    rows = index.closure(affected)
    rows = rows[rows < S]
    k = int(rows.size)
    if k > max(cfg.frac * S, 1):
        return None, "fallback_closure"
    tier = subsolve_tier(k, minimum=cfg.min_tier, maximum=cfg.max_tier)
    if tier == 0:
        return None, "fallback_closure"
    if tier >= S:
        return None, "fallback_small"

    N = pt.N
    R = np.asarray(pt.demand).shape[1]
    in_sub = np.zeros(max(index.S, S), dtype=bool)
    in_sub[rows] = True

    # compact id spaces: only ids carried by closure rows exist in the
    # sub-problem; frozen carriers of those ids enter as base occupancy
    inside = rows[rows < index.S]
    conf_rows = (index.conflict[inside] if inside.size
                 else np.empty((0, index.conflict.shape[1]), np.int32))
    coloc_rows = (index.coloc[inside] if inside.size
                  else np.empty((0, index.coloc.shape[1]), np.int32))
    conf_ids = np.unique(conf_rows[conf_rows >= 0])
    coloc_ids = np.unique(coloc_rows[coloc_rows >= 0])
    # id-space sizes follow the tier and the staging's G/Gc, not the
    # closure's content; a closure denser in ids than that falls back
    G_sub = max(min(tier, G_full), 16)
    Gc_sub = 0 if Gc_full == 0 else max(min(tier // 4, Gc_full), 4)
    if len(conf_ids) > G_sub or len(coloc_ids) > Gc_sub:
        return None, "fallback_closure"

    Kc = width_bucket(index.conflict.shape[1], 4)
    Cc = width_bucket(index.coloc.shape[1], 4)
    sub_conflict = np.full((tier, Kc), -1, dtype=np.int32)
    sub_coloc = np.full((tier, Cc), -1, dtype=np.int32)
    if inside.size:
        remap = np.where(conf_rows >= 0,
                         np.searchsorted(conf_ids,
                                         np.where(conf_rows >= 0,
                                                  conf_rows, 0)), -1)
        at = np.nonzero(rows < index.S)[0]
        sub_conflict[at, :conf_rows.shape[1]] = remap
        if len(coloc_ids):
            cremap = np.where(coloc_rows >= 0,
                              np.searchsorted(coloc_ids,
                                              np.where(coloc_rows >= 0,
                                                       coloc_rows, 0)), -1)
            sub_coloc[at, :coloc_rows.shape[1]] = cremap

    # the frozen remainder at its mirror nodes: the capacity debit and the
    # exact cross-boundary conflict/coloc/skew accounting in one base state
    frozen = np.nonzero(~in_sub[:S])[0]
    load0 = np.zeros((N, R), dtype=np.float32)
    np.add.at(load0, prev[frozen],
              np.asarray(pt.demand, dtype=np.float32)[frozen])
    used0 = np.zeros((N, G_sub), dtype=np.int32)
    used0[:, : max(len(conf_ids), 1)] = index.frozen_occupancy(
        conf_ids, index._conf_inv, prev, in_sub, N) \
        if len(conf_ids) else 0
    coloc0 = np.zeros((N, max(Gc_sub, 1)), dtype=np.int32)
    if len(coloc_ids):
        coloc0[:, : len(coloc_ids)] = index.frozen_occupancy(
            coloc_ids, index._coloc_inv, prev, in_sub, N)
    topo0 = np.bincount(np.asarray(pt.node_topology)[prev[frozen]],
                        minlength=T).astype(np.int32)

    padded_rows = np.full(tier, padded_S, dtype=np.int32)
    padded_rows[:k] = rows            # ascending: the prologue's order
    plan = ActivePlan(
        rows=padded_rows, n_sub=k, tier=tier, G_sub=G_sub, Gc_sub=Gc_sub,
        sub_conflict=sub_conflict, sub_coloc=sub_coloc, load0=load0,
        used0=used0, coloc0=coloc0, topo0=topo0, affected=int(affected.size))
    return plan, "planned"


def stage_subsolve(resident, plan: ActivePlan) -> tuple:
    """Upload a plan's small arrays through the resident state's counted
    `upload` (before the sub-solve's dispatch range opens). Returns (rows,
    sub_conflict, sub_coloc, load0, used0, coloc0, topo0) on the device."""
    up = resident.upload
    return (up(plan.rows, torch.int32), up(plan.sub_conflict, torch.int32),
            up(plan.sub_coloc, torch.int32), up(plan.load0, torch.float32),
            up(plan.used0, torch.int32), up(plan.coloc0, torch.int32),
            up(plan.topo0, torch.int32))


# -- K5: gather and commit --------------------------------------------------

def _park(node_valid: torch.Tensor) -> torch.Tensor:
    """argmax(node_valid) as a 0-dim int32 tensor: the first valid node, 0
    when none is valid."""
    return torch.argmax(node_valid.to(torch.int32)).to(torch.int32)


def k5_gather_plain(prob: TorchProblem, assignment: torch.Tensor,
                    rows: torch.Tensor, n_sub: int):
    """Plain PyTorch version of K5's gather; see :func:`k5_gather`."""
    tier = rows.shape[0]
    dev = rows.device
    rows_g = torch.clamp(rows.long(), max=prob.S - 1)
    real = (torch.arange(tier, device=dev) < n_sub)[:, None]
    demand = torch.where(real, prob.demand[rows_g], 0.0)
    fill = True if prob.eligible.dtype == torch.bool else -1
    eligible = torch.where(real, prob.eligible[rows_g],
                           torch.full((), fill, dtype=prob.eligible.dtype,
                                      device=dev))
    pref = (None if prob.preferred is None
            else torch.where(real, prob.preferred[rows_g], 0.0))
    seed = torch.where(real[:, 0], assignment[rows_g],
                       _park(prob.node_valid)).to(torch.int32)
    return demand, eligible, pref, seed


def k5_gather(prob: TorchProblem, assignment: torch.Tensor,
              rows: torch.Tensor, n_sub: int):
    """K5 gather: the mini problem's planes from the resident ones. Slot j
    < n_sub is closure row min(rows[j], S-1): its demand (tier, R) f32,
    eligibility row (packed words or dense bools), preference row (when
    the plane exists) and its current node as the seed. Pad slots are
    inert phantoms: demand 0, all eligible, preference 0, seeded on the
    first valid node. Returns (demand, eligible, preferred or None, seed
    (tier,) i32); the seed is also the sub-problem's sticky_prev."""
    if rows.device.type == "cpu":
        return k5_gather_plain(prob, assignment, rows, n_sub)
    tier = rows.shape[0]
    if (rows.dtype != torch.int32 or assignment.dtype != torch.int32
            or assignment.shape != (prob.S,) or rows.dim() != 1
            or prob.demand.shape[1] != 3 or not 0 <= n_sub <= tier):
        raise ValueError("k5_gather: rows/assignment must be int32 (tier,) "
                         "/ (S,) with R=3 and 0 <= n_sub <= tier")
    dev = rows.device
    W = prob.eligible.shape[1]
    demand = torch.empty((tier, 3), dtype=torch.float32, device=dev)
    eligible = torch.empty((tier, W), dtype=prob.eligible.dtype, device=dev)
    pref = (None if prob.preferred is None else
            torch.empty((tier, prob.N), dtype=torch.float32, device=dev))
    seed = torch.empty(tier, dtype=torch.int32, device=dev)
    tensors = [rows, assignment, prob.demand, prob.eligible, prob.node_valid]
    if pref is not None:
        tensors.append(prob.preferred)
    _ext.check_inputs("k5_gather", *tensors)
    _ext.launch("k5_subsolve", "ff_k5_gather", dev,
                prob.S, prob.N, W, int(prob.eligible_packed), tier, n_sub,
                rows, assignment, prob.demand, prob.eligible,
                prob.preferred, prob.node_valid,
                demand, eligible, pref, seed)
    return demand, eligible, pref, seed


def k5_commit_plain(best_assign: torch.Tensor, best_viol: torch.Tensor,
                    best_soft: torch.Tensor, rows: torch.Tensor,
                    assignment: torch.Tensor):
    """Plain PyTorch version of K5's commit; see :func:`k5_commit`."""
    best = torch.argmin(torch.where(best_viol == best_viol.min(), best_soft,
                                    torch.full_like(best_soft, float("inf"))))
    keep = rows.long() < assignment.shape[0]
    out = assignment.clone()
    out.index_copy_(0, rows.long()[keep], best_assign[best][keep])
    return out, best.to(torch.int32).reshape(1)


def k5_commit(best_assign: torch.Tensor, best_viol: torch.Tensor,
              best_soft: torch.Tensor, rows: torch.Tensor,
              assignment: torch.Tensor):
    """K5 commit: pick the winning chain of the mini anneal (least
    violations, then least soft, the first chain on ties) and scatter its
    rows into a FRESH copy of `assignment` (S,), dropping pad slots
    (rows[j] >= S). `assignment` itself is never written: a gate-rejected
    sub-solve re-runs the full path from it. Returns (new assignment (S,)
    i32, winning chain (1,) i32)."""
    if rows.device.type == "cpu":
        return k5_commit_plain(best_assign, best_viol, best_soft, rows,
                               assignment)
    C, tier = best_assign.shape
    if (best_assign.dtype != torch.int32 or rows.dtype != torch.int32
            or assignment.dtype != torch.int32
            or best_viol.dtype != torch.float32
            or best_soft.dtype != torch.float32
            or rows.shape != (tier,) or best_viol.shape != (C,)
            or best_soft.shape != (C,) or assignment.dim() != 1):
        raise ValueError("k5_commit: expects (C, tier) i32, (C,) f32, (C,) "
                         "f32, (tier,) i32 and (S,) i32")
    dev = rows.device
    out = torch.empty_like(assignment)
    best = torch.empty(1, dtype=torch.int32, device=dev)
    _ext.check_inputs("k5_commit", best_assign, best_viol, best_soft, rows,
                      assignment)
    _ext.launch("k5_subsolve", "ff_k5_commit", dev,
                C, tier, assignment.shape[0], best_assign, best_viol,
                best_soft, rows, assignment, out, best)
    return out, best


# -- the device body ---------------------------------------------------------

SUB_MAX_STEPS = 16   # mini-anneal sweep budget: a closure that has not
# converged in 16 sweeps goes back to the full path


def subsolve(prob: TorchProblem, assignment: torch.Tensor, staged: tuple,
             n_sub: int, Gc_sub: int, gen: torch.Generator, t0: float,
             t1: float, migration_weight: float, *, chains: int, steps: int,
             block: int, proposals_per_step: int, prerepair_moves: int,
             trace_blocks: int = 0):
    """The localized solve on the device: K5 gather, K3 onto the frozen
    base, K2, the adaptive anneal (K1), K5 commit, and K3's exact
    full-problem stats of the result as the gate. Returns (new assignment
    (S,) i32, stats dict, soft 0-dim, sweeps_run, accepted 0-dim,
    telemetry)."""
    rows, sub_conflict, sub_coloc, load0, used0, coloc0, topo0 = staged
    demand, eligible, pref, seed = k5_gather(prob, assignment, rows, n_sub)
    # warm stickiness as on the full path: staying on the previous
    # still-eligible node earns migration_weight
    sub = TorchProblem(
        demand=demand, capacity=prob.capacity, conflict_ids=sub_conflict,
        coloc_ids=sub_coloc, eligible=eligible, node_valid=prob.node_valid,
        node_topology=prob.node_topology, S=rows.shape[0], N=prob.N,
        G=used0.shape[1], Gc=Gc_sub, T=prob.T, strategy=prob.strategy,
        max_skew=prob.max_skew, preferred=pref, n_real=n_sub,
        sticky_prev=seed, sticky_w=float(migration_weight))
    st0 = chain_states_from_assignment(sub, seed,
                                       base=(load0, used0, coloc0, topo0))
    st0, prerepair_applied = prerepair_state_counted(sub, st0,
                                                     prerepair_moves)
    inits = st0.assignment.expand(chains, -1)
    (best_c, viol_c, soft_c, sweeps_run, accepted_c,
     telem) = anneal_adaptive_states(
        sub, inits, gen, max_steps=steps, block=block, t0=t0, t1=t1,
        proposals_per_step=proposals_per_step,
        init_states=st0.expand(chains), exit_on_feasible_init=True,
        trace_blocks=trace_blocks)
    new_assignment, _best = k5_commit(best_c, viol_c, soft_c, rows,
                                      assignment)
    # the gate: whatever the mini anneal believed, THIS decides
    stats, soft = exact_stats_and_soft(prob, new_assignment)
    telem = dict(telem, prerepair_moves=prerepair_applied[0])
    return (new_assignment, stats, soft, sweeps_run, accepted_c.sum(),
            telem)


def subsolve_dispatch(prob: TorchProblem, assignment: torch.Tensor,
                      staged: tuple, plan: ActivePlan, gen: torch.Generator,
                      t0: float, t1: float, migration_weight: float, *,
                      chains: int, steps: int, block: int,
                      proposals_per_step: int, trace_blocks: int = 0):
    """Run :func:`subsolve` for `plan` with the reference's budgets: at
    most SUB_MAX_STEPS sweeps, max(16, min(tier, 256)) pre-repair moves."""
    return subsolve(prob, assignment, staged, plan.n_sub, plan.Gc_sub, gen,
                    t0, t1, migration_weight, chains=chains,
                    steps=min(steps, SUB_MAX_STEPS), block=block,
                    proposals_per_step=proposals_per_step,
                    prerepair_moves=max(16, min(plan.tier, 256)),
                    trace_blocks=trace_blocks)
