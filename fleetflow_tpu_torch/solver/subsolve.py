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
                padded onto a mini tier (256/512/.../4096 rows), and the
                sorted conflict and coloc ids the closure carries (the
                sub-problem's compact id spaces): O(tier) ints, uploaded
                as one buffer
  subsolve      on the device: K5 builds the mini problem from the
                resident planes (the closure rows' planes and seed, their
                ids remapped, and the FROZEN remainder's load,
                conflict/coloc occupancy and topology counts as the base
                state), K3 rebuilds the mini state onto that base, the
                fused pre-repair (K2) and at most SUB_MAX_STEPS sweeps of
                the adaptive anneal (K1) run over the mini tier, K5 picks
                the winning chain and writes its rows into a FRESH copy of
                the resident assignment, then K3 takes the exact
                full-problem stats of the result: the gate that decides
                whether the localized result commits

A gate-rejected sub-solve is discarded and the full path re-runs from the
untouched resident assignment, which is why the commit never writes into
it. Closures above FLEET_SUBSOLVE_FRAC of the real rows (or past the tier
ladder) fall back to the full path before any device work.

Knobs, as in the reference: FLEET_SUBSOLVE=0 disables; FLEET_SUBSOLVE_FRAC
(default 0.25); FLEET_SUBSOLVE_MIN / FLEET_SUBSOLVE_MAX (default 256 /
4096) bound the mini tier ladder.

Kernel K5 lives here, two entry points of ``csrc/k5_subsolve.cu``, each
one launch: :func:`k5_stage` builds the whole mini problem, frozen base
included, from the resident planes and the staged plan; :func:`k5_commit`
picks the chain and writes the new assignment. On a CPU tensor each runs
its plain PyTorch version (:func:`k5_stage_plain`, :func:`k5_commit_plain`),
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _ext
from ..obs.metrics import MS_BUCKETS, REGISTRY
from .anneal import (anneal_adaptive_states, chain_states_from_assignment,
                     prerepair_state_counted)
from .buckets import subsolve_tier, width_bucket
from .kernels import exact_stats_and_soft
from .problem import TorchProblem, unify_conflict_ids

__all__ = ["SubsolveConfig", "subsolve_config", "ActiveIndex", "ActivePlan",
           "closure_ids", "plan_active", "stage_subsolve", "subsolve",
           "subsolve_dispatch", "SubStage", "k5_stage", "k5_stage_plain",
           "k5_commit", "k5_commit_plain", "SUB_OUTCOMES", "SUB_MAX_STEPS",
           "record_outcome", "record_subsolve_ms"]

# the outcome vocabulary: localized = the mini anneal's result passed the
# exact full-problem gate; fallback_closure = the closure exceeded the size
# cap; fallback_small = nothing to localize or the problem is too small;
# fallback_infeasible = the gate rejected the result and the full path ran
SUB_OUTCOMES = ("localized", "fallback_closure", "fallback_small",
                "fallback_infeasible")

_M_SUB = REGISTRY.counter(
    "fleet_solver_subsolve_total",
    "Active-set sub-solve attempts by outcome: localized = mini anneal "
    "accepted by the exact full-problem gate, fallback_closure = closure "
    "exceeded the size cap, fallback_small = the problem is too small for "
    "a sub-problem to win, fallback_infeasible = the sub-solve landed "
    "infeasible and the full fused path re-ran",
    labels=("outcome",))
_M_SUB_ROWS = REGISTRY.gauge(
    "fleet_solver_subsolve_rows",
    "Closure size (real rows) of the most recent active-set sub-solve")
_M_SUB_TIER = REGISTRY.gauge(
    "fleet_solver_subsolve_tier",
    "Padded mini-tier of the most recent active-set sub-solve")
_M_SUB_MS = REGISTRY.histogram(
    "fleet_solver_subsolve_ms",
    "Wall milliseconds per localized sub-solve dispatch "
    "(staging + mini anneal + scatter + exact full-problem gate)",
    buckets=MS_BUCKETS)


def record_outcome(outcome: str) -> None:
    _M_SUB.inc(outcome=outcome)


def record_subsolve_ms(ms: float) -> None:
    _M_SUB_MS.observe(ms)


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


def closure_ids(conflict: np.ndarray, coloc: np.ndarray, rows: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """The sorted unique conflict and coloc ids the closure `rows` carry
    (rows past the id tables, arrivals, carry none): the compact id spaces
    of the sub-problem, compact id g standing for the g-th of them."""
    inside = rows[rows < conflict.shape[0]]
    conf_rows = conflict[inside]
    coloc_rows = coloc[inside]
    return (np.unique(conf_rows[conf_rows >= 0]),
            np.unique(coloc_rows[coloc_rows >= 0]))


@dataclass
class ActivePlan:
    """A localized sub-problem planned on the host, ready for one device
    dispatch: the closure rows and the two compact id lists, O(tier) ints.
    K5 builds the mini problem, its frozen base included, from the
    resident planes on the device."""
    rows: np.ndarray          # (tier,) i32 ascending, pad slots = padded S
    n_sub: int                # real closure rows
    tier: int
    G_sub: int                # conflict-id count of the sub-problem
    Gc_sub: int               # coloc-id count (0 = none)
    conf_ids: np.ndarray      # (<= G_sub,) i32 sorted staging conflict ids
    coloc_ids: np.ndarray     # (<= Gc_sub,) i32 sorted staging coloc ids
    n_real: int               # real rows of the staging (the frozen rows
    # are those below it outside the closure)
    Kc: int                   # sub_conflict columns
    Cc: int                   # sub_coloc columns
    affected: int = 0         # affected rows before the closure

    def packed(self) -> np.ndarray:
        """rows | conf_ids | coloc_ids as one int32 array: what
        :func:`stage_subsolve` uploads and K5 reads."""
        return np.concatenate([self.rows, self.conf_ids,
                               self.coloc_ids]).astype(np.int32)


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
    tensors. `T` is the staging's domain count, kept for the reference's
    signature: K5 sizes the base from the staging itself."""
    del T
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

    # compact id spaces: only ids carried by closure rows exist in the
    # sub-problem; frozen carriers of those ids enter as base occupancy
    conf_ids, coloc_ids = closure_ids(index.conflict, index.coloc, rows)
    # id-space sizes follow the tier and the staging's G/Gc, not the
    # closure's content; a closure denser in ids than that falls back
    G_sub = max(min(tier, G_full), 16)
    Gc_sub = 0 if Gc_full == 0 else max(min(tier // 4, Gc_full), 4)
    if len(conf_ids) > G_sub or len(coloc_ids) > Gc_sub:
        return None, "fallback_closure"

    padded_rows = np.full(tier, padded_S, dtype=np.int32)
    padded_rows[:k] = rows            # ascending: the prologue's order
    plan = ActivePlan(
        rows=padded_rows, n_sub=k, tier=tier, G_sub=G_sub, Gc_sub=Gc_sub,
        conf_ids=conf_ids.astype(np.int32),
        coloc_ids=coloc_ids.astype(np.int32), n_real=S,
        Kc=width_bucket(index.conflict.shape[1], 4),
        Cc=width_bucket(index.coloc.shape[1], 4),
        affected=int(affected.size))
    return plan, "planned"


def stage_subsolve(resident, plan: ActivePlan) -> torch.Tensor:
    """Upload a plan through the resident state's counted `upload` (before
    the sub-solve's dispatch range opens): one int32 copy of its rows and
    id lists, O(tier + G_sub + Gc_sub) ints."""
    return resident.upload(plan.packed(), torch.int32)


# -- K5: stage and commit ---------------------------------------------------

class SubStage(NamedTuple):
    """K5 stage's outputs: the mini problem's slot planes and its frozen
    base."""
    demand: torch.Tensor          # (tier, 3) f32
    eligible: torch.Tensor        # (tier, W) packed i32 or (tier, N) bool
    preferred: Optional[torch.Tensor]   # (tier, N) f32 or None
    seed: torch.Tensor            # (tier,) i32, also sticky_prev
    sub_conflict: torch.Tensor    # (tier, Kc) i32 compact ids, -1 pad
    sub_coloc: torch.Tensor       # (tier, Cc) i32 compact ids, -1 pad
    load0: torch.Tensor           # (N, 3) f32 frozen load
    used0: torch.Tensor           # (N, G_sub) i32 frozen conflict occupancy
    coloc0: torch.Tensor          # (N, max(Gc_sub, 1)) i32
    topo0: torch.Tensor           # (T,) i32 frozen domain counts


def _park(node_valid: torch.Tensor) -> torch.Tensor:
    """argmax(node_valid) as a 0-dim int32 tensor: the first valid node, 0
    when none is valid."""
    return torch.argmax(node_valid.to(torch.int32)).to(torch.int32)


def _split(staged: torch.Tensor, plan: ActivePlan):
    n_conf, tier = len(plan.conf_ids), plan.tier
    return (staged[:tier], staged[tier:tier + n_conf],
            staged[tier + n_conf:tier + n_conf + len(plan.coloc_ids)])


def _remap_plain(ids: torch.Tensor, rows_g: torch.Tensor,
                 real: torch.Tensor, lst: torch.Tensor,
                 width: int) -> torch.Tensor:
    """The slots' ids as positions in the sorted list `lst`, -1 where
    absent or padded, in `width` columns."""
    w = min(ids.shape[1], width)
    g = ids[rows_g][:, :w]
    out = torch.full((rows_g.shape[0], width), -1, dtype=torch.int32,
                     device=ids.device)
    if lst.numel():
        pos = torch.searchsorted(lst, g.clamp(min=0).contiguous())
        out[:, :w] = torch.where((g >= 0) & real, pos.to(torch.int32), -1)
    return out


def _count_plain(ids: torch.Tensor, at: torch.Tensor, lst: torch.Tensor,
                 N: int, width: int) -> torch.Tensor:
    """(N, width) counts of the frozen rows' ids found in `lst`, each at
    its row's node `at`."""
    if not lst.numel() or not ids.numel():
        return torch.zeros((N, width), dtype=torch.int32, device=ids.device)
    pos = torch.searchsorted(lst, ids.clamp(min=0).contiguous())
    pos = pos.clamp(max=lst.numel() - 1)
    found = (ids >= 0) & (lst[pos] == ids)
    flat = (at[:, None] * width + pos)[found]
    return torch.bincount(flat, minlength=N * width).reshape(
        N, width).to(torch.int32)


def k5_stage_plain(prob: TorchProblem, assignment: torch.Tensor,
                   staged: torch.Tensor, plan: ActivePlan) -> SubStage:
    """Plain PyTorch version of K5's stage; see :func:`k5_stage`. The
    frozen load adds each node's rows one at a time in row order
    (index_add_ on the CPU), as the reference's np.add.at does."""
    rows, conf, coloc = _split(staged, plan)
    tier, n_sub, dev = plan.tier, plan.n_sub, staged.device
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
    sub_conflict = _remap_plain(prob.conflict_ids, rows_g, real, conf,
                                plan.Kc)
    sub_coloc = _remap_plain(prob.coloc_ids, rows_g, real, coloc, plan.Cc)

    in_sub = torch.zeros(prob.S, dtype=torch.bool, device=dev)
    closure = rows[:n_sub].long()
    in_sub[closure[closure < prob.S]] = True
    frozen = torch.nonzero(~in_sub[:plan.n_real]).reshape(-1)
    at = assignment[frozen].long()
    N = prob.N
    load0 = torch.zeros((N, 3), dtype=torch.float32, device=dev).index_add_(
        0, at, prob.demand[frozen])
    used0 = _count_plain(prob.conflict_ids[frozen], at, conf, N, plan.G_sub)
    coloc0 = _count_plain(prob.coloc_ids[frozen], at, coloc, N,
                          max(plan.Gc_sub, 1))
    topo0 = torch.bincount(prob.node_topology[at].long(),
                           minlength=prob.T).to(torch.int32)
    return SubStage(demand, eligible, pref, seed, sub_conflict, sub_coloc,
                    load0, used0, coloc0, topo0)


class K5StageArgs(ctypes.Structure):
    """``K5Stage`` of ``csrc/k5_subsolve.cu``: one stage's sizes, planes
    and outputs (device pointers; 0 for an absent preference plane)."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "S", "N", "W", "packed", "T", "K", "C", "tier", "n_sub", "n_real",
        "n_conf", "n_coloc", "G_sub", "Gc1", "Kc", "Cc")] + [
        (f, ctypes.c_void_p) for f in (
            "plan", "assignment", "demand", "elig", "pref", "valid", "cids",
            "colids", "ntopo", "demand_out", "elig_out", "pref_out",
            "seed_out", "sub_conflict", "sub_coloc", "load0", "used0",
            "coloc0", "topo0")]


_BOUND: dict[int, ctypes.CDLL] = {}


def _k5(device: torch.device) -> ctypes.CDLL:
    """K5's library with its entry points bound (argument types set, the
    stage's shared memory allowed) once a process and card."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    lib = _BOUND.get(idx)
    if lib is None:
        lib = _ext.library("k5_subsolve")
        lib.ff_k5_stage_size.restype = ctypes.c_longlong
        if lib.ff_k5_stage_size() != ctypes.sizeof(K5StageArgs):
            raise RuntimeError("k5_subsolve: the C argument struct does not "
                               "match K5StageArgs")
        lib.ff_k5_stage.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ff_k5_commit.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
        with torch.cuda.device(device):
            _ext.raise_error("k5_subsolve", lib.ff_k5_bind())
        _BOUND[idx] = lib
    return lib


def _views(buf: torch.Tensor, shapes) -> list:
    """Contiguous views of `buf` in `shapes`, each starting on a 256-byte
    boundary (as its own allocation would); as_strided makes each in one
    call, a third of the host time of a slice and a view."""
    out, off = [], 0
    for shape in shapes:
        stride = (shape[1], 1) if len(shape) == 2 else (1,)
        out.append(buf.as_strided(shape, stride, off))
        off += -(-math.prod(shape) // 64) * 64
    return out


def _extent(shapes) -> int:
    return sum(-(-math.prod(s) // 64) * 64 for s in shapes)


def k5_stage(prob: TorchProblem, assignment: torch.Tensor,
             staged: torch.Tensor, plan: ActivePlan) -> SubStage:
    """K5 stage: the whole mini problem from the resident planes and the
    staged plan, in one launch. Slot j < n_sub is closure row
    min(rows[j], S-1): its demand, eligibility row (packed words or dense
    bools), preference row (when the plane exists), its current node as
    the seed (also the sub-problem's sticky_prev) and its conflict and
    coloc ids as positions in the plan's id lists (-1 where absent). Pad
    slots are inert phantoms: demand 0, all eligible, preference 0, ids
    -1, seeded on the first valid node. The frozen base is every real row
    (below plan.n_real) outside the closure at its node in `assignment`:
    its load (added in row order), its id counts and its domain counts.
    `staged` is :func:`stage_subsolve`'s buffer."""
    if staged.device.type == "cpu":
        return k5_stage_plain(prob, assignment, staged, plan)
    tier, N = plan.tier, prob.N
    n_conf, n_coloc = len(plan.conf_ids), len(plan.coloc_ids)
    if (staged.dtype != torch.int32 or assignment.dtype != torch.int32
            or staged.shape != (tier + n_conf + n_coloc,)
            or assignment.shape != (prob.S,) or prob.demand.shape[1] != 3
            or not 0 <= plan.n_sub <= tier or plan.n_real > prob.S
            or n_conf > plan.G_sub or n_coloc > max(plan.Gc_sub, 1)):
        raise ValueError("k5_stage: expects the plan's int32 buffer, an "
                         "int32 (S,) assignment, R=3, n_sub <= tier and "
                         "id lists within G_sub / Gc_sub")
    _ext.check_inputs("k5_stage", staged, assignment, prob.demand,
                      prob.eligible, prob.preferred, prob.node_valid,
                      prob.conflict_ids, prob.coloc_ids, prob.node_topology)
    dev = staged.device
    lib = _k5(dev)
    W = prob.eligible.shape[1]
    Gc1 = max(plan.Gc_sub, 1)
    f_shapes = [(tier, 3), (N, 3)] + (
        [] if prob.preferred is None else [(tier, N)])
    i_shapes = [(tier,), (tier, plan.Kc), (tier, plan.Cc), (N, plan.G_sub),
                (N, Gc1), (prob.T,)] + (
        [(tier, W)] if prob.eligible_packed else [])
    fbuf = torch.empty(_extent(f_shapes), dtype=torch.float32, device=dev)
    ibuf = torch.empty(_extent(i_shapes), dtype=torch.int32, device=dev)
    f = _views(fbuf, f_shapes)
    i = _views(ibuf, i_shapes)
    demand, load0 = f[0], f[1]
    pref = f[2] if prob.preferred is not None else None
    seed, sub_conflict, sub_coloc, used0, coloc0, topo0 = i[:6]
    eligible = (i[6] if prob.eligible_packed else torch.empty(
        (tier, W), dtype=torch.bool, device=dev))
    args = K5StageArgs(
        prob.S, N, W, int(prob.eligible_packed), prob.T,
        prob.conflict_ids.shape[1], prob.coloc_ids.shape[1], tier,
        plan.n_sub, plan.n_real, n_conf, n_coloc, plan.G_sub, Gc1, plan.Kc,
        plan.Cc, staged.data_ptr(), assignment.data_ptr(),
        prob.demand.data_ptr(), prob.eligible.data_ptr(),
        _ptr(prob.preferred), prob.node_valid.data_ptr(),
        prob.conflict_ids.data_ptr(), prob.coloc_ids.data_ptr(),
        prob.node_topology.data_ptr(), demand.data_ptr(),
        eligible.data_ptr(), _ptr(pref), seed.data_ptr(),
        sub_conflict.data_ptr(), sub_coloc.data_ptr(), load0.data_ptr(),
        used0.data_ptr(), coloc0.data_ptr(), topo0.data_ptr())
    _ext.raise_on("k5_subsolve", lib.ff_k5_stage(
        ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream))
    return SubStage(demand, eligible, pref, seed, sub_conflict, sub_coloc,
                    load0, used0, coloc0, topo0)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


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
    violations, then least soft, the first chain on ties) and write a
    FRESH copy of `assignment` (S,) with the winner's slot values at the
    closure rows (`rows` ascending and unique, as a plan's are; pad slots,
    rows[j] >= S, are dropped), in one launch. `assignment` itself is
    never written: a gate-rejected sub-solve re-runs the full path from
    it. Returns (new assignment (S,) i32, winning chain (1,) i32)."""
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
    _ext.check_inputs("k5_commit", best_assign, best_viol, best_soft, rows,
                      assignment)
    dev = rows.device
    lib = _k5(dev)
    S = assignment.shape[0]
    buf = torch.empty(S + 1, dtype=torch.int32, device=dev)
    _ext.raise_on("k5_subsolve", lib.ff_k5_commit(
        C, tier, S, best_assign.data_ptr(), best_viol.data_ptr(),
        best_soft.data_ptr(), rows.data_ptr(), assignment.data_ptr(),
        buf.data_ptr(), buf.data_ptr() + 4 * S,
        torch.cuda.current_stream(dev).cuda_stream))
    return buf.as_strided((S,), (1,), 0), buf.as_strided((1,), (1,), S)


# -- the device body ---------------------------------------------------------

SUB_MAX_STEPS = 16   # mini-anneal sweep budget: a closure that has not
# converged in 16 sweeps goes back to the full path


def subsolve(prob: TorchProblem, assignment: torch.Tensor,
             staged: torch.Tensor, plan: ActivePlan, gen: torch.Generator,
             t0: float, t1: float, migration_weight: float, *, chains: int,
             steps: int, block: int, proposals_per_step: int,
             prerepair_moves: int, trace_blocks: int = 0):
    """The localized solve on the device: K5 stage, K3 onto the frozen
    base, K2, the adaptive anneal (K1), K5 commit, and K3's exact
    full-problem stats of the result as the gate. Returns (new assignment
    (S,) i32, stats dict, soft 0-dim, sweeps_run, accepted 0-dim,
    telemetry)."""
    st = k5_stage(prob, assignment, staged, plan)
    # warm stickiness as on the full path: staying on the previous
    # still-eligible node earns migration_weight
    sub = TorchProblem(
        demand=st.demand, capacity=prob.capacity,
        conflict_ids=st.sub_conflict, coloc_ids=st.sub_coloc,
        eligible=st.eligible, node_valid=prob.node_valid,
        node_topology=prob.node_topology, S=plan.tier, N=prob.N,
        G=plan.G_sub, Gc=plan.Gc_sub, T=prob.T, strategy=prob.strategy,
        max_skew=prob.max_skew, preferred=st.preferred, n_real=plan.n_sub,
        sticky_prev=st.seed, sticky_w=float(migration_weight))
    st0 = chain_states_from_assignment(
        sub, st.seed, base=(st.load0, st.used0, st.coloc0, st.topo0))
    st0, prerepair_applied = prerepair_state_counted(sub, st0,
                                                     prerepair_moves)
    inits = st0.assignment.expand(chains, -1)
    (best_c, viol_c, soft_c, sweeps_run, accepted_c,
     telem) = anneal_adaptive_states(
        sub, inits, gen, max_steps=steps, block=block, t0=t0, t1=t1,
        proposals_per_step=proposals_per_step,
        init_states=st0.expand(chains), exit_on_feasible_init=True,
        trace_blocks=trace_blocks)
    new_assignment, _best = k5_commit(best_c, viol_c, soft_c,
                                      staged[:plan.tier], assignment)
    # the gate: whatever the mini anneal believed, THIS decides
    stats, soft = exact_stats_and_soft(prob, new_assignment)
    telem = dict(telem, prerepair_moves=prerepair_applied[0])
    return (new_assignment, stats, soft, sweeps_run, accepted_c.sum(),
            telem)


def subsolve_dispatch(prob: TorchProblem, assignment: torch.Tensor,
                      staged: torch.Tensor, plan: ActivePlan,
                      gen: torch.Generator, t0: float, t1: float,
                      migration_weight: float, *, chains: int, steps: int,
                      block: int, proposals_per_step: int,
                      trace_blocks: int = 0):
    """Run :func:`subsolve` for `plan` with the reference's budgets: at
    most SUB_MAX_STEPS sweeps, max(16, min(tier, 256)) pre-repair moves."""
    _M_SUB_ROWS.set(plan.n_sub)
    _M_SUB_TIER.set(plan.tier)
    return subsolve(prob, assignment, staged, plan, gen, t0, t1,
                    migration_weight, chains=chains,
                    steps=min(steps, SUB_MAX_STEPS), block=block,
                    proposals_per_step=proposals_per_step,
                    prerepair_moves=max(16, min(plan.tier, 256)),
                    trace_blocks=trace_blocks)
