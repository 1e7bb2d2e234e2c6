"""Launch-contract registry (port of ``solver/contracts.py``): the solver's
hot dispatches, with the in-place and keep promises each one must hold.

The perf contracts of the port live or die on six dispatches:

  resident.merge    the churn merge (solver/resident.merge_delta) — churn
                    folds into the resident planes in place, no second
                    (S, N) copy
  refine.warm       the full path (api._refine) in its warm resident
                    configuration — the steady-state dispatch (K1-K3)
  mux.anneal        the tenant multiplexer's lane path (api._refine_lanes
                    over multiplex.stack_problems; K1-K3 with lanes)
  subsolve.localized  the churn-localized sub-solve
                    (subsolve.subsolve_dispatch; K5 and K1-K3) — the
                    original assignment must outlive a gate-rejected
                    attempt
  sharded.merge     the merge on the sharded layout (sharded.merge_sharded,
                    which is merge_delta: a shard is a view of its planes)
  sharded.anneal    the pod path's anneal (sharded.anneal_sharded; K7 and
                    K3) on a one-card mesh of 1x8 positions

Each :class:`KernelContract` names the dispatch, anchors it in source
(module + lexical qualname, resolved by analysis/jitspec's AST walk: the
dispatch's parameter surface is the counterpart of the reference's static
arguments), and builds cases through the port's own staging
(ResidentProblem.merge_inputs, ShardedResident, multiplex.stack_problems,
plan_active/stage_subsolve), as the reference builds through its
production staging. The auditor (analysis/auditor.py) runs each case once
on a device and reads the contract off the run:

  must_write_in_place   the reference's ``must_alias``: tensors the
                        dispatch must write where they lie (storage kept,
                        ``_version`` moved); every other tensor it is
                        handed keeps its storage
  must_keep             the reference's "donation-free by design" promise:
                        inputs that must come back bit-equal, with their
                        storage and ``_version``
  no_upload             the reference runs the dispatch under the disallow
                        transfer guard: on the card, a host-to-device copy
                        inside its profiler range is a violation

No contract needs more than one device (a mesh of this port names one
card), so the reference's ``needs_devices`` has no counterpart and every
contract is audited on every run.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

__all__ = ["KernelCase", "KernelContract", "AuditScale", "audit_scale",
           "hot_path_kernels", "problem_static_fields", "AUDIT_TIERS"]

# representative (S, N) instances: one inside the first bucket tier (64)
# and one in the next (80), the reference's pair
AUDIT_TIERS: tuple[tuple[int, int], ...] = ((60, 12), (73, 12))
MUX_LANES = 2            # lanes stacked at each audit tier (the reference's K)
AUDIT_STEPS = 16         # the sweep budget of every audited anneal
# the audit tiers' generator (the reference's `_synthetic`)
_SYN = dict(seed=0, port_fraction=0.3, volume_fraction=0.2)
# full width: the headline fleet (10,000 x 1,000, staged at 10,848 rows),
# the multiplexer's 8 lanes of 2,000 x 200 and the sharded fleet
HEADLINE = (10_000, 1_000, dict(seed=0, n_tenants=8, port_fraction=0.2,
                                volume_fraction=0.1))
MUX_FULL = (2_000, 200, 8)
SHARDED_FULL = (9_997, 1_000, HEADLINE[2])
SHARDED_POSITIONS = 8    # the one-card mesh of 1x8 positions
CHURN_PCT = 5            # nodes down (%) before a warm dispatch


@dataclass(frozen=True)
class AuditScale:
    """The fleets one audit stages its cases at: (S, N, generator kwargs)
    per tier of the single-device contracts and of the sharded ones, and
    (S, N, lanes) per tier of the multiplexer (lane i: the mux generator
    with seed i). `fleet(S, N, kwargs)` makes a fleet:
    ``synthetic_problem(S, N, **kwargs)``, or the same fleet a caller
    already made."""
    name: str
    single: tuple
    mux: tuple
    sharded: tuple
    fleet: Callable = None


def audit_scale(name: str = "tiers", fleet: Callable = None) -> AuditScale:
    """``tiers``: AUDIT_TIERS, the pinned golden's cases. ``full``: one
    case per contract at full width. `fleet` (default: the cached
    generator) must return ``synthetic_problem(S, N, **kwargs)``."""
    fleet = fleet or _synthetic
    if name == "tiers":
        syn = tuple((S, N, _SYN) for S, N in AUDIT_TIERS)
        return AuditScale("tiers", syn,
                          tuple((S, N, MUX_LANES) for S, N in AUDIT_TIERS),
                          syn, fleet)
    if name == "full":
        return AuditScale("full", (HEADLINE,), (MUX_FULL,), (SHARDED_FULL,),
                          fleet)
    raise ValueError(f"unknown audit scale {name!r}")


@dataclass
class KernelCase:
    """One runnable instance of a dispatch at a concrete tier."""
    tier: str                       # "<padded_S>x<N>" label
    fn: Any                         # the dispatch
    args: tuple                     # positional args (device-staged)
    kwargs: dict                    # keyword args, exactly as dispatched
    arg_names: tuple                # names for the positional args
    # (generator, state) of each generator handed in, as the auditor's
    # first run found them: its traced run replays the same draws
    draws: list = dataclasses.field(default_factory=list)


@dataclass
class KernelContract:
    name: str                       # registry key, e.g. "resident.merge"
    module: str                     # dotted module holding the dispatch
    qualname: str                   # lexical path for jitspec extraction
    cases: Callable[[Any, AuditScale], list[KernelCase]]
    must_write_in_place: tuple = ()
    must_keep: tuple = ()
    no_upload: bool = False
    # packed-plane policing (solver/problem.py): the staged problem must
    # carry the bit-packed eligibility words (int32 here, the reference's
    # uint32 bits) and NO preference plane
    packed_planes: bool = True


def problem_static_fields() -> list[str]:
    """The non-tensor fields of TorchProblem (the reference's static
    DeviceProblem fields): every one is host data a dispatch reads as a
    Python value. Enumerated from the dataclass, so a new field shows up
    as a contract diff."""
    from .problem import TENSOR_FIELDS, TorchProblem
    return sorted(f.name for f in dataclasses.fields(TorchProblem)
                  if f.name not in TENSOR_FIELDS)


def _synthetic(S: int, N: int, kw: dict):
    return _synthetic_cached(S, N, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=4)
def _synthetic_cached(S: int, N: int, kw: tuple):
    """One fleet per size and generator: the contracts of one audit share
    it (no case writes the host tensors)."""
    from ..lower.tensors import synthetic_problem
    return synthetic_problem(S, N, **dict(kw))


def _greedy_seed(pt, prob):
    """K4's cold seed of the staging `prob` (solve()'s own: placement
    order, phantoms last), on the host: the warm seed every case adopts."""
    import torch

    from .greedy import greedy_place_batched, placement_order
    from .problem import unify_conflict_ids
    order = np.concatenate([
        placement_order(pt.demand, pt.dep_depth, unify_conflict_ids(pt)),
        np.arange(pt.S, prob.S, dtype=np.int32)])
    seed = greedy_place_batched(prob, torch.tensor(
        order, dtype=torch.int32, device=prob.device))
    return seed.cpu().numpy()[:pt.S]


def _seeded(rp, pt):
    """`rp` with K4's placement of `pt` adopted as its warm seed."""
    rp.adopt_host(_greedy_seed(pt, rp.prob), pt.node_valid, warm=False)
    return rp


def _resident(pt, device):
    """A bucketed resident staging of `pt`, seeded."""
    from .resident import ResidentProblem
    return _seeded(ResidentProblem(pt, device), pt)


def _churned(rp, nodes: int):
    """`rp` after a churn burst: its `nodes` busiest nodes (by the seed's
    placement) killed through ``apply_delta``, the in-place merge."""
    from .resident import ProblemDelta
    pt = rp.pt
    load = np.bincount(rp._mirror[:pt.S], minlength=pt.N)
    valid = np.asarray(pt.node_valid, dtype=bool).copy()
    valid[np.argsort(-load, kind="stable")[:nodes]] = False
    rp.apply_delta(dataclasses.replace(pt, node_valid=valid),
                   ProblemDelta(node_valid=valid))
    return rp


def _warm(rp):
    """The warm dispatches' staging: 5% of the nodes (at least one) down
    since the seed, as [main]'s second burst — on the headline fleet more
    stranded services than the fused pre-repair's budget, so the full
    path's anneal sweeps."""
    return _churned(rp, max(1, rp.pt.N * CHURN_PCT // 100))


def _gen(device, seed: int = 0):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _rich_delta(pt, n_rows: int = 3):
    """A delta exercising every merge input: validity and capacity plus
    demand and eligibility row scatters (the richest variant, the one that
    writes every plane the merge owns)."""
    from .resident import ProblemDelta
    rows = np.arange(min(n_rows, pt.S), dtype=np.int32)
    return ProblemDelta(
        node_valid=np.asarray(pt.node_valid, dtype=bool).copy(),
        capacity=np.asarray(pt.capacity, dtype=np.float32).copy(),
        demand_rows=(rows, np.asarray(pt.demand, np.float32)[rows]),
        eligible_rows=(rows, np.asarray(pt.eligible, bool)[rows]))


_MERGE_ARG_NAMES = ("prob", "assignment", "node_valid", "capacity",
                    "demand_rows", "eligible_rows", "n_real")

# the planes the merge writes (resident.merge_delta): the node planes, the
# changed demand and eligibility rows, and the assignment's phantom tail.
# The reference's alias set also names conflict_ids and coloc_ids, which
# its merge re-emits; this merge leaves them where they lie (ROADMAP,
# deliberate differences). Every other tensor keeps its storage.
_MERGE_IN_PLACE = ("prob.node_valid", "prob.capacity", "prob.demand",
                   "prob.eligible", "assignment")


def _merge_case(rp, pt, fn) -> KernelCase:
    up = rp.merge_inputs(pt, _rich_delta(pt))
    return KernelCase(
        tier=f"{rp.prob.S}x{pt.N}", fn=fn,
        args=(rp.prob, rp.assignment, up["node_valid"], up["capacity"],
              (up["dem_idx"], up["dem_val"]),
              (up["elig_idx"], up["elig_rows"]), None),
        kwargs=dict(first_valid=int(np.argmax(up["valid_np"]))),
        arg_names=_MERGE_ARG_NAMES)


def _resident_merge_cases(device, scale: AuditScale) -> list[KernelCase]:
    from .resident import merge_delta
    out = []
    for S, N, kw in scale.single:
        pt = scale.fleet(S, N, kw)
        out.append(_merge_case(_resident(pt, device), pt, merge_delta))
    return out


def _sharded_mesh(device):
    from .sharded import SVC_AXIS, Mesh
    return Mesh([device] * SHARDED_POSITIONS, (SVC_AXIS,))


def _sharded_resident(pt, device):
    """A sharded resident staging of `pt` on the 1x8 mesh, seeded."""
    from .sharded import ShardedResident
    return _seeded(ShardedResident(pt, mesh=_sharded_mesh(device)), pt)


def _sharded_merge_cases(device, scale: AuditScale) -> list[KernelCase]:
    from .sharded import merge_sharded
    out = []
    for S, N, kw in scale.sharded:
        pt = scale.fleet(S, N, kw)
        out.append(_merge_case(_sharded_resident(pt, device), pt,
                               merge_sharded))
    return out


_REFINE_ARG_NAMES = ("prob", "seed_assignment", "gen", "t0", "t1",
                     "migration_weight")


def _warm_kwargs(S: int, device) -> dict:
    """The warm full path's keyword arguments, as api.solve derives them
    for a resident warm solve (fused pre-repair, the trusted 0-sweep
    exit), at the audit's sweep budget."""
    from .anneal import backend_proposals_per_step, solve_trace_blocks
    return dict(chains=1, steps=AUDIT_STEPS, warm=True, anneal_block=1,
                proposals_per_step=backend_proposals_per_step(S, device),
                fused_prerepair=True, prerepair_moves=max(16, min(S, 256)),
                skip_feasible_polish=True,
                trace_blocks=solve_trace_blocks())


def _refine_cases(device, scale: AuditScale) -> list[KernelCase]:
    """api._refine in the warm resident configuration after a churn burst,
    the kwargs derived as api.solve derives them."""
    from .api import _refine
    out = []
    for S, N, kw in scale.single:
        pt = scale.fleet(S, N, kw)
        rp = _warm(_resident(pt, device))
        prob = rp.prob
        out.append(KernelCase(
            tier=f"{prob.S}x{N}", fn=_refine,
            args=(prob, rp.assignment, _gen(rp.device), 0.1, 1e-3, 0.5),
            kwargs=dict(_warm_kwargs(prob.S, rp.device), adaptive=True),
            arg_names=_REFINE_ARG_NAMES))
    return out


_MUX_ARG_NAMES = ("prob", "seeds", "gens", "t0s", "t1s", "mws")


def _mux_refine_cases(device, scale: AuditScale) -> list[KernelCase]:
    """The multiplexer's lane path: K same-tier resident stages stacked
    (multiplex.stack_problems) and refined at once by api._refine_lanes,
    the kwargs derived as multiplex._solve_batch derives them."""
    import torch

    from .api import _refine_lanes
    from .multiplex import stack_problems
    out = []
    for S, N, K in scale.mux:
        lanes = [_warm(_resident(scale.fleet(S, N, dict(_SYN, seed=lane)),
                                 device)) for lane in range(K)]
        prob = lanes[0].prob
        dev = lanes[0].device
        out.append(KernelCase(
            tier=f"{prob.S}x{N}:k{K}", fn=_refine_lanes,
            args=(stack_problems([rp.prob for rp in lanes]),
                  torch.stack([rp.assignment for rp in lanes]),
                  [_gen(dev, i) for i in range(K)], [0.1] * K, [1e-3] * K,
                  [0.5] * K),
            kwargs=dict(_warm_kwargs(prob.S, dev), live=[True] * K),
            arg_names=_MUX_ARG_NAMES))
    return out


_SUBSOLVE_ARG_NAMES = ("prob", "assignment", "staged", "plan", "gen", "t0",
                       "t1", "migration_weight")


def _subsolve_cases(device, scale: AuditScale) -> list[KernelCase]:
    """The churn-localized sub-solve in its warm configuration: a resident
    staging, its busiest node killed through apply_delta, the planner's
    closure uploaded by stage_subsolve, the kwargs derived as api.solve
    derives them."""
    from .anneal import backend_proposals_per_step, solve_trace_blocks
    from .subsolve import (ActiveIndex, SubsolveConfig, plan_active,
                           stage_subsolve, subsolve_config,
                           subsolve_dispatch)

    # the audit tiers sit far below the production mini-tier ladder: a
    # permissive gate there (the reference's), the production one at full
    # width
    small = SubsolveConfig(enabled=True, frac=1.0, min_tier=8, max_tier=4096)
    out = []
    for S, N, kw in scale.single:
        pt = scale.fleet(S, N, kw)
        rp = _churned(_resident(pt, device), 1)
        cfg = small if scale.name == "tiers" else subsolve_config()
        plan, outcome = plan_active(
            ActiveIndex(rp.pt), rp.pt, rp._mirror, rp.prob.S, rp.prob.T,
            rp._pending_rows, cfg, G_full=rp.prob.G, Gc_full=rp.prob.Gc)
        if plan is None:
            raise RuntimeError(f"subsolve.localized at {S}x{N}: the planner "
                               f"fell back ({outcome})")
        staged = stage_subsolve(rp, plan)
        out.append(KernelCase(
            tier=f"{rp.prob.S}x{N}:t{plan.tier}", fn=subsolve_dispatch,
            args=(rp.prob, rp.assignment, staged, plan, _gen(rp.device), 0.1,
                  1e-3, 0.5),
            kwargs=dict(chains=1, steps=AUDIT_STEPS, block=1,
                        proposals_per_step=backend_proposals_per_step(
                            plan.tier, rp.device),
                        trace_blocks=solve_trace_blocks()),
            arg_names=_SUBSOLVE_ARG_NAMES))
    return out


_ANNEAL_SHARDED_ARG_NAMES = ("prob", "init_assignment", "gen")


def _anneal_sharded_cases(device, scale: AuditScale) -> list[KernelCase]:
    """sharded.anneal_sharded as solve_sharded runs it warm after a churn
    burst (adaptive, return_stats), on the one-card mesh of 1x8
    positions."""
    from .anneal import solve_trace_blocks
    from .sharded import anneal_sharded
    out = []
    for S, N, kw in scale.sharded:
        pt = scale.fleet(S, N, kw)
        rp = _warm(_sharded_resident(pt, device))
        out.append(KernelCase(
            tier=f"{rp.prob.S}x{N}", fn=anneal_sharded,
            args=(rp.prob, rp.assignment, _gen(rp.device)),
            kwargs=dict(steps=AUDIT_STEPS, t0=0.1, t1=1e-3, mesh=rp.mesh,
                        adaptive=True, block=8, ladder=1.3,
                        exchange_every=1, return_stats=True,
                        trace_blocks=solve_trace_blocks()),
            arg_names=_ANNEAL_SHARDED_ARG_NAMES))
    return out


def hot_path_kernels() -> list[KernelContract]:
    """The registry the auditor iterates, in the order findings print."""
    return [
        KernelContract(
            name="resident.merge",
            module="fleetflow_tpu_torch.solver.resident",
            qualname="merge_delta",
            cases=_resident_merge_cases,
            must_write_in_place=_MERGE_IN_PLACE),
        KernelContract(
            name="refine.warm",
            module="fleetflow_tpu_torch.solver.api",
            qualname="_refine",
            cases=_refine_cases,
            must_keep=("seed_assignment",), no_upload=True),
        KernelContract(
            name="mux.anneal",
            module="fleetflow_tpu_torch.solver.api",
            qualname="_refine_lanes",
            # every lane's resident seed must outlive the dispatch (it
            # re-seeds the serial path if the batch's gate rejects a lane)
            cases=_mux_refine_cases,
            must_keep=("seeds",), no_upload=True),
        KernelContract(
            name="subsolve.localized",
            module="fleetflow_tpu_torch.solver.subsolve",
            qualname="subsolve_dispatch",
            # the original assignment must outlive the dispatch: a
            # gate-rejected sub-solve re-seeds the full path from it
            cases=_subsolve_cases,
            must_keep=("assignment",), no_upload=True),
        KernelContract(
            name="sharded.merge",
            module="fleetflow_tpu_torch.solver.sharded",
            qualname="merge_sharded",
            cases=_sharded_merge_cases,
            must_write_in_place=_MERGE_IN_PLACE),
        KernelContract(
            name="sharded.anneal",
            module="fleetflow_tpu_torch.solver.sharded",
            qualname="anneal_sharded",
            cases=_anneal_sharded_cases,
            must_keep=("init_assignment",), no_upload=True),
    ]
