"""Top-level solve pipeline (port of ``solver/api.py``).

    ProblemTensors ──prepare──▶ TorchProblem (staged once)
        ──greedy seed (K4 batched, K6 scan, or a host FFD)──▶ assignment
        ──[warm: rebuild (K3) + fused pre-repair (K2), or the legacy
           host pre-repair]──▶ seed state
        ──chain fan-out──▶ (C, S)
        ──adaptive anneal (K1 per sweep)──▶ best (C, S)
        ──lexicographic chain pick + exact gate (K3)──▶ assignment
        ──host verify/repair backstop──▶ SolveResult

Everything between the seed and the host decision runs on the solve's
device; the host reads the result once. A bucketed solve runs on the
problem padded onto its tier ladder (phantom rows, solver/buckets.py) and
reports the real rows only. A resident warm solve first tries the
churn-localized sub-solve (solver/subsolve.py: K5 gather, K3/K2/K1 over the
mini tier, K5 commit, K3 gate on the full problem) and falls back to the
full path above when there is no plan or the gate rejects its result.
``_refine_lanes`` runs the full path's refine over a lane axis of same-tier
stages at once (the tenant multiplexer, solver/multiplex.py); a solo solve
is its one-lane case. :func:`solve` first asks the sharded route
(solver/sharded.py) whether the instance takes the service-axis sharded
path. ``solve(mesh=)`` is the reference's chain-sharded mesh: the chains
spread over the ranks of a process group (``parallel.chain_mesh``), each
rank annealing its share of them on its card, equal to the one-card solve
of all the chains bit for bit.

Observability, as the reference's: the solver's metric families on the
port's ``obs.metrics.REGISTRY`` (the reference's names, labels and HELP),
one ``solve …`` INFO line a call under `fleetflow.solver`, the telemetry
payload as a ``solve.trace`` flight-recorder record when FLEET_TRACE_FILE
is set, the whole call under ``obs.profile_trace`` (a torch.profiler
Chrome trace when FLEET_PROFILE_DIR is set), and every hot dispatch in
:func:`_dispatch_scope`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import _ext
from ..device import resolve_device
from ..lower.tensors import ProblemTensors
from ..obs import get_logger, kv, profile_trace
from ..obs.metrics import REGISTRY, SOLVE_SECONDS_BUCKETS
from ..obs.trace import (current_span_id, current_trace_id, flight_recorder,
                         new_span_id, new_trace_id, record_span_event)
from . import subsolve as _sub
from .anneal import (TRACE_COLS, ChainSlice, anneal_adaptive_lanes,
                     anneal_states, backend_proposals_per_step,
                     chain_states_from_assignment, prerepair_state_counted,
                     solve_trace_blocks, state_soft_score,
                     state_violation_stats)
from .buckets import (_env_flag, bucket_config, pad_assignment,
                      pad_problem_tiers, record_bucket, stage_problem_tiers)
from .greedy import (greedy_place, greedy_place_batched,
                     partitioned_seed, placement_order)
from .kernels import (STAT_KEYS, exact_stats_and_soft, k3_rebuild,
                      soft_from_planes, soft_score)
from .problem import TorchProblem, prepare_problem, unify_conflict_ids
from .repair import RepairResult, repair, soft_score_host, verify
from .resident import ResidentProblem

__all__ = ["solve", "SolveResult", "make_chain_inits", "DEFAULT_STEPS",
           "REFINE_RANGE", "SUBSOLVE_RANGE", "SEED_IMPLS",
           "legacy_host_prepass", "count_solve", "record_solve"]

log = get_logger("solver")

_M_SOLVES = REGISTRY.counter(
    "fleet_solver_solves_total", "Placement solves by backend and start mode",
    labels=("backend", "warm"))
_M_SOLVE_S = REGISTRY.histogram(
    "fleet_solver_solve_duration_seconds", "End-to-end solve() wall time",
    buckets=SOLVE_SECONDS_BUCKETS)
_M_SWEEPS = REGISTRY.counter(
    "fleet_solver_sweeps_total", "Annealing sweeps run across all solves")
_M_ACCEPTED = REGISTRY.counter(
    "fleet_solver_proposals_accepted_total",
    "Metropolis proposals accepted (adaptive anneal)")
_M_VIOL = REGISTRY.gauge(
    "fleet_solver_violations",
    "Hard violations of the most recent solve (post-repair)")
_M_PRE_VIOL = REGISTRY.gauge(
    "fleet_solver_pre_repair_violations",
    "Device-solver violations of the most recent solve before host repair")
_M_BUCKET = REGISTRY.counter(
    "fleet_solver_bucket_solves_total",
    "Bucketed solves by executable reuse (hit = padded shape already "
    "compiled for in this process)", labels=("hit",))
_M_PAD_WASTE = REGISTRY.gauge(
    "fleet_solver_bucket_pad_waste_ratio",
    "Phantom fraction of the most recent bucketed solve's service rows")
_M_INFLIGHT = REGISTRY.gauge(
    "fleet_solver_dispatches_in_flight",
    "Solver anneal dispatches currently executing (full fused + "
    "localized sub-solve) — deep-sampled by the obs collector")
_M_DISPATCH_DELTA = REGISTRY.gauge(
    "fleet_solver_dispatch_device_delta_bytes",
    "Device bytes_in_use delta across the most recent profiled dispatch "
    "(FLEET_PROFILE_SOLVER=1; stays 0 when the backend reports no "
    "allocator stats, e.g. CPU)")
# the front end's staging phase, get-or-create with the front end's own
# registration (name, HELP and labels of the reference's core/parsecache)
_M_FRONTEND_MS = REGISTRY.gauge(
    "fleet_frontend_phase_ms",
    "Milliseconds of the most recent front-end phase: parse (per-file "
    "fragment parsing incl. cache lookups), lower (aggregation + tensor "
    "lowering), stage (host->device staging)",
    labels=("phase",))
# the kernel libraries' builds and loads (registered by _ext)
_M_COMPILES = _ext.M_COMPILE_EVENTS

DEFAULT_STEPS = 128   # max sweeps of the adaptive anneal
# torch.profiler ranges around the device work of a solve: on a warm solve
# each is a warm dispatch, in which the card must make no host-to-device
# copy
REFINE_RANGE = "fleet.refine"       # _refine, the full path
SUBSOLVE_RANGE = "fleet.subsolve"   # the localized sub-solve


def backend_label(dev) -> str:
    """The `backend` label of a solve on `dev` (a device or its name): the
    reference's vocabulary (``jax.default_backend()``), "gpu" on the card
    and "cpu" on the host."""
    return "gpu" if str(dev).startswith("cuda") else "cpu"


@contextlib.contextmanager
def _dispatch_scope(label: str, dev: torch.device):
    """Every hot dispatch (the full path's refine, the localized sub-solve)
    runs inside this scope, under the torch.profiler range `label`.
    Always: the in-flight gauge. On the card with FLEET_PROFILE_SOLVER=1
    also the allocator's bytes delta across the dispatch
    (``torch.cuda.memory_allocated``, a host counter: no sync), so a
    leaking dispatch shows as a climbing gauge; on the CPU the gauge stays
    0, as the reference's does there."""
    profile = dev.type == "cuda" and os.environ.get(
        "FLEET_PROFILE_SOLVER", "").lower() in ("1", "true", "on", "yes")
    before = torch.cuda.memory_allocated(dev) if profile else 0
    _M_INFLIGHT.inc()
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        _M_INFLIGHT.dec()
        if profile:
            _M_DISPATCH_DELTA.set(torch.cuda.memory_allocated(dev) - before)


def _record_solve_trace(payload: dict, **fields) -> None:
    """Record one solve's telemetry as a flight-recorder span payload
    (kind="telemetry", name "solve.trace"). No-op — one env lookup — when
    FLEET_TRACE_FILE is unset."""
    if flight_recorder() is None:
        return
    record_span_event(
        "telemetry", "solve.trace", "fleetflow.solver",
        trace=current_trace_id() or new_trace_id(),
        span=current_span_id() or new_span_id(),
        fields={**fields, "telemetry": payload})


@dataclass
class SolveResult:
    assignment: np.ndarray          # (S,) node index per service
    stats: dict                     # exact violation stats (host-verified)
    soft: float                     # soft score of the final assignment
    feasible: bool
    moves_repaired: int = 0
    # violations of the device solver's own winner, before the host repair
    # backstop touched it (0 = the device solve was already feasible)
    pre_repair_violations: int = 0
    timings_ms: dict = field(default_factory=dict)
    chains: int = 0
    steps: int = 0                  # sweeps the anneal ran
    proposals_per_step: int = 0
    accepted_moves: int = -1        # -1 on the fixed-budget path
    fused_prerepair: bool = False
    # {"schema", "blocks", "trace_blocks", "init", "prerepair_moves",
    #  "exit_sweep", "path"} and "subsolve" when one ran, the reference's
    # schema; None on the fixed-budget path or with
    # FLEET_SOLVE_TRACE_BLOCKS=0
    telemetry: Optional[dict] = None
    # ResidentProblem.upload calls made during the warm dispatch (the
    # counterpart of the reference's transfer guard for the resident state)
    warm_h2d_copies: int = 0
    device: str = ""
    # shape bucketing of this solve, {"orig_S", "padded_S", "pad_waste"},
    # or None for an exact-shape solve
    bucket: Optional[dict] = None
    # the churn-localized sub-solve: {rows, tier, affected, outcome, ms}
    # when one ran ("localized" = committed by the exact gate,
    # "fallback_infeasible" = the full path re-ran), None otherwise
    subsolve: Optional[dict] = None
    # the sharded path's replicas and exchanges: {replicas, ladder,
    # exchange_every, swap_attempts, swap_accepts}; None off that path
    tempering: Optional[dict] = None

    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed, or -1.0 when acceptance was not tracked."""
        proposed = self.steps * self.chains * self.proposals_per_step
        if self.accepted_moves < 0 or proposed <= 0:
            return -1.0
        return self.accepted_moves / proposed

    @property
    def violations(self) -> int:
        return int(self.stats["total"])


# the greedy seeds of a cold solve: K6's per-service scan, K4's batched
# placement, the host placer's FFD, and the host FFD over 4 service slices
# × disjoint node subsets
SEED_IMPLS = ("scan", "batched", "native", "partitioned")


def legacy_host_prepass(pt: ProblemTensors, seed_np: np.ndarray,
                        seed: int) -> np.ndarray:
    """The legacy host pre-repair of a warm seed (``prerepair=True``):
    services stranded on dead or ineligible nodes are relocated by the host
    repair. The result is kept even when it cannot reach 0 violations: it
    is never worse than its input."""
    rows = np.arange(pt.S)
    stranded = (~pt.node_valid[seed_np]) | (~pt.eligible[rows, seed_np])
    if stranded.any():
        seed_np = repair(pt, seed_np, seed=seed).assignment
    return seed_np


def make_chain_inits(prob: TorchProblem, seed_assignment: torch.Tensor,
                     chains: int, gen: torch.Generator,
                     perturb_frac: float = 0.08) -> torch.Tensor:
    """(C, S) chain starts: chain 0 is the seed, the others move a random
    `perturb_frac` of services onto random nodes."""
    dev = seed_assignment.device
    mask = torch.rand((chains, prob.S), generator=gen, device=dev) < perturb_frac
    rand = torch.randint(0, prob.N, (chains, prob.S), generator=gen,
                         device=dev, dtype=torch.int32)
    inits = torch.where(mask, rand, seed_assignment.to(torch.int32)[None])
    inits[0] = seed_assignment
    return inits


def _refine(prob: TorchProblem, seed_assignment: torch.Tensor,
            gen: torch.Generator, t0: float, t1: float,
            migration_weight: float, *, chains: int, steps: int, warm: bool,
            adaptive: bool, anneal_block: int,
            proposals_per_step: int, fused_prerepair: bool,
            prerepair_moves: int, skip_feasible_polish: bool,
            trace_blocks: int, on_mesh: Optional[ChainSlice] = None):
    """Everything after the seed, on the device: stickiness, fused
    pre-repair, chain fan-out, anneal, chain pick and the exact gate.
    Returns (winner (S,) i32, stats dict of 0-dim tensors, soft 0-dim,
    sweeps_run int, accepted 0-dim, telemetry dict). The adaptive anneal
    is one lane of :func:`_refine_lanes`. `on_mesh`: this rank's chains
    of a chain mesh (the winner, stats and telemetry are the whole
    set's, the same on every rank)."""
    if adaptive:
        winners, stats, soft, sweeps, accepted, telem = _refine_lanes(
            prob.as_lanes(), seed_assignment[None], [gen], [t0], [t1],
            [migration_weight], chains=chains, steps=steps, warm=warm,
            anneal_block=anneal_block,
            proposals_per_step=proposals_per_step,
            fused_prerepair=fused_prerepair,
            prerepair_moves=prerepair_moves,
            skip_feasible_polish=skip_feasible_polish,
            trace_blocks=trace_blocks, on_mesh=on_mesh)
        return (winners[0], {k: v[0] for k, v in stats.items()}, soft[0],
                sweeps[0], accepted[0], telem[0])
    # the fixed-budget anneal: `steps` sweeps, each chain's final state
    prob_a = (dataclasses.replace(prob, sticky_prev=seed_assignment,
                                  sticky_w=float(migration_weight))
              if warm else prob)
    dev = seed_assignment.device
    prerepair_applied = torch.zeros(1, dtype=torch.int32, device=dev)
    if fused_prerepair:
        st0 = chain_states_from_assignment(prob_a, seed_assignment)
        st0, prerepair_applied = prerepair_state_counted(
            prob_a, st0, prerepair_moves)
        seed_assignment = st0.assignment[0]
    inits = make_chain_inits(prob_a, seed_assignment, chains, gen,
                             perturb_frac=0.0 if warm else 0.08)
    if on_mesh is not None:
        inits = inits[on_mesh.c0:on_mesh.c0 + on_mesh.per]
    states = anneal_states(prob_a, inits, gen, steps=steps, t0=t0, t1=t1,
                           proposals_per_step=proposals_per_step,
                           on_mesh=on_mesh)
    viol_c = state_violation_stats(prob_a, states)["total"]
    soft_c = state_soft_score(prob_a, states)
    if on_mesh is not None:
        viol_c, soft_c = _mesh_pick_rows(on_mesh, viol_c[None],
                                         soft_c[None])
        viol_c, soft_c = viol_c[0], soft_c[0]
    best = torch.argmin(torch.where(viol_c == viol_c.min(), soft_c,
                                    torch.full_like(soft_c, float("inf"))))
    if on_mesh is not None:
        winner = _mesh_winner(on_mesh, states.assignment[None],
                              best.reshape(1))[0]
    else:
        winner = states.assignment[best]
    stats, soft = exact_stats_and_soft(prob, winner)
    accepted = torch.full((), -1, dtype=torch.int32, device=dev)
    return winner, stats, soft, steps, accepted, {
        "prerepair_moves": prerepair_applied[0]}


def _mesh_pick_rows(on_mesh: ChainSlice, viol_c: torch.Tensor,
                    soft_c: torch.Tensor):
    """Every rank's (violations, soft) of its chains, (L, C/W) each,
    gathered into the whole set's (L, C) in chain order."""
    from .collectives import all_gather
    every = all_gather(torch.stack([viol_c, soft_c]), on_mesh.group)
    whole = every.permute(1, 2, 0, 3).reshape(2, viol_c.shape[0], on_mesh.C)
    return whole[0], whole[1]


def _mesh_winner(on_mesh: ChainSlice, best_c: torch.Tensor,
                 best: torch.Tensor) -> torch.Tensor:
    """(L, S): chain `best[l]` of the whole set, sent by the rank that
    holds it (`best_c` is this rank's (L, C/W, S)). The broadcast from a
    device index is an integer sum in which every other rank adds zeros:
    the host never reads the pick."""
    from .collectives import all_sum_int_
    L, per, S = best_c.shape
    owner = torch.div(best, per, rounding_mode="floor")
    row = (best - owner * per).clamp(0, per - 1)
    mine = torch.gather(best_c, 1, row[:, None, None].expand(L, 1, S))[:, 0]
    held = (owner == on_mesh.group.index)[:, None]
    return all_sum_int_(torch.where(held, mine, 0).to(torch.int32),
                        on_mesh.group)


def _refine_lanes(prob: TorchProblem, seeds: torch.Tensor, gens: list,
                  t0s: list, t1s: list, mws: list, *, chains: int,
                  steps: int, warm: bool, anneal_block: int,
                  proposals_per_step: int, fused_prerepair: bool,
                  prerepair_moves: int, skip_feasible_polish: bool,
                  trace_blocks: int, live: Optional[list] = None,
                  on_mesh: Optional[ChainSlice] = None):
    """The adaptive :func:`_refine` over a leading lane axis: the
    multiplexer's dispatch (the reference vmaps ``_refine`` over K
    same-tier lanes, ``multiplex._mux_refine``). `prob` is lane-stacked
    (L lanes), `seeds` (L, S); `gens`, `t0s`, `t1s` and `mws` (the
    migration weights) hold one entry per lane. Each step runs for every
    lane at once: the K3 rebuild, K2, the chain fan-out, the adaptive
    anneal with per-lane exit (K1), the chain pick and the K3 gate; each
    lane's result equals the solo refine of its stage with its generator.
    Lanes not in `live` (the ladder's padding) never sweep and are not
    gated. Returns (winners (L, S), stats dict of (L,) tensors, soft (L,),
    sweeps [L ints], accepted (L,), [L telemetry dicts]).

    `on_mesh` (one lane): this rank anneals its chains of a chain mesh;
    it draws the chain starts of the whole set and keeps its own, the
    pick gathers every chain's (violations, soft) and the winner comes
    from the rank that holds it, and every rank gates it (K3): the
    result is the one-card refine's of all `chains`, on every rank."""
    L, S = seeds.shape
    live = [True] * L if live is None else [bool(x) for x in live]
    if warm:
        # staying on the previous still-eligible node earns the lane's
        # migration weight; churn-forced moves stay free
        prob_a = dataclasses.replace(
            prob, sticky_prev=seeds, sticky_w=tuple(float(w) for w in mws))
    else:
        prob_a = prob
    dev = seeds.device
    init_states = None
    prerepair_applied = torch.zeros(L, dtype=torch.int32, device=dev)
    if fused_prerepair:
        st0 = chain_states_from_assignment(prob_a, seeds)
        st0, prerepair_applied = prerepair_state_counted(
            prob_a, st0, prerepair_moves)
        seeds = st0.assignment[:, 0]
        # warm chains start from the repaired state itself
        init_states = st0.expand_lanes(
            chains if on_mesh is None else on_mesh.per)
    # each lane draws its chain starts from its own generator, first, as
    # the solo refine does (a fused prologue's chains start from the
    # repaired state, but the draws still advance the generator)
    inits = [make_chain_inits(prob_a.lane(i), seeds[i], chains, gens[i],
                              perturb_frac=0.0 if warm else 0.08)
             if live[i] else seeds[i].expand(chains, S) for i in range(L)]
    if on_mesh is not None:
        inits = [x[on_mesh.c0:on_mesh.c0 + on_mesh.per] for x in inits]
    if init_states is None:
        init_states = chain_states_from_assignment(
            prob_a, torch.stack(inits) if L > 1 else inits[0][None])
    best_c, viol_c, soft_c, sweeps, accepted_c, telems = \
        anneal_adaptive_lanes(
            prob_a, init_states, gens, t0s, t1s, max_steps=steps,
            block=anneal_block, proposals_per_step=proposals_per_step,
            exit_on_feasible_init=skip_feasible_polish,
            trace_blocks=trace_blocks, live=live, on_mesh=on_mesh)
    accepted = accepted_c.sum(1)
    if on_mesh is not None:
        from .collectives import all_sum_int_
        viol_c, soft_c = _mesh_pick_rows(on_mesh, viol_c, soft_c)
        accepted = all_sum_int_(accepted.to(torch.int32), on_mesh.group)
    # lexicographic (violations, soft): among each lane's least-violating
    # chains the best soft wins
    least = viol_c == viol_c.min(1, keepdim=True).values
    best = torch.argmin(torch.where(least, soft_c,
                                    torch.full_like(soft_c, float("inf"))),
                        dim=1)
    if on_mesh is not None:
        winners = _mesh_winner(on_mesh, best_c, best)
    else:
        winners = torch.gather(best_c, 1,
                               best[:, None, None].expand(L, 1, S))[:, 0]
    soft_pick = torch.gather(soft_c, 1, best[:, None])[:, 0]
    # a warm exit before any sweep applied nothing: the carried state IS
    # the prologue's scratch-built state, so a feasible count there is
    # exact (the trusted 0-sweep exit, lane by lane)
    exited = [skip_feasible_polish and live[i] and sweeps[i] == 0
              for i in range(L)]
    trusted = exited
    if any(exited):
        picked = torch.gather(viol_c, 1, best[:, None])[:, 0] == 0
        trusted = [e and f for e, f in zip(exited, picked.tolist())]
    gated = [live[i] and not trusted[i] for i in range(L)]
    zero = torch.zeros(len(STAT_KEYS), dtype=torch.float32, device=dev)
    stat_rows = [zero] * L
    softs = [soft_pick[i] for i in range(L)]
    if any(gated):
        # the exact gate of every lane in one K3 launch (no stickiness)
        load, _used, coloc, _topo, gstats = k3_rebuild(prob, winners,
                                                       with_stats=True)
        for i in range(L):
            if gated[i]:
                stat_rows[i] = gstats[i, 0]
                softs[i] = soft_from_planes(prob.lane(i), winners[i],
                                            load[i], coloc[i])[0]
    stats = torch.stack(stat_rows)
    telems = [dict(t, prerepair_moves=prerepair_applied[i])
              for i, t in enumerate(telems)]
    return (winners, {k: stats[:, j] for j, k in enumerate(STAT_KEYS)},
            torch.stack(softs), sweeps, accepted, telems)


def run_overlap(work, timings: dict) -> None:
    """Run a solve's `overlap_host_work` (a zero-argument callable) and
    time it as ``timings["overlap_host_ms"]``; its exception propagates."""
    t_ov = time.perf_counter()
    work()
    timings["overlap_host_ms"] = (time.perf_counter() - t_ov) * 1e3


def _set_kwargs(fn, values: dict) -> dict:
    """The keyword-only arguments of `fn` that a call set away from their
    defaults, read from the call's `values` (its locals())."""
    out = {}
    for name, p in inspect.signature(fn).parameters.items():
        v = values[name]
        if p.kind is p.KEYWORD_ONLY and not (
                v is p.default or (type(v) is type(p.default)
                                   and v == p.default)):
            out[name] = v
    return out


def _solve_device(device=None, prob=None, resident=None, mesh=None, **_):
    """The device a solve call runs on, as solve() resolves it (the card
    when nothing names one), for profile_trace's CUDA activity."""
    if resident is not None:
        return resident.device
    if prob is not None:
        return prob.device
    if mesh is not None:
        return mesh.device
    return torch.device("cuda" if device is None else device)


def _profiled(fn):
    """Run `fn` (solve) under ``profile_trace("solve")``: a torch.profiler
    Chrome trace of the whole call when FLEET_PROFILE_DIR is set, nothing
    otherwise."""
    @functools.wraps(fn)
    def wrapper(pt, **kw):
        with profile_trace("solve", lambda: _solve_device(**kw)):
            return fn(pt, **kw)
    return wrapper


def count_solve(res: "SolveResult", pt: ProblemTensors, *, warm: bool,
                resident_warm: bool, lane: bool = False) -> None:
    """Fold a finished solve into the solve families and, when
    FLEET_TRACE_FILE is set, write its telemetry as a ``solve.trace``
    record. A multiplexer `lane` counts its solve, sweeps and accepted
    proposals, as the reference's lanes do (not its wall time or the
    violation gauges)."""
    _M_SOLVES.inc(backend=backend_label(res.device),
                  warm="true" if warm else "false")
    _M_SWEEPS.inc(res.steps)
    if res.accepted_moves >= 0:
        _M_ACCEPTED.inc(res.accepted_moves)
    total_ms = res.timings_ms.get("total_ms", 0.0)
    if not lane:
        _M_SOLVE_S.observe(total_ms / 1e3)
        _M_VIOL.set(res.violations)
        _M_PRE_VIOL.set(res.pre_repair_violations)
    if res.telemetry is not None:
        _record_solve_trace(res.telemetry, S=pt.S, N=pt.N, warm=warm,
                            resident=resident_warm,
                            violations=res.violations,
                            pre_repair=res.pre_repair_violations,
                            total_ms=round(total_ms, 3))


def record_solve(res: "SolveResult", pt: ProblemTensors, *, steps: int,
                 warm: bool, resident_warm: bool,
                 bucket_hit: Optional[bool] = None,
                 compiles: int = 0) -> None:
    """The per-solve bookkeeping of a finished solve: :func:`count_solve`
    and the ``solve …`` INFO line, built only when INFO is enabled."""
    count_solve(res, pt, warm=warm, resident_warm=resident_warm)
    if not log.isEnabledFor(logging.INFO):
        return
    b = res.bucket
    sub = res.subsolve
    log.info("solve %s", kv(
        S=pt.S, N=pt.N, chains=res.chains, steps=steps, sweeps=res.steps,
        accepted=res.accepted_moves if res.accepted_moves >= 0 else None,
        compiles=compiles or None,
        bucket=b["padded_S"] if b and b["padded_S"] != b["orig_S"] else None,
        bucket_hit=bucket_hit or None,
        violations=res.violations, pre_repair=res.pre_repair_violations,
        repaired=res.moves_repaired or None, warm=warm or None,
        resident=resident_warm or None, fused=res.fused_prerepair or None,
        sub=(f"{sub['rows']}/{sub['tier']}({sub['outcome']})"
             if sub else None),
        **{k: f"{v:.1f}" for k, v in res.timings_ms.items()}))


@_profiled
def solve(pt: ProblemTensors, *, device=None,
          chains: Optional[int] = None, steps: int = DEFAULT_STEPS,
          seed: int = 0, do_repair: bool = True,
          prob: Optional[TorchProblem] = None,
          init_assignment: Optional[np.ndarray] = None,
          t0: float = 1.0, t1: float = 1e-3,
          migration_weight: float = 0.5,
          seed_batch: int = 256, seed_rounds: int = 2,
          adaptive: bool = True, anneal_block: int = 1,
          warm_block: int = 1,
          proposals_per_step: Optional[int] = None,
          bucket: Optional[bool] = None,
          resident: Optional[ResidentProblem] = None,
          resident_warm: bool = False,
          seed_impl: Optional[str] = None,
          prerepair: Optional[bool] = None, mesh=None,
          overlap_host_work=None) -> SolveResult:
    """Solve a placement instance end to end.

    `device` defaults to the card (raises without CUDA); a `resident` or a
    pre-staged `prob` pins the device it lives on. `init_assignment`
    warm-starts from a previous placement on the host; `resident` with
    `resident_warm=True` warm-starts from the resident device assignment
    with no problem tensor crossing the host boundary, and tries the
    churn-localized sub-solve first. Warm starts are sticky: each service
    pays `migration_weight` of soft score for leaving its previous node.
    `chains=None` is 2 on the card and 1 on the CPU; the proposal width is
    256 on the card and 64 on the CPU (both capped at S/2).

    `seed_impl` picks the cold seed: "scan" (K6, one step per service),
    "batched" (K4), "native" (the host placer's FFD), "partitioned" (the
    host FFD over 4 service slices × disjoint node subsets), or None,
    which is "batched" on either device. "native" and "partitioned" raise
    SolverError when the host placer cannot be built.

    `anneal_block` is the adaptive exit's check granularity; a warm start
    (the full path, the sub-solve and the multiplexer's lanes) checks every
    min(`warm_block`, `anneal_block`) sweeps, as the reference does: a
    churn reschedule starts one node event away from feasible.

    `prerepair` picks the warm pre-repair: None runs the fused K2 prologue
    (and lets a resident warm solve try the sub-solve); True runs the
    legacy host pre-pass (:func:`legacy_host_prepass`, timed as
    ``prerepair_ms``) instead; False runs neither. Either non-None value
    turns off the fused prologue and the sub-solve.

    `bucket` pads the problem onto its tier ladder with phantom rows
    (solver/buckets.py). None defers to FLEET_BUCKET (default off for a
    direct solve), and a pre-padded `prob` (a bucketed resident staging)
    is used as it is. The returned assignment, violations and soft score
    are those of the real rows.

    Sharded routing: an instance above FLEET_SHARDED_MIN_CELLS (or any,
    under FLEET_SHARDED=1) with a mesh of >= 2 positions available solves
    through the mesh-resident sharded path (solver/sharded.solve_sharded)
    instead; explicit staging kwargs (prob, resident), and any knob that
    path does not speak set away from its default, keep the call here.

    `mesh` (``parallel.chain_mesh()``, the ranks of a process group)
    spreads the chains over the ranks, the reference's chain-sharded
    mesh: every rank calls solve with the same arguments, runs
    `chains` / ranks of the chains on its card (the problem and the seed
    replicated), and returns the same result, equal bit for bit to the
    one-card solve of all `chains` with the same `seed`. `chains` must be
    a multiple of the mesh's size (None: the backend's default rounded up
    to one); a solve on a mesh takes no sub-solve and no sharded route.

    `do_repair=False` turns off the host repair backstop: the host verify
    still runs, and the result (and the resident's warm seed) is the
    device winner with its violations. `overlap_host_work`, a zero-argument
    callable, runs once on the calling thread after the solve's last
    launch and before the first host read of its result, so host work
    (re-lowering a changed fleet) overlaps what is still in flight on the
    card: after the sub-solve's launches when one ran (its time is then
    left out of ``subsolve_ms``), else after the refine's. Its time is
    ``timings_ms["overlap_host_ms"]``; an exception from it propagates.
    On the full path the resident has then already adopted the winner; on
    the sub-solve branch it still holds its seed (the callable runs before
    the gate's read, and the sub-solve's commit does not write into it)."""
    if mesh is None:
        from .sharded import maybe_solve_sharded
        routed = maybe_solve_sharded(pt, **_set_kwargs(solve, locals()))
        if routed is not None:
            return routed
    if seed_impl is not None and seed_impl not in SEED_IMPLS:
        raise ValueError(f"seed_impl must be 'scan', 'batched', "
                         f"'native', 'partitioned' or None, "
                         f"got {seed_impl!r}")
    timings: dict[str, float] = {}
    t = time.perf_counter
    if resident is not None:
        dev = resident.device
    elif prob is not None:
        dev = prob.device
    elif mesh is not None:
        dev = mesh.device
    else:
        dev = resolve_device(device)
    on_mesh = None
    if mesh is not None:
        if len(mesh.axis_names) != 1:
            raise ValueError(f"solve(mesh=): a 1-D chain mesh, got "
                             f"{mesh.shape}")
        W = mesh.size
        if chains is None:
            base = 1 if dev.type == "cpu" else 2
            chains = W * -(-base // W)
        if chains % W:
            raise ValueError(f"chains={chains} must be a multiple of the "
                             f"mesh's {W} positions")
        if mesh.ranks is not None and W > 1:
            group = mesh.my_groups()["mesh"]
            on_mesh = ChainSlice(group, group.index * (chains // W), chains)
    if chains is None:
        chains = 1 if dev.type == "cpu" else 2
    resident_warm = bool(resident is not None and resident_warm
                         and resident.assignment is not None)

    t_start = t()
    compiles0 = _M_COMPILES.value()
    binfo = None
    staged_cold = False
    if prob is None and resident is not None:
        prob = resident.prob
    if bucket is None:
        bucket = (_env_flag("FLEET_BUCKET", False)
                  or (prob is not None and prob.S != pt.S))
    # a resident staging keeps the config it was padded under, so a
    # pre-padded staging passes through pad_problem_tiers unchanged
    cfg = resident.cfg if resident is not None else bucket_config()
    bucket = bool(bucket and cfg.enabled)
    if prob is None:
        # cold: stage directly at the padded shape, or at the exact one
        if bucket:
            prob, binfo = stage_problem_tiers(pt, cfg, dev)
            staged_cold = True
        else:
            prob = prepare_problem(pt, dev)
    elif bucket:
        prob, binfo = pad_problem_tiers(prob, cfg)
    if binfo is not None:
        binfo.orig_S = pt.S
    bucketed = binfo is not None and prob.S != pt.S
    if resident_warm:
        timings["delta_stage_ms"] = resident.consume_delta_ms()
    timings["stage_ms"] = (t() - t_start) * 1e3
    if staged_cold:
        _M_FRONTEND_MS.set(timings["stage_ms"], phase="stage")

    t_seed = t()
    warm = init_assignment is not None or resident_warm
    # the warm pre-repair: None fuses K2 into the refine; True is the
    # legacy host pre-pass; False is neither
    fused = warm and prerepair is None

    def host_prepass(seed_np: np.ndarray) -> np.ndarray:
        t_pre = t()
        seed_np = legacy_host_prepass(pt, seed_np, seed)
        timings["prerepair_ms"] = (t() - t_pre) * 1e3
        return seed_np

    if resident_warm:
        # the previous padded winner, phantoms re-parked at delta time
        seed_assignment = resident.assignment
        t0 = min(t0, 0.1)      # warm start: refine, don't re-scramble
        if prerepair is True:
            # the legacy pre-pass round-trips the seed through the host:
            # the real rows come back, are repaired, and adopt_host
            # uploads them (a counted host transfer)
            seed_np = host_prepass(np.array(
                seed_assignment.cpu().numpy(), dtype=np.int32,
                copy=True)[:pt.S])
            resident.adopt_host(seed_np, pt.node_valid, warm=True)
            seed_assignment = resident.assignment
    elif warm:
        seed_np = np.asarray(init_assignment, dtype=np.int32)
        if prerepair is True:
            seed_np = host_prepass(seed_np)
        if bucketed:
            seed_np = pad_assignment(seed_np, prob.S, pt.node_valid)
        seed_assignment = torch.tensor(seed_np, device=dev)
        t0 = min(t0, 0.1)
    elif seed_impl in ("native", "partitioned"):
        # the host placer's FFD, whole-instance or over 4 slices; raises
        # SolverError when the library cannot be built (no fallback)
        if seed_impl == "partitioned":
            host_seed = partitioned_seed(pt, 4)
        else:
            from ..native.lib import native_place
            host_seed, _viol = native_place(
                pt.demand, pt.capacity, pt.eligible, pt.node_valid,
                pt.dep_depth, pt.port_ids, pt.volume_ids, pt.anti_ids,
                strategy=pt.strategy.value)
        if bucketed:
            host_seed = pad_assignment(host_seed, prob.S, pt.node_valid)
        seed_assignment = torch.tensor(host_seed, dtype=torch.int32,
                                       device=dev)
    else:
        order_np = placement_order(pt.demand, pt.dep_depth,
                                   unify_conflict_ids(pt))
        if bucketed:
            # phantoms last: zero demand and eligible everywhere, the
            # greedy parks them on a valid node
            order_np = np.concatenate(
                [order_np, np.arange(pt.S, prob.S, dtype=np.int32)])
        order = torch.tensor(order_np, dtype=torch.int32, device=dev)
        if seed_impl == "scan":
            seed_assignment = greedy_place(prob, order)
        else:
            seed_assignment = greedy_place_batched(
                prob, order, batch=seed_batch, rounds=seed_rounds)
    # disjoint phases: the host pre-repair is reported under prerepair_ms
    timings["seed_ms"] = ((t() - t_seed) * 1e3
                          - timings.get("prerepair_ms", 0.0))

    # the widths and budgets follow the PADDED row count, as the
    # reference's static arguments do
    M = (proposals_per_step if proposals_per_step is not None
         else backend_proposals_per_step(prob.S, dev))
    trace_blocks = solve_trace_blocks()
    prerepair_moves = max(16, min(prob.S, 256)) if fused else 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    t_anneal = t()
    sub_plan = None
    if resident_warm and fused and adaptive and mesh is None:
        # the host planner: the closure and its compact id lists
        t_plan = t()
        sub_plan = resident.take_active_plan()
        timings["plan_ms"] = (t() - t_plan) * 1e3
    if binfo is not None:
        # hit = this process already ran a dispatch at these padded
        # extents and statics (the reference's executable identity)
        binfo.hit = record_bucket(
            (prob.S, prob.N, prob.G, prob.Gc, prob.T, prob.strategy,
             prob.max_skew, prob.conflict_ids.shape[1],
             prob.coloc_ids.shape[1], chains, steps,
             bool(warm and migration_weight > 0), adaptive,
             min(warm_block, anneal_block) if warm else anneal_block,
             M, fused, prerepair_moves,
             bool(resident_warm and adaptive and fused),
             prob.n_real is not None, trace_blocks, prob.eligible_packed,
             prob.preferred is not None,
             (sub_plan.tier, sub_plan.G_sub, sub_plan.Gc_sub)
             if sub_plan is not None else None))
        _M_BUCKET.inc(hit="true" if binfo.hit else "false")
        _M_PAD_WASTE.set(binfo.pad_waste)
    sub_info = None
    uploads = 0     # ResidentProblem.upload calls inside the dispatch ranges
    if sub_plan is not None:
        t_sub = t()
        # the plan (rows and id lists, one buffer) uploads before the
        # dispatch range opens; K5 builds the frozen base on the card
        staged = _sub.stage_subsolve(resident, sub_plan)
        h2d0 = resident.h2d_copies
        with _dispatch_scope(SUBSOLVE_RANGE, dev):
            (winner, dstats, dsoft, sweeps_run, accepted,
             dtelem) = _sub.subsolve_dispatch(
                prob, resident.assignment, staged, sub_plan, gen, t0, t1,
                migration_weight, chains=chains, steps=steps,
                block=min(warm_block, anneal_block),
                proposals_per_step=(
                    proposals_per_step if proposals_per_step is not None
                    else backend_proposals_per_step(sub_plan.tier, dev)),
                trace_blocks=trace_blocks)
        uploads += resident.h2d_copies - h2d0
        if overlap_host_work is not None:
            # the gate's read below waits for the sub-solve: the host work
            # runs now, while its launches are in flight, and once a call
            run_overlap(overlap_host_work, timings)
            overlap_host_work = None
        # the exact full-problem gate rules: feasible commits the scattered
        # result; otherwise the full path re-runs from the untouched seed
        sub_feasible = float(dstats["total"]) == 0
        # disjoint phases: the overlapped host work is not sub-solve time
        timings["subsolve_ms"] = ((t() - t_sub) * 1e3
                                  - timings.get("overlap_host_ms", 0.0))
        _sub.record_subsolve_ms(timings["subsolve_ms"])
        outcome = "localized" if sub_feasible else "fallback_infeasible"
        _sub.record_outcome(outcome)
        sub_info = {"rows": sub_plan.n_sub, "tier": sub_plan.tier,
                    "affected": sub_plan.affected, "outcome": outcome,
                    "ms": round(timings["subsolve_ms"], 2)}
        if not sub_feasible:
            sub_plan = None
    if sub_plan is None:
        h2d0 = resident.h2d_copies if resident is not None else 0
        with _dispatch_scope(REFINE_RANGE, dev):
            winner, dstats, dsoft, sweeps_run, accepted, dtelem = _refine(
                prob, seed_assignment, gen, t0, t1, migration_weight,
                chains=chains, steps=steps,
                warm=bool(warm and migration_weight > 0), adaptive=adaptive,
                anneal_block=(min(warm_block, anneal_block) if warm
                              else anneal_block),
                proposals_per_step=M, fused_prerepair=fused,
                prerepair_moves=prerepair_moves,
                skip_feasible_polish=bool(resident_warm and adaptive
                                          and fused),
                trace_blocks=trace_blocks, on_mesh=on_mesh)
        if resident is not None:
            uploads += resident.h2d_copies - h2d0
    if resident is not None:
        resident.adopt(winner)
    if overlap_host_work is not None:
        # host work while the refine's launches are in flight, before the
        # fetch below waits for them
        run_overlap(overlap_host_work, timings)
    # one fetch of the scalars, one of the assignment; np.array(copy=True)
    # because a CPU tensor's numpy view shares storage with the resident
    # seed, which the next merge updates in place
    blocks = dtelem.get("blocks", [])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    scalars = torch.stack(
        [dstats[k].to(torch.float32) for k in STAT_KEYS]
        + [dsoft.to(torch.float32), accepted.to(torch.float32).reshape(()),
           dtelem["prerepair_moves"].to(torch.float32),
           dtelem.get("init_violations", zero).to(torch.float32),
           dtelem.get("init_soft", zero).to(torch.float32)]
        + [row for _e, _t, dev_row in blocks for row in dev_row]
    ).cpu().numpy().astype(np.float64)
    padded_host = np.array(winner.cpu().numpy(), dtype=np.int32, copy=True)
    # phantom placements never leave the solver
    assignment = padded_host[:pt.S] if bucketed else padded_host
    dstats_h = dict(zip(STAT_KEYS, scalars[:5]))
    soft = float(scalars[5])
    accepted_h = int(scalars[6])
    prerepair_h = int(scalars[7])
    timings["anneal_ms"] = (t() - t_anneal) * 1e3

    t_verify = t()
    if dstats_h["total"] == 0:
        stats = {k: int(v) for k, v in dstats_h.items()}
        moves = 0
        pre_repair = 0
    else:
        stats = verify(pt, assignment)
        moves = 0
        pre_repair = int(stats["total"])
        if do_repair and stats["total"] > 0:
            rr: RepairResult = repair(pt, assignment)
            assignment, stats, moves = rr.assignment, rr.stats, rr.moves
            if resident is not None and moves:
                resident.adopt_host(assignment, pt.node_valid,
                                    warm=resident_warm)
            if not bucketed:
                soft = float(soft_score(prob, torch.tensor(assignment,
                                                           device=dev)))
    if bucketed or (resident_warm and sweeps_run == 0
                    and stats["total"] == 0):
        # the padded problem's mean denominators count phantoms, and the
        # trusted 0-sweep exit returned the carried RANKING score (with the
        # stickiness bonus): report the plain objective of the real rows
        soft = soft_score_host(pt, assignment)
    timings["verify_repair_ms"] = (t() - t_verify) * 1e3
    if resident is not None:
        # the sub-solve's mirror and frozen-base precondition; a host
        # repair already refreshed the mirror through adopt_host
        resident.note_host_assignment(
            padded=None if moves else padded_host,
            feasible=stats["total"] == 0)
    timings["total_ms"] = (t() - t_start) * 1e3

    telemetry = None
    if trace_blocks > 0 and adaptive:
        rows = scalars[10:].reshape(-1, 4) if blocks else np.zeros((0, 4))
        telemetry = {
            "schema": list(TRACE_COLS),
            "blocks": [[round(float(x), 6) for x in (end, temp, *row)]
                       for (end, temp, _), row in zip(blocks, rows)],
            "trace_blocks": trace_blocks,
            "init": {"violations": float(scalars[8]),
                     "soft": round(float(scalars[9]), 6)},
            "prerepair_moves": prerepair_h,
            "exit_sweep": int(sweeps_run),
            "path": ("subsolve" if sub_info is not None
                     and sub_info["outcome"] == "localized" else "full"),
        }
        if sub_info is not None:
            telemetry["subsolve"] = dict(sub_info)
    res = SolveResult(
        assignment=assignment, stats=stats, soft=soft,
        feasible=stats["total"] == 0, moves_repaired=moves,
        pre_repair_violations=pre_repair, timings_ms=timings,
        chains=chains, steps=int(sweeps_run), proposals_per_step=M,
        accepted_moves=accepted_h if adaptive else -1,
        fused_prerepair=fused, telemetry=telemetry,
        warm_h2d_copies=uploads if resident_warm else 0, device=str(dev),
        bucket=binfo.to_dict() if binfo is not None else None,
        subsolve=sub_info)
    record_solve(res, pt, steps=steps, warm=warm,
                 resident_warm=resident_warm,
                 bucket_hit=binfo.hit if binfo is not None else None,
                 compiles=int(_M_COMPILES.value() - compiles0))
    return res
