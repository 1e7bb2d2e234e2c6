"""Tenant multiplexer: same-tier warm solves in ONE dispatch (port of
``solver/multiplex.py``).

Production means thousands of independent stages, not one big one, and the
tier ladder (solver/buckets.py) already gives same-tier stages identical
padded shapes. This module stacks K same-tier resident-warm stagings on a
leading lane axis (``stack_problems``) and runs the warm refine of all K
lanes at once (``api._refine_lanes``, the reference's vmapped
``_mux_refine``): one K3 rebuild, one K2 pre-repair, one K1 launch a sweep
and one host sync a block for every lane, then one fetch for all the
lanes' host decisions:

    K x (dispatch + fetch + host gate)   ->   1 x (all of it)

Per-lane semantics are unchanged: each lane draws from its own generator in
the solo order, exits on its own (an exited lane stays frozen, as vmap
masks a finished while_loop lane) and keeps its own gate, stats and
telemetry, so a lane's result is bit-identical to a solo resident-warm
solve of the stage with the same seed (``FLEET_SUBSOLVE=0``; the
multiplexer runs no sub-solve).

K is rounded up on a power-of-two ladder (``mux_k``) as in the reference: a
batch of 5 runs as 8 lanes, the padding replicating lane 0. A padded lane
runs the batched prologue but never sweeps, and its result is discarded.
Entries that cannot batch (singleton tier groups, stagings with no adopted
assignment) go through the serial ``api.solve`` path with identical
results.

The reference's census rides the port's metrics registry:
``fleet_solver_mux_batches_total{k}``, ``fleet_solver_mux_lanes_total{kind}``
and ``fleet_solver_mux_stack_ms``; each lane counts as a warm solve in the
solver's families, writes its telemetry as a ``solve.trace`` record when
FLEET_TRACE_FILE is set, and every batch logs one ``mux …`` INFO line.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import _ext
from ..device import resolve_device
from ..lower.tensors import ProblemTensors
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from .anneal import TRACE_COLS, backend_proposals_per_step, solve_trace_blocks
from .api import DEFAULT_STEPS, SolveResult, _refine_lanes, count_solve, solve
from .buckets import BucketInfo
from .kernels import STAT_KEYS, soft_score
from .problem import TENSOR_FIELDS, TorchProblem
from .repair import RepairResult, repair, soft_score_host, verify
from .resident import ResidentProblem

__all__ = ["MuxEntry", "solve_multiplexed", "mux_k", "stack_problems",
           "MUX_LADDER_MAX", "MUX_RANGE"]

log = get_logger("solver.mux")

_M_MUX_BATCHES = REGISTRY.counter(
    "fleet_solver_mux_batches_total",
    "Batched multiplexer dispatches by ladder lane count", labels=("k",))
_M_MUX_LANES = REGISTRY.counter(
    "fleet_solver_mux_lanes_total",
    "Multiplexer lanes by kind (stage = real stage solved in a batch, "
    "pad = ladder-padding replica, serial = mux-ineligible fallback)",
    labels=("kind",))
_M_MUX_STACK_MS = REGISTRY.gauge(
    "fleet_solver_mux_stack_ms",
    "Host+device time spent stacking the most recent mux batch")

# default ceiling of the lane ladder; FLEET_MUX_MAX overrides (the
# kernels' by-value lane struct holds at most this many lanes)
MUX_LADDER_MAX = _ext.MAX_LANES
# the torch.profiler range around the batched warm dispatch, in which the
# card must make no host-to-device copy
MUX_RANGE = "fleet.mux"


def _ladder_max() -> int:
    try:
        cap = int(os.environ.get("FLEET_MUX_MAX") or MUX_LADDER_MAX)
    except ValueError:
        return MUX_LADDER_MAX
    return max(1, min(cap, MUX_LADDER_MAX))


def mux_k(k: int, *, maximum: Optional[int] = None) -> int:
    """Round a lane count up to the power-of-two ladder (2, 4, 8, ...,
    FLEET_MUX_MAX)."""
    cap = _ladder_max() if maximum is None else maximum
    if k <= 1:
        return 1
    p = 2
    while p < k and p < cap:
        p *= 2
    return min(p, cap)


@dataclass
class MuxEntry:
    """One stage's slice of a batched solve: its problem tensors, its
    resident staging (problem and committed assignment on the card) and
    its solve scalars, exactly what the serial resident-warm ``solve()``
    call would take."""
    pt: ProblemTensors
    resident: ResidentProblem
    seed: int = 0
    t0: float = 1.0
    t1: float = 1e-3
    migration_weight: float = 0.5
    stage: Optional[str] = None     # the caller's stage key


def _tier(prob: TorchProblem) -> tuple:
    """What lanes of one stack must share: the statics (S, N, G, Gc, T,
    strategy, max_skew, packed or dense, preference plane or not), the
    device, and every tensor's shape and dtype (the conflict and coloc
    widths among them)."""
    statics = (prob.S, prob.N, prob.G, prob.Gc, prob.T, prob.strategy,
               prob.max_skew, prob.eligible_packed,
               prob.preferred is not None, str(prob.device))
    shapes = tuple(None if t is None else (tuple(t.shape), str(t.dtype))
                   for t in prob.tensors())
    return statics, shapes


def stack_problems(probs: list[TorchProblem]) -> TorchProblem:
    """Stack same-tier problems on a new leading lane axis (a copy on the
    device, no host transfer). The per-lane n_real and sticky_w become
    tuples. Raises ValueError when the lanes' tiers differ."""
    if not 1 <= len(probs) <= MUX_LADDER_MAX:
        raise ValueError(f"stack_problems: {len(probs)} lanes, the kernels "
                         f"take 1 to {MUX_LADDER_MAX}")
    if any(p.lanes for p in probs):
        raise ValueError("stack_problems: a problem is already lane-stacked")
    tier = _tier(probs[0])
    for p in probs[1:]:
        if _tier(p) != tier:
            raise ValueError(f"stack_problems: mismatched tiers "
                             f"{_tier(p)[0]} and {tier[0]}")
    first = probs[0]
    planes = {name: None if t is None
              else torch.stack([getattr(p, name) for p in probs])
              for name, t in zip(TENSOR_FIELDS, first.tensors())}
    return dataclasses.replace(
        first, **planes, lanes=len(probs),
        n_real=tuple(p.real_rows for p in probs),
        sticky_w=(None if first.sticky_prev is None
                  else tuple(float(p.sticky_w) for p in probs)))


def _eligible(e: MuxEntry) -> bool:
    return e.resident.prob is not None and e.resident.assignment is not None


def _tier_key(e: MuxEntry) -> tuple:
    """Group key: the staging's tier and whether the solve is sticky (the
    per-lane scalars n_real, sticky_w, t0 and t1 may differ)."""
    return _tier(e.resident.prob), bool(e.migration_weight > 0)


def solve_multiplexed(entries: list[MuxEntry], *,
                      chains: Optional[int] = None,
                      steps: int = DEFAULT_STEPS, anneal_block: int = 1,
                      warm_block: int = 1, do_repair: bool = True,
                      device=None) -> list[SolveResult]:
    """Solve a set of resident-warm stages, batching same-tier groups into
    single dispatches of at most FLEET_MUX_MAX lanes. Returns one
    SolveResult per entry, in entry order. Entries that cannot batch run
    the serial resident-warm ``solve`` path, with the same results.
    Every solve here is warm, so the adaptive exit is checked every
    min(`warm_block`, `anneal_block`) sweeps, batched or serial.
    `do_repair=False` turns off the host repair backstop of every lane,
    batched or serial, as :func:`solve`'s does. `device` is the card
    unless the caller names the CPU (raises without CUDA); every entry's
    staging must lie on it."""
    dev = resolve_device(device)
    for e in entries:
        if e.resident.device != dev:
            raise ValueError(f"stage {e.stage!r} is staged on "
                             f"{e.resident.device}, not {dev}")
    if chains is None:
        chains = 1 if dev.type == "cpu" else 2

    results: list[Optional[SolveResult]] = [None] * len(entries)
    groups: dict = {}
    serial: list[int] = []
    for i, e in enumerate(entries):
        if _eligible(e):
            groups.setdefault(_tier_key(e), []).append(i)
        else:
            serial.append(i)

    cap = _ladder_max()
    for idxs in groups.values():
        if len(idxs) < 2:
            serial.extend(idxs)
            continue
        for at in range(0, len(idxs), cap):
            _solve_batch(entries, idxs[at:at + cap], results, chains=chains,
                         steps=steps, block=min(warm_block, anneal_block),
                         do_repair=do_repair)

    for i in serial:
        e = entries[i]
        _M_MUX_LANES.inc(kind="serial")
        results[i] = solve(
            e.pt, prob=e.resident.prob, chains=chains, steps=steps,
            seed=e.seed, do_repair=do_repair, t0=e.t0, t1=e.t1,
            migration_weight=e.migration_weight, anneal_block=anneal_block,
            warm_block=warm_block, bucket=e.resident.bucket,
            resident=e.resident, resident_warm=_eligible(e))
    return results  # type: ignore[return-value]


def _solve_batch(entries: list[MuxEntry], idxs: list[int], results: list,
                 *, chains: int, steps: int, block: int,
                 do_repair: bool = True) -> None:
    t = time.perf_counter
    t_start = t()
    compiles0 = _ext.M_COMPILE_EVENTS.value()
    lanes = [entries[i] for i in idxs]
    K = len(lanes)
    Kp = mux_k(K)

    # staging: everything that touches the host happens before the
    # dispatch range opens. Ladder padding replicates lane 0.
    def lane_at(j: int) -> MuxEntry:
        return lanes[j] if j < K else lanes[0]

    probs = [lane_at(j).resident.prob for j in range(Kp)]
    stacked = stack_problems(probs)
    seeds = torch.stack([lane_at(j).resident.assignment for j in range(Kp)])
    dev = seeds.device
    gens = []
    for j in range(Kp):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(lane_at(j).seed))
        gens.append(gen)
    # a warm start refines, it does not re-scramble: t0 <= 0.1, as solo
    scal = [(min(lane_at(j).t0, 0.1), lane_at(j).t1,
             lane_at(j).migration_weight) for j in range(Kp)]
    delta_ms = [e.resident.consume_delta_ms() for e in lanes]
    prob0 = probs[0]
    warm = bool(lanes[0].migration_weight > 0)
    M = backend_proposals_per_step(prob0.S, dev)
    trace_blocks = solve_trace_blocks()
    stack_ms = (t() - t_start) * 1e3
    _M_MUX_STACK_MS.set(stack_ms)

    t_anneal = t()
    h2d0 = sum(e.resident.h2d_copies for e in lanes)
    with torch.profiler.record_function(MUX_RANGE):
        winners, dstats, dsoft, sweeps, accepted, telems = _refine_lanes(
            stacked, seeds, gens, [s[0] for s in scal], [s[1] for s in scal],
            [s[2] for s in scal], chains=chains, steps=steps, warm=warm,
            anneal_block=block, proposals_per_step=M,
            fused_prerepair=True, prerepair_moves=max(16, min(prob0.S, 256)),
            skip_feasible_polish=True, trace_blocks=trace_blocks,
            live=[j < K for j in range(Kp)])
    uploads = sum(e.resident.h2d_copies for e in lanes) - h2d0
    # each lane's padded winner stays on the card as its next warm seed:
    # an owned copy, never a view of the stacked winners
    for j in range(K):
        lanes[j].resident.adopt(winners[j].clone())
    # ONE fetch of every lane's scalars and telemetry, one of the winners
    per_lane = [[dstats[k][j] for k in STAT_KEYS]
                + [dsoft[j], accepted[j], telems[j]["prerepair_moves"],
                   telems[j]["init_violations"], telems[j]["init_soft"]]
                for j in range(K)]
    n_scalars = len(per_lane[0])
    rows = [row for j in range(K) for _e, _t, dev_row in telems[j]["blocks"]
            for row in dev_row]
    scalars = torch.stack([x.to(torch.float32) for lane in per_lane
                           for x in lane] + rows).cpu().numpy().astype(
                               np.float64)
    host_win = np.array(winners[:K].cpu().numpy(), dtype=np.int32, copy=True)
    anneal_ms = (t() - t_anneal) * 1e3

    _M_MUX_BATCHES.inc(k=str(Kp))
    _M_MUX_LANES.inc(K, kind="stage")
    if Kp > K:
        _M_MUX_LANES.inc(Kp - K, kind="pad")

    at = K * n_scalars
    for j, e in enumerate(lanes):
        rp = e.resident
        prob = rp.prob
        sc = scalars[j * n_scalars:(j + 1) * n_scalars]
        t_verify = t()
        padded_host = host_win[j]
        bucketed = prob.S != e.pt.S
        # phantom placements never leave the solver
        assignment = padded_host[:e.pt.S] if bucketed else padded_host
        dstats_h = dict(zip(STAT_KEYS, sc[:5]))
        soft = float(sc[5])
        moves = 0
        pre_repair = 0
        if dstats_h["total"] == 0:
            stats = {k: int(v) for k, v in dstats_h.items()}
        else:
            # the lane's exact gate rejected it: verify on the host ground
            # truth, repair backstop, warm re-upload, as the solo path
            stats = verify(e.pt, assignment)
            pre_repair = int(stats["total"])
            if do_repair and stats["total"] > 0:
                rr: RepairResult = repair(e.pt, assignment)
                assignment, stats, moves = rr.assignment, rr.stats, rr.moves
                if moves:
                    rp.adopt_host(assignment, e.pt.node_valid, warm=True)
                if not bucketed:
                    soft = float(soft_score(prob, torch.tensor(
                        assignment, device=dev)))
        if bucketed or (sweeps[j] == 0 and stats["total"] == 0):
            # the padded problem's mean denominators count phantoms, and a
            # 0-sweep exit returned the carried ranking score (with the
            # stickiness bonus): report the plain objective of the real rows
            soft = soft_score_host(e.pt, assignment)
        rp.note_host_assignment(padded=None if moves else padded_host,
                                feasible=stats["total"] == 0)
        telemetry = None
        n_rows = len(telems[j]["blocks"])
        if trace_blocks > 0:
            blk = scalars[at:at + 4 * n_rows].reshape(-1, 4)
            at += 4 * n_rows
            telemetry = {
                "schema": list(TRACE_COLS),
                "blocks": [[round(float(x), 6) for x in (end, temp, *row)]
                           for (end, temp, _), row
                           in zip(telems[j]["blocks"], blk)],
                "trace_blocks": trace_blocks,
                "init": {"violations": float(sc[8]),
                         "soft": round(float(sc[9]), 6)},
                "prerepair_moves": int(sc[7]),
                "exit_sweep": int(sweeps[j]),
                "path": "mux",
                "mux": {"k": Kp, "lane": j},
            }
        verify_ms = (t() - t_verify) * 1e3
        binfo = (BucketInfo(orig_S=e.pt.S, padded_S=prob.S, G=prob.G,
                            Gc=prob.Gc) if rp.bucket else None)
        res = results[idxs[j]] = SolveResult(
            assignment=assignment, stats=stats, soft=soft,
            feasible=stats["total"] == 0, moves_repaired=moves,
            pre_repair_violations=pre_repair,
            timings_ms={"delta_stage_ms": delta_ms[j],
                        "mux_stack_ms": stack_ms, "anneal_ms": anneal_ms,
                        "verify_repair_ms": verify_ms,
                        "total_ms": (t() - t_start) * 1e3,
                        "mux_k": float(Kp), "mux_lane": float(j)},
            chains=chains, steps=int(sweeps[j]), proposals_per_step=M,
            accepted_moves=int(sc[6]), fused_prerepair=True,
            telemetry=telemetry, warm_h2d_copies=uploads, device=str(dev),
            bucket=binfo.to_dict() if binfo is not None else None)
        count_solve(res, e.pt, warm=True, resident_warm=True, lane=True)
    if log.isEnabledFor(logging.INFO):
        log.info("mux %s", kv(k=Kp, stages=K, tier=f"{prob0.S}x{prob0.N}",
                              compiles=int(_ext.M_COMPILE_EVENTS.value()
                                           - compiles0) or None,
                              ms=f"{anneal_ms:.1f}"))
