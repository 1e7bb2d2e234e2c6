"""GPU solver scheduler (port of ``sched/tpu.py::TpuSolverScheduler``).

Owns the device-resident fleet state (solver/resident.py), one slot per
stage: the staged problem and the last committed assignment stay on the
card across re-solves, and churn arrives as a ``ProblemDelta`` merged in
place. A warm ``reschedule`` therefore uploads only the small node planes
and the changed rows. Content drift a delta cannot express (a relowered
fleet, new conflict ids, a changed shape) falls back to a cold staging that
still warm-starts from the stage's last host assignment, row by row name
where the rows changed (a registry re-aggregation adds, drops and
renumbers rows).

Staging is bucketed by default (``bucket=None`` means on, as in the
reference's scheduler; FLEET_BUCKET=0 turns it off everywhere): the
resident problem is padded onto its tier ladder with phantom rows, so
arrivals inside the tier ride the delta path, and each warm reschedule
tries the churn-localized sub-solve first (solver/subsolve.py).

The slots live under a SLOT MANAGER with a device-memory byte budget
(``resident_bytes=``, FLEET_RESIDENT_BYTES, default 256 MiB) and a count
bound (FLEET_RESIDENT_STAGES, default 8): admitting a slot at the MRU head
evicts least-recently-used slots until both hold, counting
``ResidentProblem.device_nbytes``. The admitted slot is never its own
victim, so a stage larger than the budget still solves, and a
``place_many`` call evicts nothing until its solves are done (it may hold
more than the bounds for that long). Eviction frees the
slot's card memory and keeps a host snapshot of its committed padded
assignment (``eviction_snapshot``, the sub-solve mirror: no device read);
a later warm request for the stage re-admits it from the snapshot through
``adopt_host`` and runs the resident-warm solve, bit-identical to a slot
that was never evicted.

The slot manager's census rides the port's metrics registry under the
reference's families: evictions, warm re-admissions, resident bytes and
slots, and the bytes drift (refreshed by ``byte_drift``); every placement
is folded into the placement families (``base.record_placement``).

``place_many`` is the tenant-multiplexer entry (solver/multiplex.py):
same-tier resident-warm stages batch into ONE dispatch, the rest solve
serially, with the same results.

Above the sharded route's threshold (solver/sharded.sharded_route) a
stage's slot holds a ``ShardedResident`` and solves through
``solve_sharded``; slot matching keys on the mesh, so a routing flip
never hands a sharded staging to the single-device solve or back.

``GpuSolverScheduler(mesh=parallel.chain_mesh())`` spreads every solve's
chains over the ranks of a process group (``solve(mesh=)``; every rank
runs the same scheduler calls and gets the same placements): the sharded
route is then off, and the mesh's stages solve one by one, never batched
into the multiplexer.

The scheduler runs on the card: ``GpuSolverScheduler()`` raises when CUDA
is absent, and the CPU is used only when the caller passes device="cpu".
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..lower.tensors import ProblemTensors
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from ..solver.api import SolveResult, solve
from ..solver.repair import _group_counts, _unified_ids, repair, verify
from ..solver.multiplex import MuxEntry, solve_multiplexed
from ..solver.resident import ProblemDelta, ResidentProblem
from ..solver.sharded import ShardedResident, sharded_route, solve_sharded
from .base import Placement, level_schedule, record_placement

__all__ = ["GpuSolverScheduler", "seed_by_name", "slot_limits"]

log = get_logger("sched.gpu")

_M_EVICTIONS = REGISTRY.counter(
    "fleet_sched_slot_evictions_total",
    "Resident slots evicted by the device-memory slot manager")
_M_READMITS = REGISTRY.counter(
    "fleet_sched_slot_readmissions_total",
    "Evicted stages re-admitted warm from their host snapshot")
_M_RES_BYTES = REGISTRY.gauge(
    "fleet_sched_resident_bytes",
    "Device bytes held by resident stage slots (packed-plane accounting)")
_M_RES_SLOTS = REGISTRY.gauge(
    "fleet_sched_resident_slots", "Resident stage slots currently held")
_M_RES_DRIFT = REGISTRY.gauge(
    "fleet_solver_resident_bytes_drift",
    "Live device bytes of resident slots minus the slot manager's "
    "admission-time accounting — nonzero drift means a slot's buffers "
    "grew or shrank after admission (refreshed by slots_status / the "
    "obs collector's cross-check)")

# the default device budget of the resident slots: roomy on a card, and
# far above what test-scale problems allocate
_DEFAULT_BUDGET = 256 << 20


@dataclass
class _StageSlot:
    """Per-stage resident state: the control plane drives every stage
    through one scheduler, so resident reuse is per stage."""
    resident: ResidentProblem
    last_assignment: Optional[np.ndarray] = None   # host warm seed for cold fallback
    last_names: Optional[tuple] = None             # its (service, node) names
    key: Optional[str] = None                      # the caller's stage key
    nbytes: int = 0                                # device bytes at admission
    last_used: float = 0.0                         # monotonic stamp (LRU)


@dataclass
class _EvictRecord:
    """What eviction keeps: the committed padded assignment (the host
    mirror, so the snapshot costs no device read) and what re-admission
    checks it against."""
    assignment: np.ndarray
    feasible: bool
    S: int                                         # real (unpadded) rows
    evictions: int = 1                             # times this key was evicted
    host_seed: Optional[np.ndarray] = field(default=None)
    host_names: Optional[tuple] = None


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name) or default))
    except ValueError:
        return default


def seed_by_name(pt: ProblemTensors, assignment: np.ndarray,
                 service_names, node_names) -> np.ndarray:
    """A warm seed for `pt` from the assignment of an earlier lowering whose
    rows and nodes were `service_names` and `node_names`: each row on the
    node its name had. A row the old lowering lacks (or whose node `pt`
    lacks) is placed as the fused pre-repair places a stranded row: on the
    least-utilised valid eligible node where it fits without a conflict,
    else the least-utilised eligible one. What the new lowering leaves in
    violation where the rows kept their nodes (a changed row's port or
    demand) goes through the host repair, which moves only rows on the
    violating nodes where a clean node exists; the warm solve's exact gate
    then decides."""
    node_idx = {n: j for j, n in enumerate(pt.node_names)}
    remap = np.array([node_idx.get(n, -1) for n in node_names],
                     dtype=np.int32)
    old_row = {n: i for i, n in enumerate(service_names)}
    rows = np.fromiter((old_row.get(n, -1) for n in pt.service_names),
                       dtype=np.int64, count=pt.S)
    seed = np.full(pt.S, -1, dtype=np.int32)
    named = rows >= 0
    seed[named] = remap[np.asarray(assignment)[rows[named]]]
    todo = np.flatnonzero(seed < 0)
    placed = seed >= 0
    demand = pt.demand.astype(np.float64)
    cap = pt.capacity.astype(np.float64)
    load = np.zeros_like(cap)
    np.add.at(load, seed[placed], demand[placed])
    ids = _unified_ids(pt)
    G = int(ids.max(initial=-1)) + 1
    used = _group_counts(seed[placed], ids[placed], pt.N, max(G, 1))
    for s in todo:
        own = ids[s][ids[s] >= 0]
        ok = ((load + demand[s] <= cap * (1 + 1e-6)).all(1)
              & (used[:, own].sum(1) == 0))
        elig = pt.eligible[s] & pt.node_valid
        util = (load / np.maximum(cap, 1e-6)).max(1)
        score = np.where(ok & elig, util, np.where(elig, util + 1e6, np.inf))
        j = int(np.argmin(score))
        if not np.isfinite(score[j]):
            j = int(np.argmax(pt.node_valid))
        seed[s] = j
        load[j] += demand[s]
        used[j, own] += 1
    if verify(pt, seed)["total"]:
        seed = repair(pt, seed).assignment.astype(np.int32)
    return seed


def _same_names(a, b) -> bool:
    return a is b or list(a) == list(b)


def slot_limits() -> tuple[int, int]:
    """(max_slots, budget_bytes) a scheduler built now takes by default:
    FLEET_RESIDENT_STAGES and FLEET_RESIDENT_BYTES, else 8 and 256 MiB."""
    return (_env_int("FLEET_RESIDENT_STAGES", 8),
            _env_int("FLEET_RESIDENT_BYTES", _DEFAULT_BUDGET))


class GpuSolverScheduler:
    def __init__(self, *, chains: Optional[int] = None, steps: int = 128,
                 seed: int = 0, device=None, bucket: Optional[bool] = None,
                 resident_bytes: Optional[int] = None, mesh=None):
        # device=None is the card (the mesh's rank device with a mesh) and
        # raises without CUDA (no fallback)
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self.chains = chains
        self.steps = steps
        self.seed = seed
        # None -> ON for the scheduler (the churn path bucketing exists
        # for); False, or FLEET_BUCKET=0, stages exact shapes
        self.bucket = bucket
        # slot manager: MRU-ordered slots, byte- and count-bounded; evicted
        # stages keep a host snapshot for a warm re-admission
        self._slots: list[_StageSlot] = []
        self._evicted: dict[str, _EvictRecord] = {}
        self._max_slots, default_budget = slot_limits()
        self._budget_bytes = int(default_budget if resident_bytes is None
                                 else resident_bytes)
        # bounded: a control plane churning through unbounded stage keys
        # must not grow host memory forever
        self._max_evicted = max(4 * self._max_slots, 64)
        # set while a place_many call stages and solves: eviction waits
        # until its solves are done
        self._holding = False
        self.last_result: Optional[SolveResult] = None

    # -- slot manager ------------------------------------------------------

    def _resident_bytes(self) -> int:
        return sum(s.nbytes for s in self._slots)

    def _evict(self, slot: _StageSlot) -> None:
        """Free a slot's device state, keeping the host snapshot of its
        committed assignment so re-admission warm-seeds. A keyless slot
        evicts without a record (no identity to re-admit under)."""
        snap = slot.resident.eviction_snapshot()
        if slot.key is not None:
            prev = self._evicted.pop(slot.key, None)
            count = prev.evictions + 1 if prev is not None else 1
            if snap is not None:
                self._evicted[slot.key] = _EvictRecord(
                    assignment=snap[0], feasible=snap[1],
                    S=slot.resident.prob.real_rows, evictions=count,
                    host_seed=slot.last_assignment,
                    host_names=slot.last_names)
            elif slot.last_assignment is not None:
                # nothing committed on the card yet: keep the host seed so
                # the fallback warm start survives eviction too
                self._evicted[slot.key] = _EvictRecord(
                    assignment=np.empty(0, np.int32), feasible=False,
                    S=int(slot.last_assignment.shape[0]), evictions=count,
                    host_seed=slot.last_assignment,
                    host_names=slot.last_names)
            if len(self._evicted) > self._max_evicted:
                # the oldest record falls off (dicts keep insertion order)
                self._evicted.pop(next(iter(self._evicted)))
        slot.resident.release()
        _M_EVICTIONS.inc()
        log.debug("slot-evict %s", kv(stage=slot.key, bytes=slot.nbytes,
                                      snapshot=snap is not None))

    def _admit(self, slot: _StageSlot) -> None:
        """Insert a slot at the MRU head, then evict from the LRU tail
        until the byte budget and the count bound hold. The admitted slot
        is never evicted, so a full budget cannot deadlock admission."""
        slot.nbytes = slot.resident.device_nbytes()
        slot.last_used = time.monotonic()
        self._slots.insert(0, slot)
        self._trim()

    def _trim(self) -> None:
        """Evict from the LRU tail until the bounds hold, never the MRU
        head, and nothing while a place_many call holds its stagings (a
        slot it staged must still solve, and evicting one it is about to
        stage would only re-admit it)."""
        while not self._holding and len(self._slots) > 1 and (
                len(self._slots) > self._max_slots
                or self._resident_bytes() > self._budget_bytes):
            self._evict(self._slots.pop())
        _M_RES_BYTES.set(self._resident_bytes())
        _M_RES_SLOTS.set(len(self._slots))

    def byte_drift(self) -> int:
        """Live device bytes of the resident slots minus the bytes the
        manager accounted at admission: nonzero means a slot's buffers
        changed size after admission, which the budget cannot see. A walk
        of tensor shapes, no device sync."""
        drift = sum(s.resident.device_nbytes() - s.nbytes
                    for s in self._slots)
        _M_RES_DRIFT.set(drift)
        return drift

    def slots_status(self) -> dict:
        """Occupancy: per slot its stage key, tier, bytes, idle seconds,
        eviction count and whether it is warm, the evicted stages, and the
        manager's budget and totals."""
        now = time.monotonic()
        slots = []
        for s in self._slots:
            prob = s.resident.prob
            rec = self._evicted.get(s.key) if s.key is not None else None
            slots.append({
                "stage": s.key or "-", "tier": f"{prob.S}x{prob.N}",
                "bytes": int(s.nbytes),
                "idle_s": round(max(0.0, now - s.last_used), 3),
                "evictions": rec.evictions if rec is not None else 0,
                "warm": s.resident.assignment is not None,
            })
        parked = [{"stage": k, "evictions": rec.evictions, "S": rec.S,
                   "snapshot": bool(rec.assignment.size)}
                  for k, rec in self._evicted.items()]
        return {
            "budget_bytes": self._budget_bytes,
            "max_slots": self._max_slots,
            "resident_bytes": self._resident_bytes(),
            "bytes_drift": self.byte_drift(),
            "slots": slots,
            "evicted": parked,
        }

    def _stage(self, pt: ProblemTensors, delta: Optional[ProblemDelta],
               warm: bool, stage: Optional[str] = None, mesh=None):
        """DELTA (in-place merge into the resident state) when a resident
        slot on `mesh` (None: no mesh) is compatible with `pt`, else COLD
        (full staging, a ShardedResident on a mesh), re-admitted warm from
        an eviction snapshot when this stage has one. Returns (slot,
        resident_warm)."""
        # warm delta reuse: the slot whose staging matches this pt
        # (compatible() pins the untouched tensors by identity, so only
        # this stage's own slot can match)
        if warm:
            for i, slot in enumerate(self._slots):
                rp = slot.resident
                if rp.mesh != mesh:
                    continue
                if rp.assignment is not None and rp.compatible(pt, delta):
                    self._slots.insert(0, self._slots.pop(i))
                    slot.last_used = time.monotonic()
                    if stage is not None:
                        slot.key = stage
                    if delta is not None:
                        rp.apply_delta(pt, delta)
                    elif rp.pt is not pt or rp.drifted(pt):
                        # in-place mutation of pt.node_valid / capacity: the
                        # delta is implicit
                        rp.apply_delta(pt, ProblemDelta())
                    return slot, True

        # cold (re)staging: reclaim this stage's old slot, so its host
        # assignment can still warm-seed the fallback and the pool keeps one
        # slot per stage. A stage key is authoritative (two stages can carry
        # identical service names); without one, a keyless slot of the same
        # shape and service names is this stage
        slot = None
        if stage is not None:
            slot = next((self._slots.pop(i) for i, cand
                         in enumerate(self._slots) if cand.key == stage), None)
        if slot is None:
            for i, cand in enumerate(self._slots):
                old = cand.resident.pt
                if (cand.key is None and old.S == pt.S and old.N == pt.N
                        and (old.service_names is pt.service_names
                             or old.service_names == pt.service_names)):
                    slot = self._slots.pop(i)
                    break
        if slot is not None:
            if warm and slot.resident.assignment is not None:
                # this stage had resident state but the delta contract broke
                slot.resident.record_warm_fallback()
            # the old staging's card memory goes before the new one's comes
            slot.resident.release()
        if mesh is not None:
            resident = ShardedResident(pt, mesh=mesh,
                                       bucket=self.bucket is not False)
        else:
            resident = ResidentProblem(pt, self.device,
                                       bucket=self.bucket is not False)
        if slot is None:
            slot = _StageSlot(resident=resident, key=stage)
        else:
            slot.resident = resident
            if stage is not None:
                slot.key = stage

        # re-admission: this stage was evicted with a committed snapshot
        # and its shape still matches. The padded assignment returns through
        # adopt_host (staging, not a warm transfer), and the solve runs the
        # resident-warm path as if the slot had never been evicted
        resident_warm = False
        rec = self._evicted.get(stage) if warm and stage is not None else None
        if rec is not None and slot.last_assignment is None:
            slot.last_assignment = rec.host_seed
            slot.last_names = rec.host_names
        if (rec is not None and rec.assignment.size and rec.S == pt.S
                and rec.assignment.shape[0] == resident.padded_S):
            # the phantom rows go to the first valid node of the fleet as it
            # is now, as a delta merge re-parks them: the node they sat on
            # may have died while the stage was evicted
            snap = rec.assignment.copy()
            snap[pt.S:] = int(np.argmax(pt.node_valid))
            resident.adopt_host(snap, pt.node_valid, warm=False)
            resident.note_host_assignment(padded=snap, feasible=rec.feasible)
            resident_warm = True
            _M_READMITS.inc()
            log.debug("slot-readmit %s", kv(stage=stage,
                                            evictions=rec.evictions))
        self._admit(slot)
        return slot, resident_warm

    def _solve_one(self, pt: ProblemTensors, slot: _StageSlot,
                   resident_warm: bool, init: Optional[np.ndarray],
                   overlap_host_work=None):
        # the slot's own staging decides the path (sharded or not) and
        # whether the solve is padded, not a fresh read of the environment
        rp = slot.resident
        if rp.mesh is not None:
            return solve_sharded(pt, resident=rp,
                                 resident_warm=resident_warm,
                                 init_assignment=init, steps=self.steps,
                                 seed=self.seed,
                                 overlap_host_work=overlap_host_work)
        return solve(pt, prob=rp.prob, chains=self.chains, steps=self.steps,
                     seed=self.seed, init_assignment=init, bucket=rp.bucket,
                     resident=rp, resident_warm=resident_warm, mesh=self.mesh,
                     overlap_host_work=overlap_host_work)

    def _finalize(self, pt: ProblemTensors, res: SolveResult,
                  slot: _StageSlot, ms: float) -> Placement:
        slot.last_assignment = res.assignment
        slot.last_names = (pt.service_names, pt.node_names)
        slot.last_used = time.monotonic()
        self.last_result = res
        if res.subsolve is not None and log.isEnabledFor(logging.DEBUG):
            log.debug("active-set %s", kv(
                stage=slot.key, rows=res.subsolve["rows"],
                tier=res.subsolve["tier"], outcome=res.subsolve["outcome"],
                ms=res.subsolve["ms"]))
        placement = Placement(
            assignment={pt.service_names[i]:
                        pt.node_names[int(res.assignment[i])]
                        for i in range(pt.S)},
            levels=level_schedule(pt),
            feasible=res.feasible,
            violations=res.violations,
            soft=res.soft,
            source="gpu-anneal",
            solve_ms=ms,
            raw=res.assignment,
        )
        record_placement(placement)
        return placement

    def _route(self, pt):
        """The sharded route's mesh for `pt`; none on a chain mesh (the
        caller chose to spread chains)."""
        return sharded_route(pt) if self.mesh is None else None

    @staticmethod
    def _host_seed(pt, slot, warm: bool, resident_warm: bool):
        """A cold fallback of a warm request still warm-starts from the
        stage's last host assignment: as it stands where the rows and nodes
        kept their names, else row by row name (seed_by_name)."""
        if not warm or resident_warm or slot.last_assignment is None:
            return None
        services, nodes = slot.last_names
        if (_same_names(services, pt.service_names)
                and _same_names(nodes, pt.node_names)):
            return slot.last_assignment
        return seed_by_name(pt, slot.last_assignment, services, nodes)

    def place(self, pt: ProblemTensors, *, warm_start: bool = False,
              delta: Optional[ProblemDelta] = None, overlap_host_work=None,
              stage: Optional[str] = None) -> Placement:
        """Solve `pt` on the scheduler's device. `delta` is the structured
        churn of a warm reschedule; `stage` keys the resident slot.
        `overlap_host_work` (a zero-argument callable) runs host work, such
        as re-lowering a changed fleet, while the solve is in flight on the
        card (see :func:`solve`)."""
        t0 = time.perf_counter()
        slot, resident_warm = self._stage(pt, delta, warm_start, stage,
                                          mesh=self._route(pt))
        res = self._solve_one(pt, slot, resident_warm,
                              self._host_seed(pt, slot, warm_start,
                                              resident_warm),
                              overlap_host_work=overlap_host_work)
        return self._finalize(pt, res, slot, (time.perf_counter() - t0) * 1e3)

    def place_many(self, requests: list[dict]) -> list[Placement]:
        """Batched placement across stages, the tenant-multiplexer entry.
        Each request is a dict with keys `pt` (required), `delta`,
        `warm_start` and `stage`. Every request stages through the slot
        manager first, which evicts nothing until the call's solves are
        done; the resident-warm stages then batch same-tier into
        ONE dispatch (solver/multiplex.py) and the rest solve serially.
        Results come back in request order, each what a solo `place()`
        would have produced."""
        t0 = time.perf_counter()
        staged = []
        self._holding = True
        try:
            for req in requests:
                warm = bool(req.get("warm_start"))
                slot, resident_warm = self._stage(
                    req["pt"], req.get("delta"), warm, req.get("stage"),
                    mesh=self._route(req["pt"]))
                staged.append((req["pt"], slot, resident_warm, warm))
            placements = self._solve_staged(requests, staged, t0)
        finally:
            # the slots exceed the bounds only while the call runs: the LRU
            # ones go now, each with the snapshot of what it committed
            self._holding = False
            self._trim()
        return placements

    def _solve_staged(self, requests: list[dict], staged: list,
                      t0: float) -> list[Placement]:
        results: list = [None] * len(staged)
        # the resident-warm stages without a mesh batch; sharded ones and
        # those on a chain mesh solve alone
        mux_idx = [i for i, (_pt, s, rw, _w) in enumerate(staged)
                   if rw and s.resident.mesh is None and self.mesh is None]
        if len(mux_idx) >= 2:
            entries = [MuxEntry(pt=staged[i][0],
                                resident=staged[i][1].resident,
                                seed=self.seed,
                                stage=requests[i].get("stage"))
                       for i in mux_idx]
            batched = solve_multiplexed(entries, chains=self.chains,
                                        steps=self.steps, device=self.device)
            for i, res in zip(mux_idx, batched):
                results[i] = res
        for i, (pt, slot, resident_warm, warm) in enumerate(staged):
            if results[i] is None:
                results[i] = self._solve_one(
                    pt, slot, resident_warm,
                    self._host_seed(pt, slot, warm, resident_warm))
        ms = (time.perf_counter() - t0) * 1e3
        return [self._finalize(pt, res, slot, ms)
                for (pt, slot, _rw, _w), res in zip(staged, results)]

    def reschedule(self, pt: ProblemTensors, *,
                   delta: Optional[ProblemDelta] = None,
                   overlap_host_work=None,
                   stage: Optional[str] = None) -> Placement:
        """Warm re-solve after churn: only churn-forced moves happen, and
        with a resident slot the warm seed never leaves the device."""
        return self.place(pt, warm_start=True, delta=delta,
                          overlap_host_work=overlap_host_work, stage=stage)
