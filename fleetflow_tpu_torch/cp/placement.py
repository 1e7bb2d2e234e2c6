"""Placement service: the CP's solver front-end + reservation journal
(the port's copy of ``fleetflow_tpu/cp/placement.py``).

This is the component the reference lacks (its CP picks
`stage.servers.first`, handlers/deploy.rs:386-398, with fan-out "future
work"). Here the CP lowers the fleet against its *live* server inventory
(capacity minus committed+reserved allocations, label/pool eligibility,
cordon/drain masks) and solves on the card.

The reservation journal implements the 2-phase commit the reference sketches
in `ServerAllocated` (model.rs:421-427) and solves SURVEY.md hard part (c):
a solve RESERVES its assignment; the deploy either COMMITs (moving reserved
-> committed) or RELEASEs on failure. Concurrent re-solves see reserved
capacity as occupied, so racing placements can't double-book a node.

Churn handling (BASELINE config 5): `node_event` flips the validity bit and
triggers an incremental warm-start re-solve that moves only what churn
forces (solver migration stickiness).

The device: `PlacementService(store)` solves on the card through
``GpuSolverScheduler`` and raises DeviceUnavailable when CUDA is absent;
`device="cpu"` runs the same scheduler's plain PyTorch versions, and
`use_gpu=False` asks for the host greedy path alone (no scheduler on any
device is built). A churn or admission micro-solve that fails degrades to
the host greedy, counted; a fault of the device path itself (no CUDA, a
kernel that did not build or load, a CUDA error, the card out of memory)
propagates instead.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, replace as _dc_replace
from typing import Optional

import numpy as np
import torch

from ..core.errors import DeviceUnavailable, KernelError
from ..core.model import Flow, ResourceSpec, ServerLabels, ServerResource
from ..lower.tensors import ProblemTensors, lower_stage
from ..obs import get_logger, kv
from ..obs.metrics import REGISTRY
from ..obs.slo import observe as slo_observe
from ..sched import (GpuSolverScheduler, HostGreedyScheduler, Placement,
                     level_schedule, place_with_fallback)
from ..sched.gpu import slot_limits
from ..solver.resident import ProblemDelta
from .models import PlacementRecord, Server
from .store import Store

log = get_logger("cp.placement")

# metric catalog: docs/guide/10-observability.md. Churn re-solves that had
# to abandon the device solver (exception/timeout) for the greedy host
# path — self-healing must degrade, never stall (cp/reconverge.py).
_M_CHURN_FALLBACKS = REGISTRY.counter(
    "fleet_placement_churn_fallbacks_total",
    "Churn re-solves that fell back to the greedy host scheduler after a "
    "solver failure")

__all__ = ["PlacementService", "Reservation"]

# the device path's own faults: never degraded around (a torch that
# defines AcceleratorError raises it on a CUDA error, and OutOfMemoryError,
# a RuntimeError, when the card's memory runs out)
_DEVICE_FAULTS = (DeviceUnavailable, KernelError) + tuple(
    t for t in (getattr(torch, "AcceleratorError", None),
                getattr(torch, "OutOfMemoryError", None)) if t is not None)


def _device_fault(e: BaseException) -> bool:
    """Is `e`, or an exception it was raised from or while handling, a
    fault of the device path itself? Those propagate out of the degrade
    handlers: placing on the host around a missing card or a broken kernel
    would hide the device."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, _DEVICE_FAULTS):
            return True
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return False


@dataclass
class Reservation:
    id: str
    stage_key: str                      # "{project}/{stage}"
    demand_by_node: dict[str, np.ndarray]   # node slug -> (R,) reserved demand
    assignment: dict[str, str]
    committed: bool = False
    # churn reservations hold a displaced stage's NEW nodes between the
    # burst re-solve and the redeploy that re-commits it, so an admission
    # landing in that window cannot double-book them; superseded by the
    # stage's next solve/commit/release (never committed themselves)
    churn: bool = False


def _alloc_vector(s: Server) -> np.ndarray:
    """(R,) committed+reserved demand recorded on a server record — the ONE
    definition of 'how much of this node is spoken for' (used by admission
    inventory and churn capacity refresh alike)."""
    return np.array([s.allocated.cpu + s.allocated.reserved_cpu,
                     s.allocated.memory + s.allocated.reserved_memory,
                     s.allocated.disk + s.allocated.reserved_disk],
                    dtype=np.float64)


def _server_to_resource(s: Server) -> ServerResource:
    return ServerResource(
        name=s.slug,
        capacity=ResourceSpec(cpu=s.capacity.cpu, memory=s.capacity.memory,
                              disk=s.capacity.disk),
        labels=ServerLabels(tier=s.labels.tier, region=s.labels.region,
                            clazz=s.labels.clazz, arch=s.labels.arch,
                            extra=dict(s.labels.extra)),
    )


class PlacementService:
    def __init__(self, store: Store, *, use_gpu: bool = True,
                 chains=None, steps: int = 128, device=None):
        self.store = store
        self.use_gpu = use_gpu
        # device=None is the card (raises DeviceUnavailable without CUDA);
        # the host greedy path builds no scheduler
        self._sched_gpu = (GpuSolverScheduler(chains=chains, steps=steps,
                                              device=device)
                           if use_gpu else None)
        self._sched_host = HostGreedyScheduler()
        self._lock = threading.Lock()
        self._reservations: dict[str, Reservation] = {}   # in-flight only
        self._committed: dict[str, Reservation] = {}      # stage_key -> last
        self._ids = itertools.count(1)
        self._last: dict[str, tuple[ProblemTensors, Placement]] = {}
        # streaming-admission tombstones (cp/admission.py): rows kept in
        # the problem at zero demand so the padded shape tier survives a
        # departure, but masked OUT of every public assignment view —
        # a departed service must never look placed to invariants,
        # dashboards, or deploy fan-out
        self._masked: dict[str, frozenset] = {}
        # the committed book explains servers.allocated: rebuild it from
        # the store's placements table so a restarted (or promoted
        # standby, docs/guide/13-cp-replication.md) CP's next commit
        # SUPERSEDES the old allocation instead of stacking on top of it
        self._load_committed()

    # ------------------------------------------------------------------
    # committed-book persistence (crash/failover-safe capacity ledger)
    # ------------------------------------------------------------------

    def _load_committed(self) -> None:
        for rec in self.store.list("placements"):
            self._committed[rec.stage_key] = Reservation(
                id=f"rsv_{next(self._ids)}", stage_key=rec.stage_key,
                demand_by_node={slug: np.asarray(d, dtype=np.float64)
                                for slug, d in rec.demand_by_node.items()},
                assignment=dict(rec.assignment), committed=True)

    def _persist_committed(self, key: str) -> None:
        """Mirror the stage's committed reservation into the store (one
        row per stage, journaled and replicated). Caller holds the lock."""
        r = self._committed.get(key)
        rec = self.store.find_one("placements",
                                  lambda p: p.stage_key == key)
        if r is None:
            if rec is not None:
                self.store.delete("placements", rec.id)
            return
        attrs = dict(
            assignment=dict(r.assignment),
            demand_by_node={slug: [float(x) for x in np.asarray(d)]
                            for slug, d in r.demand_by_node.items()})
        if rec is None:
            self.store.create("placements",
                              PlacementRecord(stage_key=key, **attrs))
        else:
            self.store.update("placements", rec.id, **attrs)

    # ------------------------------------------------------------------
    # inventory lowering
    # ------------------------------------------------------------------

    def _inventory(self, tenant: str,
                   slugs: Optional[list[str]] = None,
                   exclude_demand: Optional[dict[str, np.ndarray]] = None,
                   ) -> tuple[list[ServerResource], np.ndarray]:
        """Live nodes + validity mask, with reserved+committed demand
        subtracted from capacity.  `exclude_demand` (slug -> (R,)) is
        demand attributed to the CALLING stage itself (e.g. its own churn
        hold) — excluded BEFORE the zero-clamp, so a deficit against a
        shrunken node cannot turn into phantom free capacity the way a
        post-clamp add-back would."""
        # a tenant sees its own servers plus the shared "default" pool;
        # "default" solves never touch tenant-dedicated capacity
        servers = self.store.list(
            "servers", lambda s: s.tenant in (tenant, "default")
            and (not slugs or s.slug in slugs))
        if not servers:
            raise ValueError(f"no servers registered for tenant {tenant!r}")
        reserved = self._reserved_by_node()
        nodes, valid = [], []
        for s in servers:
            res = _server_to_resource(s)
            alloc = _alloc_vector(s) + reserved.get(s.slug, 0)
            if exclude_demand:
                alloc = alloc - exclude_demand.get(s.slug, 0)
            cap = np.maximum(np.array(res.capacity.as_tuple()) - alloc, 0.0)
            res.capacity = ResourceSpec(cpu=float(cap[0]), memory=float(cap[1]),
                                        disk=float(cap[2]))
            nodes.append(res)
            valid.append(s.schedulable)
        return nodes, np.array(valid, dtype=bool)

    def _reserved_by_node(self) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for r in self._reservations.values():
            if r.committed:
                continue
            for node, dem in r.demand_by_node.items():
                out[node] = out.get(node, 0) + dem
        return out

    # ------------------------------------------------------------------
    # solve + 2-phase reservation
    # ------------------------------------------------------------------

    def _apply_mask(self, key: str, placement: Placement) -> Placement:
        """Filter a stage's tombstoned (departed-but-row-retained) service
        names out of the public assignment. raw stays full-length — the
        solver's exact checker verifies every row, tombstones included."""
        mask = self._masked.get(key)
        if not mask:
            return placement
        return _dc_replace(placement, assignment={
            n: node for n, node in placement.assignment.items()
            if n not in mask})

    def solve_stage(self, flow: Flow, stage_name: str, *,
                    tenant: str = "default",
                    reserve: bool = True) -> tuple[Placement, Optional[str]]:
        """Lower the stage against live inventory and solve; optionally open
        a reservation. Returns (placement, reservation_id)."""
        stage = flow.stage(stage_name)
        key = f"{flow.name}/{stage_name}"
        with self._lock:
            # a full re-lower rebuilds the stage from the flow, which the
            # admission controller keeps tombstone-free
            self._masked.pop(key, None)
            # This stage's own churn hold is the placement this solve
            # supersedes, so it must not count against itself — but the
            # hold is only RELEASED when a real reservation replaces it
            # (_reserve): a reserve=False preview or an infeasible solve
            # must leave the double-book protection standing.
            own_churn: dict[str, np.ndarray] = {}
            for r in self._reservations.values():
                if r.churn and r.stage_key == key:
                    for slug, d in r.demand_by_node.items():
                        own_churn[slug] = own_churn.get(slug, 0) + d
            nodes, valid = self._inventory(tenant, stage.servers or None,
                                           exclude_demand=own_churn)
            # Config-declared labels back-fill: agents register slug +
            # capacity only, so live store records usually carry NO labels,
            # and a blank label passes every gate (_server_matches treats
            # tier=None as match-any, tensors.py) — a tier-gated stage
            # could silently place services on a declared-off-tier node
            # (found by the full-stack smoke: api landed on the standard
            # node).  Fill per FIELD: only fields the server API has not
            # set inherit the flow's declaration; API-set fields win.
            for n in nodes:
                decl = flow.servers.get(n.name)
                if decl is None:
                    continue
                d, got = decl.labels, n.labels
                n.labels = ServerLabels(
                    tier=got.tier if got.tier is not None else d.tier,
                    region=got.region if got.region is not None else d.region,
                    clazz=got.clazz if got.clazz is not None else d.clazz,
                    arch=got.arch if got.arch is not None else d.arch,
                    extra={**d.extra, **got.extra})
            pt = lower_stage(flow, stage_name, nodes=nodes)
            pt.node_valid &= valid
            prev = self._last.get(key)
            if self.use_gpu:
                warm = (prev is not None
                        and prev[0].S == pt.S and prev[0].N == pt.N)
                placement = self._sched_gpu.place(pt, warm_start=warm,
                                                  stage=key)
                if not placement.feasible and pt.relax_order:
                    placement, _ = place_with_fallback(
                        self._sched_gpu, pt, initial=placement,
                        place_kwargs={"stage": key})
            else:
                placement, _ = place_with_fallback(self._sched_host, pt)
            self._last[key] = (pt, placement)
            rid = None
            if reserve and placement.feasible:
                rid = self._reserve(key, pt, placement)
        return placement, rid

    def rehydrate(self, stage_key: str, flow: Flow,
                  tenant: str = "default") -> bool:
        """Failover/restart recovery: rebuild the stage's retained
        (problem, placement) entry by ADOPTING its committed assignment
        from the store's placements table — never by re-solving, which
        could silently diverge from what the fleet is actually running.
        Without this, a promoted standby's empty placement book would
        make every future churn re-solve skip the stage entirely
        (node_events only moves stages it has retained problems for).
        Returns False when there is nothing to adopt or the config has
        drifted past the record (the stage's next real solve rebuilds)."""
        rec = self.store.find_one("placements",
                                  lambda p: p.stage_key == stage_key)
        if rec is None:
            return False
        stage_name = stage_key.split("/", 1)[1]
        with self._lock:
            if stage_key in self._last:
                return True
            self._masked.pop(stage_key, None)   # flow carries no tombstones
            committed = self._committed.get(stage_key)
            # the committed demand is the stage's OWN load: exclude it
            # from inventory like solve_stage excludes its churn hold,
            # or the adopted placement double-counts itself
            exclude = dict(committed.demand_by_node) if committed else None
            nodes, valid = self._inventory(
                tenant, flow.stage(stage_name).servers or None,
                exclude_demand=exclude)
            pt = lower_stage(flow, stage_name, nodes=nodes)
            pt.node_valid &= valid
            node_idx = {n: i for i, n in enumerate(pt.node_names)}
            raw = np.zeros(pt.S, dtype=np.int64)
            for i, row in enumerate(pt.service_names):
                idx = node_idx.get(rec.assignment.get(row, ""), -1)
                if idx < 0:
                    return False   # drifted config/inventory: solve anew
                raw[i] = idx
            # the adopted rows prove their nodes were valid AT SOLVE
            # TIME: mark them valid in the retained problem even if the
            # node is offline in today's inventory, so the failure
            # detector's verdict flip registers as a CHANGE and triggers
            # the re-solve that moves the stage off the dead node
            pt.node_valid = pt.node_valid.copy()
            pt.node_valid[np.unique(raw)] = True
            self._last[stage_key] = (pt, Placement(
                assignment=dict(rec.assignment),
                levels=level_schedule(pt), feasible=True,
                source="rehydrated", raw=raw))
        log.info("placement rehydrated %s", kv(stage=stage_key,
                                               rows=pt.S))
        return True

    def admit_batch(self, stage_key: str, pt: ProblemTensors, delta=None,
                    *, tenant: str = "default", masked=None,
                    ) -> tuple[Placement, Optional[str], ProblemTensors]:
        """Streaming-admission micro-solve (cp/admission.py): solve a
        pre-built candidate problem — the stage's streaming pt with this
        batch's arrivals scattered in and departures tombstoned — warm
        through the resident delta path, and open a reservation for the
        whole batch. The candidate arrives in the delta shape
        (dataclasses.replace sharing every untouched tensor), so steady
        in-tier drift reuses ONE resident staging and never re-uploads the
        (S, N) planes.

        Unlike solve_stage, the stage's OWN standing demand (committed +
        in-flight) is excluded from capacity — its services are the ones
        being re-placed, and a stream that saw itself as load would choke
        on its own success. Returns (placement, reservation_id, pt_used);
        on an infeasible solve the retained (pt, placement) entry is left
        standing (the stage IS still feasibly placed without the batch)
        and reservation_id is None."""
        with self._lock:
            server_map = {s.slug: s for s in self.store.list("servers")}
            valid = np.array(
                [bool(server_map[slug].schedulable)
                 if slug in server_map else bool(pt.node_valid[j])
                 for j, slug in enumerate(pt.node_names)], dtype=bool)
            if not np.array_equal(valid, pt.node_valid):
                pt = _dc_replace(pt, node_valid=valid)
            pt = self._refresh_capacity(pt, stage_key,
                                        server_map=server_map)
            if delta is not None:
                # the delta always re-ships the small planes; keep them
                # coherent with the refreshed candidate
                delta.node_valid = pt.node_valid
                delta.capacity = pt.capacity
            degraded = False
            try:
                if self.use_gpu:
                    new = self._sched_gpu.reschedule(pt, delta=delta,
                                                     stage=stage_key)
                else:
                    new = self._sched_host.place(pt)
            except Exception as e:
                # same degradation contract as node_events: an admission
                # micro-solve must cost quality, not liveness — but a
                # fault of the device path itself is not degraded around
                if _device_fault(e):
                    raise
                _M_CHURN_FALLBACKS.inc()
                degraded = True
                log.error("admission solve failed; greedy host fallback %s",
                          kv(stage=stage_key, error=e))
                new = self._sched_host.place(pt)
            if not new.feasible and pt.relax_order:
                sched = (self._sched_host if degraded or not self.use_gpu
                         else self._sched_gpu)
                new, _ = place_with_fallback(
                    sched, pt, initial=new,
                    place_kwargs=({"stage": stage_key}
                                  if sched is self._sched_gpu else None))
            if not new.feasible:
                return self._apply_mask(stage_key, new), None, pt
            self._masked[stage_key] = frozenset(masked or ())
            new = self._apply_mask(stage_key, new)
            self._last[stage_key] = (pt, new)
            rid = self._reserve(stage_key, pt, new)
        return new, rid, pt

    @staticmethod
    def _demand_by_node(pt: ProblemTensors,
                        placement: Placement) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for i, node in enumerate(placement.raw):
            dem = pt.demand[i]
            if not dem.any():
                continue    # zero-demand rows (admission tombstones)
                            # must not materialize per-node entries
            slug = pt.node_names[int(node)]
            out[slug] = out.get(slug, 0) + dem.astype(np.float64)
        return out

    def _drop_churn(self, key: str) -> None:
        """A stage's newly-created reservation (_reserve), a fresh
        commitment, or its teardown supersedes any churn reservation still
        holding its displaced placement.  Preview solves do NOT drop it —
        they add it back to their own inventory instead (solve_stage)."""
        for rid, r in list(self._reservations.items()):
            if r.churn and r.stage_key == key:
                del self._reservations[rid]

    def _reserve(self, key: str, pt: ProblemTensors,
                 placement: Placement) -> str:
        self._drop_churn(key)
        rid = f"rsv_{next(self._ids)}"
        self._reservations[rid] = Reservation(
            id=rid, stage_key=key,
            demand_by_node=self._demand_by_node(pt, placement),
            assignment=dict(placement.assignment))
        return rid

    def _apply_allocation(self, r: Reservation, sign: float) -> None:
        for slug, dem in r.demand_by_node.items():
            s = self.store.server_by_slug(slug)
            if s is None:
                continue
            self.store.update("servers", s.id, allocated=type(s.allocated)(
                cpu=max(s.allocated.cpu + sign * float(dem[0]), 0.0),
                memory=max(s.allocated.memory + sign * float(dem[1]), 0.0),
                disk=max(s.allocated.disk + sign * float(dem[2]), 0.0),
                reserved_cpu=s.allocated.reserved_cpu,
                reserved_memory=s.allocated.reserved_memory,
                reserved_disk=s.allocated.reserved_disk,
            ))

    def _apply_allocation_delta(self, prev: Reservation,
                                new: Reservation) -> None:
        """Supersede `prev` by `new` touching only the nodes whose demand
        actually CHANGED. Numerically identical to apply(prev, -1) +
        apply(new, +1), but a streaming micro-solve commit (one per drain
        tick, cp/admission.py) only moves a batch's worth of nodes —
        rewriting every server record of a 10k-service stage per commit
        was the admission bench's bottleneck, not the solve."""
        slugs = set(prev.demand_by_node) | set(new.demand_by_node)
        zero = np.zeros(3)
        for slug in slugs:
            d = (np.asarray(new.demand_by_node.get(slug, zero),
                            dtype=np.float64)
                 - np.asarray(prev.demand_by_node.get(slug, zero),
                              dtype=np.float64))
            if not d.any():
                continue
            s = self.store.server_by_slug(slug)
            if s is None:
                continue
            self.store.update("servers", s.id, allocated=type(s.allocated)(
                cpu=max(s.allocated.cpu + float(d[0]), 0.0),
                memory=max(s.allocated.memory + float(d[1]), 0.0),
                disk=max(s.allocated.disk + float(d[2]), 0.0),
                reserved_cpu=s.allocated.reserved_cpu,
                reserved_memory=s.allocated.reserved_memory,
                reserved_disk=s.allocated.reserved_disk,
            ))

    def commit(self, rid: str) -> bool:
        """Deploy succeeded: move reserved -> committed on the servers
        (2-phase step 2, model.rs:421-427). A redeploy of the same stage
        SUPERSEDES its previous commit — the old containers were stopped and
        replaced, so their allocation is returned first."""
        with self._lock:
            r = self._reservations.pop(rid, None)
            if r is None or r.committed:
                return False
            prev = self._committed.pop(r.stage_key, None)
            if prev is not None:
                self._apply_allocation_delta(prev, r)
            else:
                self._apply_allocation(r, +1.0)
            r.committed = True
            self._committed[r.stage_key] = r
            self._drop_churn(r.stage_key)   # commitment reflects reality now
            self._persist_committed(r.stage_key)
            return True

    def release(self, rid: str, *, undo_commit: bool = False) -> bool:
        """Deploy failed or stage torn down: drop the reservation; with
        `undo_commit`, also return the stage's committed capacity."""
        with self._lock:
            r = self._reservations.pop(rid, None)
            if r is not None:
                return True
            if undo_commit:
                for key, c in list(self._committed.items()):
                    if c.id == rid:
                        self._apply_allocation(c, -1.0)
                        del self._committed[key]
                        self._drop_churn(key)   # torn down: nothing to hold
                        self._persist_committed(key)
                        return True
            return False

    def commit_retained(self, stage_key: str) -> bool:
        """Adopt the stage's retained placement as its committed allocation
        — the reconverger's commit path (cp/reconverge.py): a churn
        re-solve's assignment was actually redeployed to the surviving
        agents, so the churn hold graduates to the commitment, superseding
        the pre-churn one (same supersede semantics as commit())."""
        with self._lock:
            entry = self._last.get(stage_key)
            if entry is None:
                return False
            pt, placement = entry
            if not placement.feasible:
                return False
            r = Reservation(
                id=f"rsv_{next(self._ids)}", stage_key=stage_key,
                demand_by_node=self._demand_by_node(pt, placement),
                assignment=dict(placement.assignment), committed=True)
            prev = self._committed.pop(stage_key, None)
            if prev is not None:
                self._apply_allocation(prev, -1.0)
            self._apply_allocation(r, +1.0)
            self._committed[stage_key] = r
            self._drop_churn(stage_key)
            self._persist_committed(stage_key)
            return True

    def release_stage(self, stage_key: str) -> bool:
        """Stage torn down (`fleet down` on a remote stage): return its
        committed capacity."""
        with self._lock:
            self._drop_churn(stage_key)
            c = self._committed.pop(stage_key, None)
            if c is None:
                return False
            self._apply_allocation(c, -1.0)
            self._persist_committed(stage_key)
            return True

    def _snapshot_locked(self) -> dict[str, dict]:
        return {key: {"assignment": pl.assignment,
                      "feasible": pl.feasible,
                      "violations": pl.violations,
                      "source": pl.source,
                      "solve_ms": round(pl.solve_ms, 2)}
                for key, (_pt, pl) in self._last.items()}

    def _reservations_locked(self) -> dict:
        def dem(d: dict[str, np.ndarray]) -> dict[str, list[float]]:
            return {slug: [round(float(x), 3)
                           for x in np.asarray(v, dtype=np.float64).ravel()]
                    for slug, v in d.items()}

        return {
            "in_flight": [
                {"id": r.id, "stage": r.stage_key, "churn": r.churn,
                 "demand_by_node": dem(r.demand_by_node)}
                for r in self._reservations.values()],
            "committed": [
                {"id": r.id, "stage": key,
                 "demand_by_node": dem(r.demand_by_node)}
                for key, r in self._committed.items()],
        }

    def snapshot(self) -> dict[str, dict]:
        """Public view of the latest placement per stage (for REST/MCP)."""
        with self._lock:
            return self._snapshot_locked()

    def solver_slots(self) -> dict:
        """Device slot-manager occupancy (sched/gpu.py slots_status):
        per-stage resident tier/bytes/idle/evictions plus the byte
        budget — the `fleet solve slots` payload. The host greedy path
        builds no scheduler and holds no slots: it reports the limits an
        idle ``GpuSolverScheduler()`` would hold, as the reference's host
        path reports its idle device scheduler's."""
        if self._sched_gpu is None:
            max_slots, budget = slot_limits()
            return {"budget_bytes": budget, "max_slots": max_slots,
                    "resident_bytes": 0, "bytes_drift": 0, "slots": [],
                    "evicted": []}
        return self._sched_gpu.slots_status()

    def retained(self, stage_key: str
                 ) -> Optional[tuple[ProblemTensors, Placement]]:
        """The retained (problem, placement) pair for a stage — what
        `explain` answers from. The chaos invariant checker re-verifies
        the final assignment against the solver's own exact checker
        (solver/repair.verify) through this accessor."""
        with self._lock:
            return self._last.get(stage_key)

    def reservations_snapshot(self) -> dict:
        """Public view of the 2-phase journal: in-flight reservations
        (including churn holds awaiting a redeploy) and committed
        allocations per stage — the operator's answer to "why is this
        node's capacity spoken for?"."""
        with self._lock:
            return self._reservations_locked()

    def placement_state(self) -> dict:
        """Both views under ONE lock acquisition, so a commit landing
        between them cannot make the dashboard render a placement with a
        contradictory journal (and a long solve is only waited out once)."""
        with self._lock:
            return {"stages": self._snapshot_locked(),
                    "reservations": self._reservations_locked()}

    def explain(self, stage_key: str, service: str, top_k: int = 5) -> dict:
        """Why is `service` where it is in `stage_key`'s latest placement?
        Per-node hard/soft breakdown from the retained (pt, placement) —
        solver/explain.py — answered from memory, no re-solve. Raises
        KeyError for an unknown stage or service."""
        from ..solver.explain import explain_assignment

        with self._lock:
            entry = self._last.get(stage_key)
            if entry is None:
                raise KeyError(
                    f"no retained placement for stage {stage_key!r}; "
                    f"known: {sorted(self._last)}")
            pt, placement = entry
            if placement.raw is not None:
                assignment = np.asarray(placement.raw)
            else:
                node_idx = {n: j for j, n in enumerate(pt.node_names)}
                assignment = np.array(
                    [node_idx[placement.assignment[nm]]
                     for nm in pt.service_names], dtype=np.int64)
            out = explain_assignment(pt, assignment, service, top_k=top_k)
            out["stage"] = stage_key
            out["source"] = placement.source
            return out

    # ------------------------------------------------------------------
    # streaming re-solve (BASELINE config 5)
    # ------------------------------------------------------------------

    def _stage_demand(self, key: str) -> dict[str, np.ndarray]:
        """Per-node demand currently attributed to stage `key`: its
        committed allocation plus any of its own IN-FLIGHT reservations
        (a churn re-solve racing the stage's deploy window must not
        double-count the stage against itself)."""
        out: dict[str, np.ndarray] = {}
        c = self._committed.get(key)
        if c is not None:
            for slug, d in c.demand_by_node.items():
                out[slug] = out.get(slug, 0) + d
        for r in self._reservations.values():
            if r.stage_key == key and not r.committed:
                for slug, d in r.demand_by_node.items():
                    out[slug] = out.get(slug, 0) + d
        return out

    def _refresh_capacity(self, pt: ProblemTensors, key: str,
                          overrides: Optional[dict[str, tuple]] = None,
                          server_map: Optional[dict[str, Server]] = None,
                          ) -> ProblemTensors:
        """Live per-node capacity for a churn re-solve of stage `key`:
        raw capacity minus committed allocations and in-flight
        reservations, plus this stage's OWN demand back (committed AND
        reserved — its services are the ones being re-placed).

        `overrides` maps stages already re-solved EARLIER IN THE SAME
        BURST to (their stage-demand snapshot, their new per-node demand):
        their store records still cite the pre-burst nodes, so without the
        substitution two stages displaced by one burst would each see the
        other at its old (dead) node and double-book the survivor.
        `server_map` (slug -> Server) avoids a per-node linear store scan
        when the caller already holds one.  Returns pt unchanged (same
        object, so device stagings keyed on identity stay warm) when
        nothing moved; otherwise a copy with fresh capacity."""
        own = self._stage_demand(key)
        reserved = self._reserved_by_node()
        other = [snap for okey, snap in (overrides or {}).items()
                 if okey != key]
        cap = pt.capacity.copy()
        for j, slug in enumerate(pt.node_names):
            s = (server_map.get(slug) if server_map is not None
                 else self.store.server_by_slug(slug))
            if s is None:
                continue
            alloc = (_alloc_vector(s) + reserved.get(slug, 0)
                     - own.get(slug, 0))
            for old_dem, new_dem in other:
                alloc = (alloc - old_dem.get(slug, 0)
                         + new_dem.get(slug, 0))
            raw = np.array([s.capacity.cpu, s.capacity.memory,
                            s.capacity.disk], dtype=np.float64)
            cap[j] = np.maximum(raw - alloc, 0.0)
        if np.array_equal(cap, pt.capacity):
            return pt
        return _dc_replace(pt, capacity=cap)

    def node_event(self, slug: str, *, online: bool) -> list[tuple[str, Placement]]:
        """Churn: flip the node's validity and warm-start re-solve every
        stage that had services there. Returns [(stage_key, new placement)].
        Device masks update as a small delta; the solver's migration
        stickiness keeps unaffected services in place."""
        return self.node_events([(slug, online)])

    def node_events(self, events: list[tuple[str, bool]]
                    ) -> list[tuple[str, Placement]]:
        """Coalesced churn (VERDICT r3 item 5): apply EVERY validity flip
        of a burst first, then warm re-solve each affected stage ONCE
        against the final mask — a 3-dead-1-revived burst costs one
        re-solve per stage, not four, and the solver sees the true final
        world instead of three intermediate ones (sequential re-solves can
        bounce services onto a node that the next event kills)."""
        for slug, online in events:
            s = self.store.server_by_slug(slug)
            if s is not None:
                self.store.update("servers", s.id,
                                  status="online" if online else "offline")
        moved: list[tuple[str, Placement]] = []
        # stages re-solved earlier in THIS burst -> (stage-demand snapshot,
        # new per-node demand), so later re-solves see them at their new
        # homes instead of their stale store records (double-booking the
        # survivor node)
        overrides: dict[str, tuple] = {}
        with self._lock:
            server_map = {s.slug: s for s in self.store.list("servers")}
            for key, (pt, placement) in list(self._last.items()):
                needs_resolve = False
                flipped = False
                for slug, online in events:
                    if slug not in pt.node_names:
                        continue
                    j = pt.node_names.index(slug)
                    if bool(pt.node_valid[j]) == online:
                        continue
                    if not flipped:
                        pt.node_valid = pt.node_valid.copy()
                        flipped = True
                    pt.node_valid[j] = online
                    # a death with nothing placed on the node is a pure
                    # mask change; a death with services there forces a
                    # re-solve, and so does a REVIVE — the stage may be
                    # running degraded/infeasible on the shrunken pool and
                    # must get the chance to move back (the pre-coalescing
                    # behavior re-solved on every revive flip)
                    if online or np.any(np.asarray(placement.raw) == j):
                        needs_resolve = True
                if not needs_resolve:
                    continue
                # Admission-during-churn (SURVEY hard part (c)): pt's
                # capacity is a snapshot from this stage's admission;
                # stages committed SINCE then have filled nodes pt still
                # sees as free, so a warm re-solve against the stale view
                # can double-book a node (each solve is self-consistent,
                # so no violation counter would ever say so). Rebuild
                # per-node capacity from live inventory, excluding this
                # stage's own commitment + in-flight reservations (its
                # services are the ones being re-placed) and substituting
                # burst-mates' already-re-solved positions.
                pt = self._refresh_capacity(pt, key, overrides, server_map)
                degraded = False
                t_solve = time.perf_counter()
                try:
                    if self.use_gpu:
                        # structured churn instead of a full re-staging:
                        # validity flips + refreshed capacity ride a
                        # ProblemDelta, which the scheduler merges into
                        # its device-resident problem when the bucket
                        # identity holds (solver/resident.py) — the
                        # (S, N) problem planes never re-cross the host
                        # boundary on a reconvergence burst. Content
                        # drift beyond the delta cold-stages safely.
                        new = self._sched_gpu.reschedule(
                            pt, delta=ProblemDelta(node_valid=pt.node_valid,
                                                   capacity=pt.capacity),
                            stage=key)
                    else:
                        new = self._sched_host.place(pt)
                except Exception as e:
                    # graceful degradation: a churn re-solve is on the
                    # self-healing critical path — a solver crash/timeout
                    # must cost solution quality, not convergence. The
                    # greedy host path solves the same tensors. A fault
                    # of the device path itself propagates.
                    if _device_fault(e):
                        raise
                    _M_CHURN_FALLBACKS.inc()
                    degraded = True
                    log.error("churn solve failed; greedy host fallback %s",
                              kv(stage=key, error=e))
                    new = self._sched_host.place(pt)
                if not new.feasible and pt.relax_order:
                    # a stage placed via declared relaxation must keep its
                    # relaxation through churn re-solves (and a crashed
                    # device solver stays benched for the ladder too)
                    sched = (self._sched_host if degraded or not self.use_gpu
                             else self._sched_gpu)
                    new, _ = place_with_fallback(
                        sched, pt, initial=new,
                        place_kwargs=({"stage": key}
                                      if sched is self._sched_gpu else None))
                # the warm-reschedule latency SLO stream (obs/slo.py):
                # one sample per stage re-solve, relax-ladder included —
                # this IS the placement-p99-ms an operator declares
                slo_observe("placement_ms",
                            (time.perf_counter() - t_solve) * 1e3)
                # a streaming stage's tombstoned rows stay masked through
                # churn re-solves too
                new = self._apply_mask(key, new)
                self._last[key] = (pt, new)
                if new.feasible:
                    new_dem = self._demand_by_node(pt, new)
                    # hold the displaced stage's NEW nodes until its
                    # redeploy re-commits: an admission landing between
                    # the burst and the redeploy must not double-book
                    # them.  Reserve only the DELTA above the stage's
                    # still-standing demand (committed allocation AND any
                    # in-flight reservation of its own), so no service is
                    # counted twice.
                    self._drop_churn(key)
                    old = self._stage_demand(key)
                    delta = {}
                    for slug, d in new_dem.items():
                        extra = np.maximum(
                            np.asarray(d, dtype=np.float64)
                            - old.get(slug, 0), 0.0)
                        if extra.any():
                            delta[slug] = extra
                    if delta:
                        rid = f"rsv_{next(self._ids)}"
                        self._reservations[rid] = Reservation(
                            id=rid, stage_key=key, demand_by_node=delta,
                            assignment=dict(new.assignment), churn=True)
                    # snapshot AFTER the churn reservation exists: burst-
                    # mates' refreshes subtract this exact view and add
                    # new_dem, cancelling the reservation they also see
                    # in _reserved_by_node
                    overrides[key] = (self._stage_demand(key), new_dem)
                moved.append((key, new))
        return moved
