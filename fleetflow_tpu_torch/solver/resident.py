"""Device-resident fleet state (port of ``solver/resident.py``).

The staged problem and the last committed assignment stay on the device
between solves; churn arrives as a structured ``ProblemDelta`` and is merged
IN PLACE into the resident tensors (``copy_`` of the small node planes,
``index_copy_`` of the changed service rows). In-place updates stand in for
the reference's buffer donation: the stale planes are overwritten where they
lie, and no second copy of an (S, ·) plane is made.

A bucketed staging (the default) pads S onto the tier ladder with inert
phantom rows (solver/buckets.py). Arrivals that stay inside the tier and
bring no new constraint ids ride the delta path into phantom rows
(``ProblemDelta.n_real``); every merge re-parks the phantom rows on the
first valid node, since a phantom left on a node the delta just killed
would count as an eligibility violation.

The resident state also carries what the active-set sub-solve
(solver/subsolve.py) plans from: a host mirror of the padded device
assignment as of the last solve, whether that solve was feasible, the
rows churn has touched since, and the host constraint index.

The reference proves that the warm dispatch moves no problem tensor by
running it under ``jax.transfer_guard("disallow")``. PyTorch has no such
guard. Every host-to-device copy this module makes goes through
:meth:`ResidentProblem.upload`, which counts it, and ``solve`` reports the
``upload`` calls made across the warm dispatch
(``SolveResult.warm_h2d_copies``). That count sees this module's uploads
only; ``chip_smoke.py`` counts every host-to-device copy the card made
during a warm dispatch from a profiler trace.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..obs.metrics import MS_BUCKETS, REGISTRY
from .buckets import (BucketConfig, bucket_config, bucket_size,
                      pad_assignment, stage_problem_tiers)
from .problem import TorchProblem, pack_bool_rows, prepare_problem

__all__ = ["ProblemDelta", "ResidentProblem", "merge_delta"]

_M_REUSE = REGISTRY.counter(
    "fleet_solver_resident_reuse_total",
    "Resident-state staging decisions: delta = on-device delta applied to "
    "the resident problem, cold = full host (re)staging",
    labels=("outcome",))
_M_DELTA_MS = REGISTRY.histogram(
    "fleet_solver_delta_stage_ms",
    "Milliseconds spent applying on-device churn deltas per warm solve "
    "(upload + donated merge dispatch)",
    buckets=MS_BUCKETS)
# warm solves whose problem or seed had to cross the host boundary where
# the reference's disallow transfer guard would have fired: a host-repaired
# winner re-uploaded on the warm path, or a warm request that had to
# cold-stage
_M_HOST_XFER = REGISTRY.counter(
    "fleet_solver_host_transfers_total",
    "Warm-path solves that had to move problem tensors across the host "
    "boundary (cold restage on a warm attempt, or a host repair re-upload) "
    "— each is an event the transfer guard would have caught in disallow "
    "mode")


@dataclass
class ProblemDelta:
    """Structured churn: what changed since the resident staging.

    `node_valid`/`capacity` are FULL small arrays ((N,) / (N, R)); row
    fields scatter into the (S, ·) planes. None means unchanged (the node
    planes then come from the accompanying ProblemTensors). The new
    ProblemTensors may differ from the resident one ONLY by fields this
    delta covers; ``ResidentProblem.compatible`` enforces that by object
    identity."""
    node_valid: Optional[np.ndarray] = None       # (N,) new validity mask
    capacity: Optional[np.ndarray] = None         # (N, R) new capacity
    # demand drift / arrivals: (rows (k,), values (k, R))
    demand_rows: Optional[tuple[np.ndarray, np.ndarray]] = None
    # eligibility drift / arrivals: (rows (k,), masks (k, N))
    eligible_rows: Optional[tuple[np.ndarray, np.ndarray]] = None
    # new real-row count (arrivals activate phantom rows; None = unchanged)
    n_real: Optional[int] = None


def merge_delta(prob: TorchProblem, assignment: Optional[torch.Tensor],
                node_valid: torch.Tensor, capacity: torch.Tensor,
                demand_rows: Optional[tuple] = None,
                eligible_rows: Optional[tuple] = None,
                n_real: Optional[int] = None, *, first_valid: int) -> None:
    """The churn merge, in place (the reference's ``_merge_fn`` and, on a
    mesh whose shards are views of the planes, ``_merge_fn_sharded``): the
    node planes copied, the changed demand and eligibility rows ((idx,
    rows) device tensors) written, `n_real` set, and the phantom rows of
    `assignment` re-parked on `first_valid`, the first valid node of the
    host mask (its argmax, 0 when none is valid): the last winner may have
    left them on a node the delta killed. A fill with a host scalar:
    nothing is uploaded or read back."""
    prob.node_valid.copy_(node_valid)
    prob.capacity.copy_(capacity)
    if demand_rows is not None:
        prob.demand.index_copy_(0, *demand_rows)
    if eligible_rows is not None:
        prob.eligible.index_copy_(0, *eligible_rows)
    if n_real is not None:
        prob.n_real = int(n_real)
    if assignment is not None:
        assignment[prob.real_rows:].fill_(first_valid)


class ResidentProblem:
    """The device-resident placement state a GpuSolverScheduler owns.

    Lifecycle: `cold_stage(pt)` stages once (padded onto the tier ladder
    when `bucket`); each churn burst calls `apply_delta(pt, delta)`
    (in-place merge); ``solver.api.solve`` seeds the warm anneal from
    `self.assignment` (padded, on the device), calls `adopt()` with the
    winner and `note_host_assignment()` with its host copy.
    `compatible()` decides delta reuse vs a cold restage."""

    # the mesh this staging is placed on (None: one device, no mesh); the
    # scheduler's slot matching keys on it, so a routing flip can never
    # hand a sharded staging to the single-device solve or back
    mesh = None
    # the single-device staging supports churn-localized sub-solves
    supports_subsolve = True

    def __init__(self, pt, device: torch.device, *, bucket: bool = True,
                 cfg: Optional[BucketConfig] = None):
        self.device = torch.device(device)
        self.cfg = cfg or bucket_config()
        self.bucket = bool(bucket and self.cfg.enabled)
        self.pt: Any = None
        self.prob: Optional[TorchProblem] = None
        # (padded S,) i32 on the device
        self.assignment: Optional[torch.Tensor] = None
        self.h2d_copies = 0
        self._valid_fp: Optional[np.ndarray] = None
        self._cap_fp: Optional[np.ndarray] = None
        self._delta_ms = 0.0
        # active-set sub-solve state: the host mirror of the padded device
        # assignment as of the last solve (phantom re-parks replayed), its
        # feasibility, the host constraint index (built lazily per
        # staging), and the rows churn touched since that solve
        self._mirror: Optional[np.ndarray] = None
        self._mirror_feasible = False
        self._index: Any = None
        self._pending_rows: Optional[np.ndarray] = None
        self._pending_churn = False
        self.cold_stage(pt)

    def upload(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """The one host-to-device path of the resident state (counted)."""
        self.h2d_copies += 1
        return torch.tensor(np.ascontiguousarray(arr), dtype=dtype,
                            device=self.device)

    # -- staging -----------------------------------------------------------

    def cold_stage(self, pt) -> None:
        """Full host staging (also the fallback when a delta cannot be
        expressed)."""
        if self.bucket:
            self.prob, _ = stage_problem_tiers(pt, self.cfg, self.device)
        else:
            self.prob = prepare_problem(pt, self.device)
        # always set, padded or not: the merge re-parks rows past it
        self.prob.n_real = int(pt.S)
        self.pt = pt
        self.assignment = None
        self._valid_fp = np.asarray(pt.node_valid, dtype=bool).copy()
        self._cap_fp = np.asarray(pt.capacity, dtype=np.float32).copy()
        self._delta_ms = 0.0
        # the sub-solve state belongs to the dead staging
        self._mirror = None
        self._mirror_feasible = False
        self._index = None
        self._pending_rows = None
        self._pending_churn = False
        _M_REUSE.inc(outcome="cold")

    @property
    def padded_S(self) -> int:
        """The padded row count of the staging (a mesh of ranks holds one
        shard of it on each rank)."""
        return self.prob.S

    @property
    def real_rows(self) -> int:
        """The staging's real rows (the rest are phantoms)."""
        return self.prob.real_rows

    def _expected_padded_S(self, pt) -> int:
        """The padded S a cold staging of `pt` would produce."""
        return bucket_size(pt.S, growth=self.cfg.growth,
                           minimum=self.cfg.minimum, align=self.cfg.align)

    def compatible(self, pt, delta: Optional[ProblemDelta] = None) -> bool:
        """Delta reuse gate: same shape tier and solver statics, and every
        tensor the delta does NOT cover is the same OBJECT as the resident
        staging's (dataclasses.replace shares untouched arrays, which is
        how the control plane expresses churn). A fleet grown inside its
        tier rides the delta through `_arrivals_compatible`."""
        if self.pt is None or self.prob is None:
            return False
        old = self.pt
        if pt is old:
            return True
        if pt.N != old.N:
            return False
        if pt.strategy != old.strategy or pt.max_skew != old.max_skew:
            return False
        if pt.S != old.S:
            return self._arrivals_compatible(pt, delta, old)
        if self.bucket and self._expected_padded_S(pt) != self.padded_S:
            return False
        same = (pt.port_ids is old.port_ids
                and pt.volume_ids is old.volume_ids
                and pt.anti_ids is old.anti_ids
                and pt.coloc_ids is old.coloc_ids
                and pt.node_topology is old.node_topology
                and pt.preferred is old.preferred)
        if delta is None or delta.demand_rows is None:
            same = same and pt.demand is old.demand
        if delta is None or delta.eligible_rows is None:
            same = same and pt.eligible is old.eligible
        return same

    def _arrivals_compatible(self, pt, delta: Optional[ProblemDelta],
                             old) -> bool:
        """Can a GROWN pt (arrivals appended since the resident staging)
        ride the delta path? Yes when the new rows land in phantom rows
        already staged: the fleet stays inside the padded tier, the delta
        writes the arrivals' demand and eligibility and sets n_real, and
        the appended rows carry no constraint ids (the padded id planes
        already read -1 there). A crossed tier, an arrival with
        ports/volumes/anti-affinity/colocation or a preference plane
        cold-stages."""
        if delta is None or delta.n_real != pt.S or pt.S <= old.S:
            return False
        if not self.bucket or self._expected_padded_S(pt) != self.padded_S:
            return False
        if delta.demand_rows is None or delta.eligible_rows is None:
            return False
        new = np.arange(old.S, pt.S)
        if not (np.isin(new, np.asarray(delta.demand_rows[0])).all()
                and np.isin(new, np.asarray(delta.eligible_rows[0])).all()):
            return False
        if (pt.node_topology is not old.node_topology
                or pt.preferred is not None or old.preferred is not None):
            return False
        for name in ("port_ids", "volume_ids", "anti_ids", "coloc_ids"):
            a, b = getattr(pt, name), getattr(old, name)
            if (a.shape[1] != b.shape[1]
                    or not np.array_equal(a[:old.S], b)
                    or (a[old.S:] != -1).any()):
                return False
        return True

    def merge_inputs(self, pt, delta: Optional[ProblemDelta] = None) -> dict:
        """Upload the small per-burst merge inputs for `delta`: the node
        planes always (a few KB), the changed service rows when present."""
        delta = delta or ProblemDelta()
        valid = np.asarray(delta.node_valid if delta.node_valid is not None
                           else pt.node_valid, dtype=bool)
        cap = np.asarray(delta.capacity if delta.capacity is not None
                         else pt.capacity, dtype=np.float32)
        out = {"valid_np": valid, "cap_np": cap,
               "node_valid": self.upload(valid, torch.bool),
               "capacity": self.upload(cap, torch.float32)}
        if delta.demand_rows is not None:
            idx, vals = delta.demand_rows
            out["dem_idx"] = self.upload(np.asarray(idx, np.int64),
                                         torch.int64)
            out["dem_val"] = self.upload(np.asarray(vals, np.float32),
                                         torch.float32)
        if delta.eligible_rows is not None:
            idx, masks = delta.eligible_rows
            masks = np.asarray(masks, dtype=bool).reshape(-1, self.prob.N)
            if self.prob.eligible_packed:
                rows, dtype = pack_bool_rows(masks), torch.int32
            else:
                rows, dtype = masks, torch.bool
            out["elig_idx"] = self.upload(np.asarray(idx, np.int64),
                                          torch.int64)
            out["elig_rows"] = self.upload(rows, dtype)
        return out

    def _note_churn(self, pt, delta: Optional[ProblemDelta]) -> None:
        """Accumulate the rows this delta touches for the active-set
        planner, BEFORE the fingerprints roll over (capacity shrink is
        measured against the staging the mirror was solved on). Killed
        nodes need no bookkeeping: the planner recomputes stranded rows
        from the post-delta tensors."""
        if not self.supports_subsolve or self._mirror is None:
            return
        rows = [np.empty(0, dtype=np.int64)]
        if delta is not None:
            if delta.demand_rows is not None:
                rows.append(np.asarray(delta.demand_rows[0], dtype=np.int64))
            if delta.eligible_rows is not None:
                rows.append(np.asarray(delta.eligible_rows[0],
                                       dtype=np.int64))
        # capacity shrink: frozen rows on a shrunk node may now overflow it
        new_cap = np.asarray(
            delta.capacity if delta is not None and delta.capacity is not None
            else pt.capacity, dtype=np.float32)
        if self._cap_fp is not None and new_cap.shape == self._cap_fp.shape:
            shrunk = (new_cap < self._cap_fp - 1e-6).any(axis=1)
            if shrunk.any():
                n = min(self.prob.real_rows, self._mirror.shape[0])
                rows.append(np.nonzero(shrunk[self._mirror[:n]])[0])
        pending = np.unique(np.concatenate(rows))
        if self._pending_rows is not None:
            pending = np.union1d(self._pending_rows, pending)
        self._pending_rows = pending
        self._pending_churn = True

    def apply_delta(self, pt, delta: Optional[ProblemDelta] = None) -> float:
        """Merge churn into the resident tensors in place; returns the
        delta-staging wall ms (also reported as the next solve's
        `delta_stage_ms`)."""
        t0 = time.perf_counter()
        self._note_churn(pt, delta)
        up = self.merge_inputs(pt, delta)
        first_valid = int(np.argmax(up["valid_np"]))
        merge_delta(self.prob, self.assignment, up["node_valid"],
                    up["capacity"],
                    (up["dem_idx"], up["dem_val"]) if "dem_idx" in up else None,
                    (up["elig_idx"], up["elig_rows"]) if "elig_idx" in up
                    else None,
                    delta.n_real if delta is not None else None,
                    first_valid=first_valid)
        if self._mirror is not None:
            # the same re-park on the host mirror keeps it an exact copy
            self._mirror[self.real_rows:] = first_valid
        self.pt = pt
        self._valid_fp = up["valid_np"].copy()
        self._cap_fp = up["cap_np"].copy()
        ms = (time.perf_counter() - t0) * 1e3
        self._delta_ms += ms
        _M_DELTA_MS.observe(ms)
        _M_REUSE.inc(outcome="delta")
        return ms

    def drifted(self, pt) -> bool:
        """Has node validity or capacity drifted since the last staging?
        (The implicit delta for callers that mutate ProblemTensors in
        place instead of sending a ProblemDelta.)"""
        return not (np.array_equal(self._valid_fp, pt.node_valid)
                    and np.array_equal(
                        self._cap_fp,
                        np.asarray(pt.capacity, dtype=np.float32)))

    # -- solve-side hooks ---------------------------------------------------

    def consume_delta_ms(self) -> float:
        ms, self._delta_ms = self._delta_ms, 0.0
        return ms

    def adopt(self, assignment: torch.Tensor) -> None:
        """Keep the padded winner (already on the device) as the next warm
        seed."""
        self.assignment = assignment

    def adopt_host(self, assignment: np.ndarray, node_valid, *,
                   warm: bool = True) -> None:
        """Host repair rewrote the winner: upload it, phantoms parked on the
        first valid node, as the warm seed (a counted host-to-device copy)
        and as the sub-solve mirror. On the warm path that upload is a
        host transfer (``fleet_solver_host_transfers_total``); a
        re-admission after eviction
        (`warm=False`) is staging."""
        padded = pad_assignment(np.asarray(assignment, dtype=np.int32),
                                self.padded_S, np.asarray(node_valid))
        self.assignment = self._upload_assignment(padded)
        self._mirror = padded.copy()
        if warm:
            _M_HOST_XFER.inc()

    def _upload_assignment(self, padded: np.ndarray) -> torch.Tensor:
        """The device seed of a padded host assignment (one counted
        upload)."""
        return self.upload(padded, torch.int32)

    def record_warm_fallback(self) -> None:
        """A warm attempt had to cold-stage: problem tensors crossed the
        host boundary."""
        _M_HOST_XFER.inc()

    # -- slot manager hooks (sched/gpu.py) -----------------------------------

    def eviction_snapshot(self) -> Optional[tuple[np.ndarray, bool]]:
        """The host snapshot the slot manager keeps when it evicts this
        staging: a copy of the committed PADDED assignment mirror and its
        feasibility (padded, so a re-admission's ``adopt_host`` restores
        the exact device seed, phantom parking included). No device read:
        the mirror rode the last solve's fetch. None before the first
        committed solve."""
        if self._mirror is None:
            return None
        return np.array(self._mirror, copy=True), bool(self._mirror_feasible)

    def device_nbytes(self) -> int:
        """The staging's device footprint: numel x element size of every
        staged problem tensor (packed eligibility words at their int32
        width) plus the (S,) int32 committed assignment, counted from the
        staging on (before the first solve adopts one), so a slot is
        budgeted at its full size when it is admitted. The slot manager's
        byte budget counts this. A walk of tensor shapes, no device
        sync."""
        if self.prob is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self.prob.tensors() if t is not None)
                   + 4 * self.prob.S)

    def release(self) -> None:
        """Drop every device tensor of the staging (the slot manager's
        eviction), so the card's memory is freed even while a caller still
        holds this object. It cannot solve again."""
        self.prob = None
        self.assignment = None
        self.pt = None
        self._index = None

    # -- active-set sub-solve hooks (solver/subsolve.py) -------------------

    def note_host_assignment(self, padded: Optional[np.ndarray] = None,
                             feasible: Optional[bool] = None) -> None:
        """End of a solve: the padded winner the solve fetched anyway
        becomes the mirror, and its feasibility the frozen-base
        precondition (frozen-frozen violations are zero only when the
        previous placement was feasible). Clears the pending churn."""
        if padded is not None:
            arr = np.asarray(padded, dtype=np.int32)
            if self.prob is not None and arr.shape[0] == self.padded_S:
                self._mirror = arr.copy()
        if feasible is not None:
            self._mirror_feasible = bool(feasible)
        self._pending_rows = None
        self._pending_churn = False

    def take_active_plan(self):
        """The churn-localized sub-problem for the warm solve about to run,
        or None for the full path. Consumes the pending churn either way;
        a fallback the planner decides is counted here ("localized" and
        "fallback_infeasible" are counted by the caller after the gate)."""
        pending, self._pending_rows = self._pending_rows, None
        churn, self._pending_churn = self._pending_churn, False
        if not churn:
            return None
        from .subsolve import (ActiveIndex, plan_active, record_outcome,
                               subsolve_config)
        cfg = subsolve_config()
        if not (cfg.enabled and self.supports_subsolve):
            return None
        if self._mirror is None or not self._mirror_feasible:
            return None
        if self._index is None:
            # ids cannot drift on the delta path (compatible() pins them by
            # identity; arrival rows carry none): one index per staging
            self._index = ActiveIndex(self.pt)
        plan, outcome = plan_active(
            self._index, self.pt, self._mirror, self.prob.S, self.prob.T,
            pending if pending is not None else np.empty(0, dtype=np.int64),
            cfg, G_full=self.prob.G, Gc_full=self.prob.Gc)
        if plan is None:
            record_outcome(outcome)
        return plan
