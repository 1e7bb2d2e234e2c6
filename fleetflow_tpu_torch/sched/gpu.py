"""GPU solver scheduler (port of ``sched/tpu.py::TpuSolverScheduler``).

Owns the device-resident fleet state (solver/resident.py), one slot per
stage key: the staged problem and the last committed assignment stay on the
card across re-solves, and churn arrives as a ``ProblemDelta`` merged in
place. A warm ``reschedule`` therefore uploads only the small node planes
and the changed rows. Content drift a delta cannot express (a relowered
fleet, new conflict ids, a changed shape) falls back to a cold staging that
still warm-starts from the stage's last host assignment.

Staging is bucketed by default (``bucket=None`` means on, as in the
reference's scheduler; FLEET_BUCKET=0 turns it off everywhere): the
resident problem is padded onto its tier ladder with phantom rows, so
arrivals inside the tier ride the delta path, and each warm reschedule
tries the churn-localized sub-solve first (solver/subsolve.py).

The scheduler runs on the card: ``GpuSolverScheduler()`` raises when CUDA
is absent, and the CPU is used only when the caller passes device="cpu".
The byte-budget LRU slot eviction of the reference is not ported yet:
slots live until the scheduler does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..lower.tensors import ProblemTensors
from ..solver.api import SolveResult, solve
from ..solver.resident import ProblemDelta, ResidentProblem
from .base import Placement, level_schedule

__all__ = ["GpuSolverScheduler"]


@dataclass
class _StageSlot:
    """Per-stage resident state: the control plane drives every stage
    through one scheduler, so resident reuse is per stage."""
    resident: ResidentProblem
    last_assignment: Optional[np.ndarray] = None   # host warm seed for cold fallback
    key: Optional[str] = None


class GpuSolverScheduler:
    def __init__(self, *, chains: Optional[int] = None, steps: int = 128,
                 seed: int = 0, device=None, bucket: Optional[bool] = None):
        # device=None is the card and raises without CUDA (no fallback)
        self.device = resolve_device(device)
        self.chains = chains
        self.steps = steps
        self.seed = seed
        # None -> ON for the scheduler (the churn path bucketing exists
        # for); False, or FLEET_BUCKET=0, stages exact shapes
        self.bucket = bucket
        self._slots: list[_StageSlot] = []
        self.last_result: Optional[SolveResult] = None

    def _find(self, pt: ProblemTensors, stage: Optional[str]):
        """This stage's slot: by key when the caller has one, else the
        keyless slot of the same shape and service names."""
        for i, slot in enumerate(self._slots):
            if stage is not None:
                if slot.key == stage:
                    return i
                continue
            old = slot.resident.pt
            if (slot.key is None and old is not None and old.S == pt.S
                    and old.N == pt.N
                    and (old.service_names is pt.service_names
                         or old.service_names == pt.service_names)):
                return i
        return None

    def _stage(self, pt: ProblemTensors, delta: Optional[ProblemDelta],
               warm: bool, stage: Optional[str]):
        """DELTA (in-place merge into the resident state) when the stage's
        slot is compatible with `pt`, else COLD (full staging). Returns
        (slot, resident_warm)."""
        i = self._find(pt, stage)
        if i is None and warm and stage is None:
            # a fleet grown inside its tier (arrivals into phantom rows)
            # has a new S and names: its slot is the keyless one whose
            # staging the delta extends
            i = next((j for j, s in enumerate(self._slots)
                      if s.key is None and s.resident.assignment is not None
                      and s.resident.compatible(pt, delta)), None)
        slot = self._slots[i] if i is not None else None
        if (warm and slot is not None
                and slot.resident.assignment is not None
                and slot.resident.compatible(pt, delta)):
            rp = slot.resident
            if delta is not None:
                rp.apply_delta(pt, delta)
            elif rp.pt is not pt or rp.drifted(pt):
                # in-place mutation of pt.node_valid / capacity: the delta
                # is implicit
                rp.apply_delta(pt, ProblemDelta())
            return slot, True
        resident = ResidentProblem(pt, self.device,
                                   bucket=self.bucket is not False)
        if slot is None:
            slot = _StageSlot(resident=resident, key=stage)
            self._slots.append(slot)
        else:
            slot.resident = resident
        return slot, False

    def place(self, pt: ProblemTensors, *, warm_start: bool = False,
              delta: Optional[ProblemDelta] = None,
              stage: Optional[str] = None) -> Placement:
        """Solve `pt` on the scheduler's device. `delta` is the structured
        churn of a warm reschedule; `stage` keys the resident slot."""
        t0 = time.perf_counter()
        slot, resident_warm = self._stage(pt, delta, warm_start, stage)
        init = None
        if (warm_start and not resident_warm
                and slot.last_assignment is not None
                and slot.last_assignment.shape[0] == pt.S):
            init = slot.last_assignment
        # the slot's own staging decides whether the solve is padded, not a
        # fresh read of FLEET_BUCKET
        res = solve(pt, prob=slot.resident.prob, chains=self.chains,
                    steps=self.steps, seed=self.seed, init_assignment=init,
                    bucket=slot.resident.bucket, resident=slot.resident,
                    resident_warm=resident_warm)
        ms = (time.perf_counter() - t0) * 1e3
        slot.last_assignment = res.assignment
        self.last_result = res
        return Placement(
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

    def reschedule(self, pt: ProblemTensors, *,
                   delta: Optional[ProblemDelta] = None,
                   stage: Optional[str] = None) -> Placement:
        """Warm re-solve after churn: only churn-forced moves happen, and
        with a resident slot the warm seed never leaves the device."""
        return self.place(pt, warm_start=True, delta=delta, stage=stage)
