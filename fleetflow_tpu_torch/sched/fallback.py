"""Fallback-policy relaxation: the retry ladder for infeasible placements
(copy of ``fleetflow_tpu/sched/fallback.py``).

When a stage cannot be placed under its full policy, constraint classes
are relaxed in the declared order (``ProblemTensors.relax_order``) and the
solve retried: preferences, spread, then the eligibility classes (tier /
required labels) as a last resort. ``place_with_fallback`` wraps any
Scheduler: it returns the first feasible placement plus the list of
classes that had to be relaxed (empty on a clean solve), and marks
``Placement.source`` so a degraded placement shows at a glance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..lower.tensors import (ELIGIBILITY_RELAX_CLASSES as _ELIG,
                             PREF_RELAX_CLASSES as _PREF,
                             SPREAD_RELAX_CLASSES as _SPREAD,
                             ProblemTensors)
from ..obs import get_logger, kv
from .base import Placement, Scheduler

__all__ = ["place_with_fallback", "relax_problem"]

log = get_logger("sched")


def relax_problem(pt: ProblemTensors, what: str) -> Optional[ProblemTensors]:
    """A copy of `pt` with the `what` constraint class relaxed, or None when
    that class is absent/already relaxed (nothing to retry)."""
    if what in _PREF:
        if pt.preferred is None:
            return None
        return dataclasses.replace(pt, preferred=None)
    if what in _SPREAD:
        if pt.max_skew <= 0:
            return None
        return dataclasses.replace(pt, max_skew=0)
    if what in _ELIG:
        if pt.eligible.all():
            return None
        return dataclasses.replace(
            pt, eligible=np.ones_like(pt.eligible))
    log.warning("unknown fallback class %s", kv(what=what))
    return None


def place_with_fallback(scheduler: Scheduler, pt: ProblemTensors, *,
                        initial: Optional[Placement] = None,
                        place_kwargs: Optional[dict] = None,
                        ) -> tuple[Placement, list[str]]:
    """Solve; on infeasibility walk pt.relax_order, relaxing one class at a
    time (cumulative) and re-solving. Returns (placement, relaxed classes).
    The final placement may still be infeasible when even the fully relaxed
    problem has no solution (capacity and conflicts are physical and never
    relaxed). `initial` skips the first solve when the caller already has
    an (infeasible) result for the un-relaxed problem. `place_kwargs`
    forwards scheduler keywords through the ladder's re-solves (the GPU
    scheduler's `stage=` slot key: without it a relaxed re-solve would land
    in an anonymous slot, and the stage's slot would keep the infeasible
    winner as its warm seed)."""
    kw = place_kwargs or {}
    placement = initial if initial is not None else scheduler.place(pt, **kw)
    relaxed: list[str] = []
    for what in pt.relax_order:
        if placement.feasible:
            break
        pt2 = relax_problem(pt, what)
        if pt2 is None:
            continue
        pt = pt2
        relaxed.append(what)
        log.info("placement infeasible; relaxing %s",
                 kv(what=what, order=",".join(pt.relax_order)))
        placement = scheduler.place(pt, **kw)
    if relaxed:
        placement = dataclasses.replace(
            placement, source=f"{placement.source}+relaxed:{','.join(relaxed)}")
    return placement, relaxed
