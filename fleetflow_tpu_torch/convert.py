"""Carry state across from the JAX package, as plain numpy arrays.

The reference's ``DeviceProblem`` (padded or not, or K of them stacked on a
lane axis), ``ChainState``, ``ProblemTensors``, ``ActivePlan``, resident
sub-solve mirror and sharded anneal state, read out with ``np.asarray``,
become the port's ``TorchProblem``, ``ChainState``, ``ProblemTensors``,
``ActivePlan``, ``ResidentProblem`` and replica state, so both packages
compute on the same data. This
module imports nothing of the reference: the caller hands over arrays and
statics. The reference's uint32 eligibility words become int32 words with
the same bits. Device tensors land on the card unless the caller names the
CPU.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .core.model import PlacementStrategy
from .device import resolve_device
from .lower.tensors import ProblemTensors
from .solver.anneal import ChainState
from .solver.buckets import BucketInfo, width_bucket
from .solver.multiplex import stack_problems
from .solver.problem import TorchProblem, unify_conflict_ids
from .solver.resident import ResidentProblem
from .solver.subsolve import ActivePlan, closure_ids

__all__ = ["problem_from_reference", "padded_problem_from_reference",
           "stacked_problem_from_reference",
           "state_from_reference", "tensors_from_reference",
           "plan_from_reference", "resident_from_reference",
           "sharded_from_reference"]

PROBLEM_ARRAYS = ("demand", "capacity", "conflict_ids", "coloc_ids",
                  "eligible", "node_valid", "node_topology")
PROBLEM_STATICS = ("S", "N", "G", "Gc", "T", "strategy", "max_skew")
_DTYPES = {"demand": torch.float32, "capacity": torch.float32,
           "conflict_ids": torch.int32, "coloc_ids": torch.int32,
           "node_valid": torch.bool, "node_topology": torch.int32}


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(arr), dtype=dtype, device=device)


def _eligible(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        return _tensor(arr, torch.bool, device)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return _tensor(arr, torch.int32, device)


def problem_from_reference(arrays: Mapping[str, np.ndarray],
                           statics: Mapping[str, int],
                           device=None) -> TorchProblem:
    """A TorchProblem from a DeviceProblem's fields: `arrays` holds the
    PROBLEM_ARRAYS (plus optional preferred, n_real, sticky_prev,
    sticky_w), `statics` the PROBLEM_STATICS. The tensors land on the card
    unless `device` names the CPU (raises without CUDA, as solve does)."""
    device = resolve_device(device)
    kw = {name: _tensor(arrays[name], dt, device)
          for name, dt in _DTYPES.items()}
    kw["eligible"] = _eligible(arrays["eligible"], device)
    kw.update({k: int(statics[k]) for k in PROBLEM_STATICS})
    pref = arrays.get("preferred")
    kw["preferred"] = (None if pref is None
                       else _tensor(pref, torch.float32, device))
    n_real = arrays.get("n_real")
    kw["n_real"] = None if n_real is None else int(np.asarray(n_real))
    prev = arrays.get("sticky_prev")
    if prev is not None:
        kw["sticky_prev"] = _tensor(prev, torch.int32, device)
        kw["sticky_w"] = float(np.asarray(arrays["sticky_w"]))
    return TorchProblem(**kw)


def stacked_problem_from_reference(
        arrays_per_lane: Sequence[tuple[Mapping[str, np.ndarray],
                                        Mapping[str, int]]],
        device=None) -> TorchProblem:
    """One lane-stacked TorchProblem from K reference DeviceProblems' fields
    (one (arrays, statics) pair per lane, as for
    :func:`problem_from_reference`). Raises ValueError on lanes of
    different tiers, as the reference's ``stack_problems`` does. On the
    card unless `device` names the CPU."""
    return stack_problems([problem_from_reference(arrays, statics, device)
                           for arrays, statics in arrays_per_lane])


def state_from_reference(assignment: np.ndarray, load: np.ndarray,
                         used: np.ndarray, coloc: np.ndarray,
                         topo: np.ndarray, device=None) -> ChainState:
    """A ChainState from one reference chain state ((S,), (N,R), ...) or a
    vmapped one ((C,S), (C,N,R), ...), on the card unless `device` names
    the CPU."""
    device = resolve_device(device)
    arrs = [np.asarray(x) for x in (assignment, load, used, coloc, topo)]
    if arrs[0].ndim == 1:
        arrs = [x[None] for x in arrs]
    dts = (torch.int32, torch.float32, torch.int32, torch.int32, torch.int32)
    return ChainState(*(_tensor(x, dt, device) for x, dt in zip(arrs, dts)))


def tensors_from_reference(fields: Mapping[str, object],
                           strategy: Optional[str] = None) -> ProblemTensors:
    """The port's ProblemTensors from the reference's fields (arrays as
    numpy, names as lists, `strategy` as its string value), every array
    and list copied: the preference plane, the spread constraint and the
    relax order come across with the rest."""
    kw = dict(fields)
    for name in ("demand", "capacity", "preferred"):
        if kw.get(name) is not None:
            kw[name] = np.array(kw[name], dtype=np.float32, copy=True)
    for name in ("dep_depth", "port_ids", "volume_ids", "anti_ids",
                 "coloc_ids", "node_topology"):
        kw[name] = np.array(kw[name], dtype=np.int32, copy=True)
    for name in ("dep_adj", "eligible", "node_valid"):
        kw[name] = np.array(kw[name], dtype=bool, copy=True)
    for name in ("service_names", "node_names", "replica_of", "relax_order"):
        if name in kw:
            kw[name] = list(kw[name])
    if strategy is not None:
        kw["strategy"] = PlacementStrategy(strategy)
    elif "strategy" in kw:
        kw["strategy"] = PlacementStrategy(getattr(kw["strategy"], "value",
                                                   kw["strategy"]))
    return ProblemTensors(**kw)


def padded_problem_from_reference(arrays: Mapping[str, np.ndarray],
                                  statics: Mapping[str, int], orig_S: int,
                                  device=None
                                  ) -> tuple[TorchProblem, BucketInfo]:
    """A padded reference DeviceProblem (staged on its tier ladder, with
    n_real) as the port's padded TorchProblem, with the BucketInfo of a
    staging of `orig_S` real rows."""
    prob = problem_from_reference(arrays, statics, device=device)
    if prob.S > orig_S and prob.n_real is None:
        raise ValueError("a padded problem needs its n_real")
    return prob, BucketInfo(orig_S=int(orig_S), padded_S=prob.S, G=prob.G,
                            Gc=prob.Gc)


PLAN_INTS = ("n_sub", "tier", "G_sub", "Gc_sub", "affected")


def plan_from_reference(fields: Mapping[str, object], pt: ProblemTensors,
                        device=None) -> tuple[ActivePlan, torch.Tensor]:
    """A reference ActivePlan's fields as the port's lean ActivePlan, and
    its buffer staged for one sub-solve dispatch as
    ``subsolve.stage_subsolve`` gives it, on the card unless `device`
    names the CPU. `pt` is the staging the plan was made on: the compact
    id lists come from its closure rows, as ``plan_active`` takes them,
    and its real rows bound the frozen base. The reference's base and
    remapped ids are not carried: K5 builds them on the device."""
    device = resolve_device(device)
    kw = {k: int(fields[k]) for k in PLAN_INTS}
    rows = np.array(fields["rows"], dtype=np.int32, copy=True)
    conflict = unify_conflict_ids(pt)
    coloc = np.asarray(pt.coloc_ids, dtype=np.int32)
    conf_ids, coloc_ids = closure_ids(conflict, coloc,
                                      rows[:kw["n_sub"]].astype(np.int64))
    plan = ActivePlan(rows=rows, conf_ids=conf_ids.astype(np.int32),
                      coloc_ids=coloc_ids.astype(np.int32), n_real=pt.S,
                      Kc=width_bucket(conflict.shape[1], 4),
                      Cc=width_bucket(coloc.shape[1], 4), **kw)
    return plan, _tensor(plan.packed(), torch.int32, device)


def resident_from_reference(pt: ProblemTensors, mirror: np.ndarray,
                            feasible: bool,
                            pending_rows: Optional[np.ndarray] = None, *,
                            bucket: bool = True,
                            device=None) -> ResidentProblem:
    """The port's ResidentProblem of the fleet `pt` (staged as the
    reference stages it), carrying the reference's sub-solve mirror: the
    padded host assignment `mirror` becomes the device assignment and the
    mirror, `feasible` the frozen-base precondition and `pending_rows` the
    churn pending since the mirror's solve. On the card unless `device`
    names the CPU."""
    rp = ResidentProblem(pt, resolve_device(device), bucket=bucket)
    padded = np.array(mirror, dtype=np.int32, copy=True)
    if padded.shape != (rp.prob.S,):
        raise ValueError(f"mirror of {padded.shape} rows for a staging of "
                         f"{rp.prob.S}")
    rp.assignment = rp.upload(padded, torch.int32)
    rp.note_host_assignment(padded=padded, feasible=feasible)
    if pending_rows is not None:
        rp._pending_rows = np.asarray(pending_rows, dtype=np.int64)
        rp._pending_churn = True
    return rp


def sharded_from_reference(arrays: Mapping[str, np.ndarray],
                           statics: Mapping[str, int],
                           assignment: np.ndarray, load: np.ndarray,
                           used: np.ndarray, coloc: np.ndarray,
                           topo: np.ndarray, device=None
                           ) -> tuple[TorchProblem, ChainState]:
    """The reference's sharded anneal state as the port's: `arrays` and
    `statics` the padded (S, ·) problem (as for
    :func:`problem_from_reference`), `assignment` the per-shard assignment
    of each replica ((D, S/D), or (R, D, S/D) on a mesh with a replica
    axis: the shard_map's P(SVC_AXIS) blocks in shard order), and the
    replicated node state of each replica ((N, R) load, (N, G), (N, Gc),
    (T,), or the same with a leading (R,) axis). Returns the problem and
    the (R, ...) replica state that ``anneal_sharded(init_state=...)`` and
    the K7 wrappers take; on the card unless `device` names the CPU."""
    prob = problem_from_reference(arrays, statics, device=device)
    a = np.asarray(assignment, dtype=np.int32)
    if a.ndim == 2:
        a = a[None]
    if a.ndim != 3 or a.shape[1] * a.shape[2] != prob.S:
        raise ValueError(f"per-shard assignment of shape {a.shape} for "
                         f"S={prob.S}")
    planes = [np.asarray(x) for x in (load, used, coloc, topo)]
    if planes[0].ndim == 2:
        planes = [x[None] for x in planes]
    if any(x.shape[0] != a.shape[0] for x in planes):
        raise ValueError("one node state per replica")
    return prob, state_from_reference(a.reshape(a.shape[0], prob.S),
                                      *planes, device=device)
