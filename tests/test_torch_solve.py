"""End-to-end: fleetflow_tpu_torch's GpuSolverScheduler (device="cpu")
against the JAX package's TpuSolverScheduler, on the same seeded fleets:
both unbucketed with the active-set sub-solve off, and both in their
default configuration (bucketed staging with phantom rows, sub-solve on).

The two packages draw different random numbers and the reference's CPU seed
is a host FFD where the port runs the batched greedy, so no assignment or
sweep count is compared. Both must be feasible cold and after a node kill,
with no service left on the dead node. The port's soft score must lie within
SOFT_BAND (relative) of the reference's, and the fraction of services its
warm reschedule moves may exceed the reference's by at most MOVED_MARGIN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from fleetflow_tpu.sched import TpuSolverScheduler
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu_torch.sched import GpuSolverScheduler
from fleetflow_tpu_torch.solver import solve
from fleetflow_tpu_torch.solver.repair import verify
from fleetflow_tpu_torch.solver.resident import ProblemDelta
from test_torch_problem import make_pair

SOFT_BAND = 0.15      # |port - ref| <= 15% of |ref|
MOVED_MARGIN = 0.05   # port moved fraction <= ref moved fraction + 5 points


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_and_node_kill_match_reference_contract(seed, monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    ref_pt, port_pt = make_pair(300, 40, seed)
    ref = TpuSolverScheduler(bucket=False)
    port = GpuSolverScheduler(device="cpu", bucket=False)
    rp, pp = ref.place(ref_pt), port.place(port_pt)
    assert rp.violations == 0 and pp.violations == 0
    assert verify(port_pt, pp.raw)["total"] == 0
    assert abs(pp.soft - rp.soft) <= SOFT_BAND * abs(rp.soft)

    dead = int(np.bincount(pp.raw, minlength=port_pt.N).argmax())
    valid = port_pt.node_valid.copy()
    valid[dead] = False
    rr = ref.reschedule(dataclasses.replace(ref_pt, node_valid=valid.copy()),
                        delta=RefDelta(node_valid=valid.copy()))
    port_pt2 = dataclasses.replace(port_pt, node_valid=valid.copy())
    pr = port.reschedule(port_pt2, delta=ProblemDelta(node_valid=valid))
    assert rr.violations == 0 and pr.violations == 0
    assert verify(port_pt2, pr.raw)["total"] == 0
    assert not (pr.raw == dead).any() and not (rr.raw == dead).any()
    assert abs(pr.soft - rr.soft) <= SOFT_BAND * abs(rr.soft)
    moved_ref = float((rr.raw != rp.raw).mean())
    moved_port = float((pr.raw != pp.raw).mean())
    assert moved_port <= moved_ref + MOVED_MARGIN
    res = port.last_result
    assert res.fused_prerepair and res.telemetry["prerepair_moves"] > 0
    # the resident state made no upload during the warm dispatch
    assert res.warm_h2d_copies == 0


def test_reschedule_sequence_stays_clean():
    """One node down, 5% of nodes down, then a capacity refresh: every
    step feasible, nothing on a dead node, the resident slot reused."""
    _, pt = make_pair(320, 40, 3)
    sched = GpuSolverScheduler(device="cpu")
    first = sched.place(pt)
    assert first.feasible
    slot = sched._slots[0]
    valid = pt.node_valid.copy()
    busiest = np.argsort(-np.bincount(first.raw, minlength=pt.N))
    steps = []
    valid[busiest[0]] = False
    steps.append(ProblemDelta(node_valid=valid.copy()))
    valid[busiest[1:3]] = False
    steps.append(ProblemDelta(node_valid=valid.copy()))
    cap = pt.capacity * np.float32(1.05)
    steps.append(ProblemDelta(node_valid=valid.copy(), capacity=cap))
    for delta in steps:
        kw = {"node_valid": delta.node_valid}
        if delta.capacity is not None:
            kw["capacity"] = delta.capacity
        pt = dataclasses.replace(pt, **kw)
        placed = sched.reschedule(pt, delta=delta)
        assert placed.feasible and placed.violations == 0
        assert pt.node_valid[placed.raw].all()
        assert sched._slots[0] is slot and len(sched._slots) == 1
        assert sched.last_result.warm_h2d_copies == 0
    assert torch.equal(slot.resident.prob.capacity, torch.tensor(cap))


def test_in_place_churn_and_relowered_fleet():
    """A caller that flips pt.node_valid in place gets an implicit delta; a
    fleet with new conflict ids cold-stages and warm-starts from the host."""
    _, pt = make_pair(200, 30, 4)
    sched = GpuSolverScheduler(device="cpu")
    first = sched.place(pt)
    dead = int(first.raw[0])
    pt.node_valid[dead] = False
    again = sched.reschedule(pt)
    assert again.feasible and not (again.raw == dead).any()
    relowered = dataclasses.replace(pt, port_ids=pt.port_ids.copy())
    third = sched.reschedule(relowered)
    assert third.feasible
    assert sched.last_result.fused_prerepair


def test_solve_result_owns_its_assignment():
    """The returned assignment is a copy: a later in-place merge into the
    resident seed must not change it."""
    _, pt = make_pair(150, 20, 5)
    sched = GpuSolverScheduler(device="cpu")
    placed = sched.place(pt)
    kept = placed.raw.copy()
    sched._slots[0].resident.assignment.fill_(0)
    assert np.array_equal(placed.raw, kept)


def test_direct_solve_warm_and_fixed_budget():
    _, pt = make_pair(180, 24, 6)
    cold = solve(pt, device="cpu", seed=1)
    assert cold.feasible and cold.chains == 1 and cold.proposals_per_step == 64
    assert cold.telemetry["schema"][0] == "sweep"
    fixed = solve(pt, device="cpu", adaptive=False, steps=4, chains=2)
    assert fixed.steps == 4 and fixed.accepted_moves == -1
    pt.node_valid[int(cold.assignment[0])] = False
    warm = solve(pt, device="cpu", init_assignment=cold.assignment)
    assert warm.feasible and warm.fused_prerepair
    assert pt.node_valid[warm.assignment].all()


@pytest.mark.parametrize("seed", [0, 1])
def test_default_schedulers_match_reference_contract(seed):
    """Both schedulers as a user creates them (bucketed, sub-solve on): the
    same contract as the unbucketed pair, and the port stages padded."""
    ref_pt, port_pt = make_pair(300, 40, seed)
    ref, port = TpuSolverScheduler(), GpuSolverScheduler(device="cpu")
    rp, pp = ref.place(ref_pt), port.place(port_pt)
    res = port.last_result
    assert rp.violations == 0 and pp.violations == 0
    assert pp.raw.shape == (port_pt.S,)
    assert res.bucket["orig_S"] == 300 and res.bucket["padded_S"] > 300
    assert port._slots[0].resident.prob.S == res.bucket["padded_S"]
    assert abs(pp.soft - rp.soft) <= SOFT_BAND * abs(rp.soft)
    dead = int(np.bincount(pp.raw, minlength=port_pt.N).argmax())
    valid = port_pt.node_valid.copy()
    valid[dead] = False
    rr = ref.reschedule(dataclasses.replace(ref_pt, node_valid=valid.copy()),
                        delta=RefDelta(node_valid=valid.copy()))
    port_pt2 = dataclasses.replace(port_pt, node_valid=valid.copy())
    pr = port.reschedule(port_pt2, delta=ProblemDelta(node_valid=valid))
    assert rr.violations == 0 and pr.violations == 0
    assert verify(port_pt2, pr.raw)["total"] == 0
    assert not (pr.raw == dead).any()
    assert abs(pr.soft - rr.soft) <= SOFT_BAND * abs(rr.soft)
    moved_ref = float((rr.raw != rp.raw).mean())
    moved_port = float((pr.raw != pp.raw).mean())
    assert moved_port <= moved_ref + MOVED_MARGIN
    assert port.last_result.warm_h2d_copies == 0


def test_unbucketed_scheduler_stages_exact_shape():
    _, pt = make_pair(130, 16, 7)
    sched = GpuSolverScheduler(device="cpu", bucket=False)
    placed = sched.place(pt)
    rp = sched._slots[0].resident
    assert placed.feasible and not rp.bucket and rp.prob.S == 130
    assert sched.last_result.bucket is None


def test_bucketed_direct_solve_matches_reference_contract():
    """solve(bucket=True) stages padded, reports the real rows only, and
    its soft score (of the real rows) lies within SOFT_BAND of the
    reference's bucketed solve."""
    from fleetflow_tpu.solver import solve as ref_solve
    from fleetflow_tpu_torch.solver.repair import soft_score_host
    ref_pt, pt = make_pair(210, 24, 8)
    ref = ref_solve(ref_pt, bucket=True, seed=8)
    res = solve(pt, device="cpu", bucket=True, seed=8)
    assert res.feasible and res.assignment.shape == (210,)
    assert res.bucket == {"orig_S": 210, "padded_S": ref.bucket["padded_S"],
                          "pad_waste": ref.bucket["pad_waste"]}
    assert res.soft == pytest.approx(soft_score_host(pt, res.assignment))
    assert abs(res.soft - ref.soft) <= SOFT_BAND * abs(ref.soft)
    warm = solve(pt, device="cpu", bucket=True,
                 init_assignment=res.assignment)
    assert warm.feasible and warm.assignment.shape == (210,)


def test_arrivals_ride_the_delta_into_phantom_rows():
    """A fleet grown inside its tier, with the arrivals sent as a delta
    with n_real, stays on the resident slot and places the arrivals."""
    _, pt = make_pair(150, 20, 9)
    sched = GpuSolverScheduler(device="cpu")
    first = sched.place(pt)
    slot = sched._slots[0]
    prob = slot.resident.prob
    k = 6
    assert pt.S + k <= prob.S
    grow = lambda a: np.concatenate(  # noqa: E731
        [a, np.full((k, a.shape[1]), -1, dtype=a.dtype)])
    dem = np.full((k, 3), 0.02, dtype=np.float32)
    elig = np.ones((k, pt.N), dtype=bool)
    names = [f"new{i}" for i in range(k)]
    pt2 = dataclasses.replace(
        pt, service_names=pt.service_names + names,
        demand=np.concatenate([pt.demand, dem]),
        eligible=np.concatenate([pt.eligible, elig]),
        dep_adj=np.pad(pt.dep_adj, ((0, k), (0, k))),
        dep_depth=np.concatenate([pt.dep_depth,
                                  np.zeros(k, pt.dep_depth.dtype)]),
        port_ids=grow(pt.port_ids), volume_ids=grow(pt.volume_ids),
        anti_ids=grow(pt.anti_ids), coloc_ids=grow(pt.coloc_ids))
    rows = np.arange(pt.S, pt.S + k)
    placed = sched.reschedule(pt2, delta=ProblemDelta(
        demand_rows=(rows, dem), eligible_rows=(rows, elig),
        n_real=pt2.S))
    assert sched._slots == [slot] and slot.resident.prob is prob
    assert prob.n_real == pt2.S
    assert placed.feasible and placed.raw.shape == (pt2.S,)
    assert verify(pt2, placed.raw)["total"] == 0
    assert sched.last_result.warm_h2d_copies == 0
    # the smallest mini tier (256 rows) does not fit under this padded S:
    # the planner sends the arrivals to the full warm path
    assert first.feasible and sched.last_result.subsolve is None
