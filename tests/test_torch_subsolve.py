"""The active-set sub-solve (fleetflow_tpu_torch/solver/subsolve.py) against
the JAX package on the CPU.

  * the host planner keeps the reference's decisions: closures are
    bit-equal, and the port's lean plan (rows and compact id lists) plus
    K5's plain stage on the same mirror and post-delta staging equal every
    field of the reference's ActivePlan, its frozen base included, exactly
    (also after arrivals into phantom rows, a departed row, without coloc
    ids, with a closure carrying no conflict id, packed and dense, with a
    preference plane)
  * a localized warm solve uploads its plan as one small int32 buffer
  * one sub-solve dispatch that exits at 0 sweeps (the fused pre-repair
    lands feasible, so no random draw is made) gives the reference's new
    assignment and stats exactly, and its soft score within rel 1e-5
    (float32 sums taken in another order)
  * over bursts that sweep, where the random numbers differ, the
    reference's own churn contract holds: the outcome is localized, moved
    rows lie inside the closure, frozen rows are bit-identical, the solve is
    feasible, and the soft score is within 0.1 of the port's full path
  * a gate-rejected sub-solve falls back to the full path and stays
    feasible; FLEET_SUBSOLVE=0 runs no sub-solve
  * K5's plain commit picks the chain as the reference does and never
    writes its input

Small shapes lower the mini-tier floor (FLEET_SUBSOLVE_MIN=16), as the
reference's tests do: at the floor of 256 these fleets never localize.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu.solver import subsolve as ref_sub
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
from fleetflow_tpu_torch.convert import (plan_from_reference,
                                         resident_from_reference)
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.solver import solve
from fleetflow_tpu_torch.solver import subsolve as port_sub
from fleetflow_tpu_torch.solver.buckets import pad_assignment, width_bucket
from fleetflow_tpu_torch.solver.problem import prepare_problem
from fleetflow_tpu_torch.solver.repair import verify
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_buckets import _grown
from test_torch_problem import CPU, make_pair, to_np

SOLVE_KW = dict(steps=32, anneal_block=1, chains=1)
SOFT_RTOL = 1e-5       # one gate's soft score, float32 sums reordered
FULL_SOFT_ATOL = 0.1   # localized vs the port's own full path (reference)
PLAN_FIELDS = ("rows", "n_sub", "tier", "G_sub", "Gc_sub", "sub_conflict",
               "sub_coloc", "load0", "used0", "coloc0", "topo0", "affected")
# the reference plan's fields the port's lean plan carries itself; K5's
# stage builds the rest on the device
LEAN_FIELDS = ("rows", "n_sub", "tier", "G_sub", "Gc_sub", "affected")


@pytest.fixture
def small_tiers(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
    monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "0.6")


def _plan_fields(plan) -> dict:
    return {k: getattr(plan, k) for k in PLAN_FIELDS}


def assert_plan_matches(ref_plan, plan, prob, assignment, staged) -> None:
    """The port's lean `plan`, and K5's plain stage of it on the staging
    `prob` and padded `assignment`, equal every field of the reference's
    ActivePlan exactly, dtype included; `staged` is the plan's buffer."""
    assert np.array_equal(to_np(staged), plan.packed())
    out = port_sub.k5_stage_plain(prob, assignment, staged, plan)
    for k, v in _plan_fields(ref_plan).items():
        w = getattr(plan, k) if k in LEAN_FIELDS else to_np(getattr(out, k))
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and np.array_equal(v, w), k
        else:
            assert v == w, k


def _padded_stage(pt, S_pad: int, packed=None):
    """`pt` staged on the CPU with S_pad rows (phantoms past pt.S) and the
    id tables at their width buckets, as a resident staging holds it."""
    return prepare_problem(pt, CPU, packed=packed,
                           extents=lambda S, K, C, G, Gc: (
                               S_pad, width_bucket(K), width_bucket(C), G,
                               Gc))


def _kill(pt, assignment, valid, pick):
    """(`valid` with one more live node killed, that node): the busiest
    (pick=max) or the least loaded (pick=min) by `assignment`."""
    loads = np.bincount(assignment[: pt.S], minlength=pt.N).astype(float)
    loads[~valid] = np.inf if pick is min else -1.0
    victim = int(loads.argmin() if pick is min else loads.argmax())
    valid = valid.copy()
    valid[victim] = False
    return valid, victim


def test_config_matches_reference(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE", "off")
    monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "0.4")
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "32")
    monkeypatch.setenv("FLEET_SUBSOLVE_MAX", "1024")
    a, b = ref_sub.subsolve_config(), port_sub.subsolve_config()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert port_sub.SUB_OUTCOMES == ref_sub.SUB_OUTCOMES
    assert port_sub.SUB_MAX_STEPS == ref_sub.SUB_MAX_STEPS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closure_bit_equal(seed):
    ref_pt, port_pt = make_pair(160, 16, seed, coloc=True)
    ref_idx, port_idx = ref_sub.ActiveIndex(ref_pt), port_sub.ActiveIndex(
        port_pt)
    rng = np.random.default_rng(seed)
    for size in (1, 5, 20):
        affected = rng.choice(160, size, replace=False)
        a, b = ref_idx.closure(affected), port_idx.closure(affected)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("extras", [{}, {"coloc": True},
                                    {"max_skew": 3, "domains": 4}])
def test_plan_active_bit_equal(extras, small_tiers):
    """The fallback outcomes equal the reference's, and the lean plan plus
    K5's plain stage equal every field of its ActivePlan, given the same
    mirror and pending rows."""
    ref_pt, port_pt = make_pair(150, 15, 3, **extras)
    rng = np.random.default_rng(7)
    S_pad = 160
    mirror = rng.integers(0, 15, S_pad).astype(np.int32)
    valid = port_pt.node_valid.copy()
    valid[[2, 9]] = False
    ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
    port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
    ref_idx, port_idx = ref_sub.ActiveIndex(ref_pt), port_sub.ActiveIndex(
        port_pt)
    T = int(port_pt.node_topology.max()) + 1
    prob = _padded_stage(port_cur, S_pad)
    assert prob.T == T
    for pending, frac in ((np.array([4, 77]), 0.6), (np.empty(0), 0.6),
                          (np.array([1]), 0.01)):
        cfg_r = dataclasses.replace(ref_sub.subsolve_config(), frac=frac)
        cfg_p = dataclasses.replace(port_sub.subsolve_config(), frac=frac)
        pr, out_r = ref_sub.plan_active(ref_idx, ref_cur, mirror, S_pad, T,
                                        pending, cfg_r, G_full=256,
                                        Gc_full=8)
        pp, out_p = port_sub.plan_active(port_idx, port_cur, mirror, S_pad,
                                         T, pending, cfg_p, G_full=256,
                                         Gc_full=8)
        assert out_r == out_p
        assert (pr is None) == (pp is None)
        if pr is None:
            continue
        assert_plan_matches(pr, pp, prob, torch.tensor(mirror),
                            torch.tensor(pp.packed()))


def _ref_resident_after_kill(S, N, seed, pick):
    ref_pt, port_pt = make_pair(S, N, seed)
    ref_rp = RefResident(ref_pt)
    res = ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=seed,
                    bucket=True, **SOLVE_KW)
    assert res.feasible
    valid, _ = _kill(ref_pt, res.assignment, ref_pt.node_valid, pick)
    ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
    port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
    ref_rp.apply_delta(ref_cur, RefDelta(node_valid=valid.copy()))
    return ref_rp, ref_cur, port_cur


@pytest.mark.parametrize("seed", [1, 3])
def test_resident_plan_matches_reference(seed, small_tiers):
    """The port's resident, carrying the reference's mirror after a node
    kill, plans the reference's sub-problem."""
    ref_rp, _ref_cur, port_cur = _ref_resident_after_kill(140, 14, seed,
                                                          max)
    mirror = np.asarray(ref_rp.assignment).copy()
    port_rp = resident_from_reference(port_cur, mirror, True,
                                      pending_rows=np.empty(0), device=CPU)
    pr, pp = ref_rp.take_active_plan(), port_rp.take_active_plan()
    assert pr is not None and pp is not None
    assert_plan_matches(pr, pp, port_rp.prob, port_rp.assignment,
                        port_sub.stage_subsolve(port_rp, pp))
    # the plan is consumed: the next call has nothing pending
    assert port_rp.take_active_plan() is None


def _mirror(pt, S_pad: int, seed: int) -> np.ndarray:
    """A padded assignment with every real row on a random valid node
    eligible for it (no row stranded), phantoms on the first valid node."""
    rng = np.random.default_rng(seed)
    ok = np.asarray(pt.eligible) & np.asarray(pt.node_valid)[None, :]
    real = np.array([rng.choice(np.nonzero(r)[0]) for r in ok],
                    dtype=np.int32)
    return pad_assignment(real, S_pad, np.asarray(pt.node_valid))


def _no_conflict_ids(pt):
    return dataclasses.replace(
        pt, port_ids=np.full_like(pt.port_ids, -1),
        volume_ids=np.full_like(pt.volume_ids, -1),
        anti_ids=np.full_like(pt.anti_ids, -1))


def _sparse_coloc(pt, seed: int):
    """`pt` with one in ten services in one of 30 colocation groups (a
    closure of a few groups, where make_pair's 4 groups take every row)."""
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random((pt.S, 2)) < 0.1,
                   rng.integers(0, 30, (pt.S, 2)), -1).astype(np.int32)
    return dataclasses.replace(pt, coloc_ids=ids)


SCENARIOS = {
    # name: (make_pair extras, FLEET_PACKED)
    "packed": ({"max_skew": 3, "domains": 4}, "1"),
    "dense": ({}, "0"),
    "preferred": ({"preferred": True}, "0"),
    "no_coloc": ({}, "1"),
    "no_conflict_ids": ({}, "1"),
    "arrivals": ({"max_skew": 2, "domains": 3}, "1"),
    "departed": ({}, "0"),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_lean_plan_matches_reference_after_delta(scenario, small_tiers,
                                                 monkeypatch):
    """Both packages' residents carry one mirror and take one delta; the
    reference's plan equals the port's lean plan plus K5's plain stage on
    the port's merged staging, field for field."""
    extras, packed = SCENARIOS[scenario]
    monkeypatch.setenv("FLEET_PACKED", packed)
    ref_pt, port_pt = make_pair(140, 14, 11, **extras)
    if scenario != "no_coloc":
        ref_pt, port_pt = _sparse_coloc(ref_pt, 11), _sparse_coloc(port_pt, 11)
    if scenario == "no_conflict_ids":
        ref_pt, port_pt = (_no_conflict_ids(ref_pt),
                           _no_conflict_ids(port_pt))
    port_rp = ResidentProblem(port_pt, CPU)
    mirror = _mirror(port_pt, port_rp.prob.S, 11)
    port_rp = resident_from_reference(port_pt, mirror, True, device=CPU)
    ref_rp = RefResident(ref_pt)
    ref_rp.adopt_host(mirror[:port_pt.S], port_pt.node_valid, warm=False)
    ref_rp.note_host_assignment(padded=mirror.copy(), feasible=True)
    assert np.array_equal(np.asarray(ref_rp.assignment), mirror)

    valid = port_pt.node_valid.copy()
    valid[np.bincount(mirror[:port_pt.S], minlength=14).argmax()] = False
    kw = dict(node_valid=valid)
    ref_next, port_next = ref_pt, port_pt
    if scenario == "arrivals":
        ref_next, ref_kw = _grown(ref_pt, 5, 14)
        port_next, port_kw = _grown(port_pt, 5, 14)
        kw.update(port_kw)
    if scenario == "departed":
        gone = np.array([7, 60], dtype=np.int32)
        dem = np.zeros((2, 3), np.float32)
        elig = np.ones((2, 14), dtype=bool)
        for p in (ref_next, port_next):
            p.demand[gone], p.eligible[gone] = dem, elig
        kw.update(demand_rows=(gone, dem), eligible_rows=(gone, elig))
    ref_cur = dataclasses.replace(ref_next, node_valid=valid.copy())
    port_cur = dataclasses.replace(port_next, node_valid=valid.copy())
    ref_rp.apply_delta(ref_cur, RefDelta(**kw))
    port_rp.apply_delta(port_cur, ProblemDelta(**kw))
    if scenario == "arrivals":
        # the arrivals took the delta path into phantom rows, which carry
        # no ids on the card (so the frozen base counts none for them)
        assert port_rp.prob.n_real == port_cur.S > port_pt.S
        new = slice(port_pt.S, port_cur.S)
        assert bool((port_rp.prob.conflict_ids[new] == -1).all())
        assert bool((port_rp.prob.coloc_ids[new] == -1).all())

    pr, pp = ref_rp.take_active_plan(), port_rp.take_active_plan()
    assert pr is not None and pp is not None
    assert pp.n_real == port_cur.S
    if scenario == "arrivals":
        assert (pp.rows[:pp.n_sub] >= port_pt.S).sum() == 5
    if scenario == "no_coloc":
        assert pp.Gc_sub == 0 and pr.coloc0.shape == (14, 1)
    else:
        assert len(pp.coloc_ids) and pr.coloc0.any()
    if scenario == "no_conflict_ids":
        assert len(pp.conf_ids) == 0 and not pr.used0.any()
    assert_plan_matches(pr, pp, port_rp.prob, port_rp.assignment,
                        port_sub.stage_subsolve(port_rp, pp))


def test_localized_solve_uploads_one_small_buffer(monkeypatch, small_tiers):
    """A localized warm solve stages its sub-solve with one counted upload
    of O(tier + G_sub + Gc_sub) int32s: no (N, ·) plane crosses."""
    pt = _sparse_coloc(make_pair(140, 14, 2)[1], 2)
    rp = ResidentProblem(pt, CPU)
    res = solve(pt, prob=rp.prob, resident=rp, seed=2, bucket=True,
                **SOLVE_KW)
    valid, _ = _kill(pt, res.assignment, pt.node_valid, max)
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    seen = []
    real_stage = port_sub.stage_subsolve

    def stage(resident, plan):
        real_upload = resident.upload

        def upload(arr, dtype):
            seen.append((np.asarray(arr).shape, dtype))
            return real_upload(arr, dtype)

        monkeypatch.setattr(resident, "upload", upload)
        before = resident.h2d_copies
        try:
            out = real_stage(resident, plan)
        finally:
            monkeypatch.setattr(resident, "upload", real_upload)
        seen.append(("plan", plan, resident.h2d_copies - before))
        return out

    monkeypatch.setattr(port_sub, "stage_subsolve", stage)
    r = solve(cur, prob=rp.prob, resident=rp, resident_warm=True, seed=5,
              bucket=True, **SOLVE_KW)
    assert r.subsolve is not None and r.subsolve["outcome"] == "localized"
    assert len(seen) == 2
    (shape, dtype), (_, plan, copies) = seen
    assert copies == 1 and dtype == torch.int32
    assert shape == (plan.tier + len(plan.conf_ids) + len(plan.coloc_ids),)
    assert shape[0] <= plan.tier + plan.G_sub + plan.Gc_sub


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_zero_sweep_subsolve_matches_reference(seed, small_tiers):
    """A one-node kill whose pre-repair lands feasible: both packages'
    sub-solve on the same plan give the same new assignment and stats."""
    ref_rp, _ref_cur, port_cur = _ref_resident_after_kill(140, 14, seed,
                                                          min)
    mirror = np.asarray(ref_rp.assignment).copy()
    plan = ref_rp.take_active_plan()
    assert plan is not None
    staged = ref_sub.stage_subsolve(ref_rp, plan)
    f32 = jnp.float32
    new_r, stats_r, soft_r, sweeps_r, _acc, _tel = ref_sub.subsolve_dispatch(
        ref_rp.prob, ref_rp.assignment, staged, plan,
        jax.random.PRNGKey(0), f32(0.1), f32(1e-3), f32(0.5), chains=1,
        steps=32, block=1, proposals_per_step=16)
    assert int(sweeps_r) == 0

    port_rp = resident_from_reference(port_cur, mirror, True, device=CPU)
    p_plan, p_staged = plan_from_reference(_plan_fields(plan), port_cur,
                                           device=CPU)
    assert_plan_matches(plan, p_plan, port_rp.prob, port_rp.assignment,
                        p_staged)
    gen = torch.Generator()
    gen.manual_seed(0)
    before = port_rp.assignment.clone()
    new_p, stats_p, soft_p, sweeps_p, _acc, _tel = port_sub.subsolve_dispatch(
        port_rp.prob, port_rp.assignment, p_staged, p_plan, gen, 0.1, 1e-3,
        0.5, chains=1, steps=32, block=1, proposals_per_step=16)
    assert sweeps_p == 0
    assert np.array_equal(np.asarray(new_r), to_np(new_p))
    assert not np.array_equal(to_np(new_p), to_np(before))
    # the commit wrote a fresh tensor: the resident seed is untouched
    assert torch.equal(port_rp.assignment, before)
    for k in stats_p:
        assert float(stats_r[k]) == float(stats_p[k]) == 0.0, k
    assert float(soft_p) == pytest.approx(float(soft_r), rel=SOFT_RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_churn_sequence_parity(seed, monkeypatch, small_tiers):
    """The reference's churn contract (test_subsolve.py
    test_churn_sequence_parity) on the port, on the reference test's
    fleets: three kills of the busiest live node, the third also reviving
    the first dead node."""
    pt = synthetic_problem(140, 14, seed=seed, port_fraction=0.25,
                           volume_fraction=0.15)
    rp = ResidentProblem(pt, CPU)
    res = solve(pt, prob=rp.prob, resident=rp, seed=seed, bucket=True,
                **SOLVE_KW)
    assert res.feasible
    ptf = dataclasses.replace(pt)
    rpf = ResidentProblem(ptf, CPU)
    solve(ptf, prob=rpf.prob, resident=rpf, seed=seed, bucket=True,
          **SOLVE_KW)
    valid = pt.node_valid.copy()
    prev = res.assignment
    for step in range(3):
        valid, victim = _kill(pt, prev, valid, max)
        if step == 2 and len(np.nonzero(~valid)[0]) >= 2:
            revive = int(np.nonzero(~valid)[0][0])
            if revive != victim:
                valid[revive] = True
        cur = dataclasses.replace(pt, node_valid=valid.copy())
        rp.apply_delta(cur, ProblemDelta(node_valid=valid.copy()))
        r = solve(cur, prob=rp.prob, resident=rp, resident_warm=True,
                  seed=50 + step, bucket=True, **SOLVE_KW)
        assert r.subsolve is not None
        assert r.subsolve["outcome"] == "localized"
        assert r.feasible and verify(cur, r.assignment)["total"] == 0
        moved = np.nonzero(r.assignment != prev)[0]
        assert moved.size <= r.subsolve["rows"]
        allowed = port_sub.ActiveIndex(cur).closure(
            np.nonzero(~valid[prev])[0])
        assert set(moved.tolist()) <= set(allowed.tolist())
        frozen = np.setdiff1d(np.arange(pt.S), allowed)
        np.testing.assert_array_equal(r.assignment[frozen], prev[frozen])
        prev = r.assignment
        pt = cur

        curf = dataclasses.replace(ptf, node_valid=valid.copy())
        rpf.apply_delta(curf, ProblemDelta(node_valid=valid.copy()))
        with monkeypatch.context() as m:
            m.setenv("FLEET_SUBSOLVE", "0")
            rf = solve(curf, prob=rpf.prob, resident=rpf,
                       resident_warm=True, seed=50 + step, bucket=True,
                       **SOLVE_KW)
        assert rf.subsolve is None
        assert r.feasible == rf.feasible
        assert abs(r.soft - rf.soft) < FULL_SOFT_ATOL
        ptf = curf


def test_gate_rejection_falls_back_to_full_path(monkeypatch, small_tiers):
    """A sub-solve the exact gate rejects is discarded: the full path
    re-runs from the untouched resident seed and lands feasible."""
    _, pt = make_pair(140, 14, 1)
    rp = ResidentProblem(pt, CPU)
    res = solve(pt, prob=rp.prob, resident=rp, seed=1, bucket=True,
                **SOLVE_KW)
    real_gate = port_sub.exact_stats_and_soft

    def rejecting_gate(prob, assignment):
        stats, soft = real_gate(prob, assignment)
        return dict(stats, total=torch.ones((), dtype=torch.float32)), soft

    monkeypatch.setattr(port_sub, "exact_stats_and_soft", rejecting_gate)
    valid, _ = _kill(pt, res.assignment, pt.node_valid, max)
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    outcomes = REGISTRY.get("fleet_solver_subsolve_total")
    before = outcomes.value(outcome="fallback_infeasible")
    r = solve(cur, prob=rp.prob, resident=rp, resident_warm=True, seed=5,
              bucket=True, **SOLVE_KW)
    assert r.subsolve["outcome"] == "fallback_infeasible"
    assert r.telemetry["path"] == "full"
    assert outcomes.value(outcome="fallback_infeasible") == before + 1
    assert r.feasible and r.pre_repair_violations == 0
    assert valid[r.assignment].all()
    assert "subsolve_ms" in r.timings_ms


def test_subsolve_off_runs_full_path(monkeypatch, small_tiers):
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    _, pt = make_pair(140, 14, 2)
    rp = ResidentProblem(pt, CPU)
    res = solve(pt, prob=rp.prob, resident=rp, seed=2, bucket=True,
                **SOLVE_KW)
    valid, _ = _kill(pt, res.assignment, pt.node_valid, max)
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    r = solve(cur, prob=rp.prob, resident=rp, resident_warm=True, seed=3,
              bucket=True, **SOLVE_KW)
    assert r.subsolve is None and r.feasible
    assert "subsolve_ms" not in r.timings_ms


@pytest.mark.parametrize("viol,soft,best", [
    ([2.0, 0.0, 0.0], [-9.0, 1.0, 0.5], 2),     # least violations, then soft
    ([1.0, 1.0, 3.0], [0.25, 0.25, -5.0], 0),   # full tie: the first chain
    ([0.0, 0.0], [float("inf"), float("inf")], 0),
    ([1.0, 0.0], [0.0, float("inf")], 0),       # the reference's inf keys
])
def test_k5_commit_plain_matches_reference(viol, soft, best):
    """The chain pick and the scatter of K5's plain commit against the
    reference's argmin and .at[rows].set(mode='drop'); the input
    assignment is left as it was."""
    rng = np.random.default_rng(len(viol))
    S, tier, C = 50, 16, len(viol)
    rows = np.full(tier, S, dtype=np.int32)
    rows[:11] = np.sort(rng.choice(S, 11, replace=False))
    best_assign = rng.integers(0, 9, (C, tier)).astype(np.int32)
    assignment = rng.integers(0, 9, S).astype(np.int32)
    v, s = np.asarray(viol, np.float32), np.asarray(soft, np.float32)
    ref_best = int(jnp.argmin(jnp.where(v == v.min(), s, jnp.inf)))
    ref_new = np.asarray(jnp.asarray(assignment).at[jnp.asarray(rows)].set(
        jnp.asarray(best_assign[ref_best]), mode="drop"))
    a_t = torch.tensor(assignment)
    new, b = port_sub.k5_commit(torch.tensor(best_assign), torch.tensor(v),
                                torch.tensor(s), torch.tensor(rows), a_t)
    assert ref_best == best == int(b[0])
    assert np.array_equal(to_np(new), ref_new)
    assert np.array_equal(to_np(a_t), assignment)
