"""`warm_block` in fleetflow_tpu_torch: a warm solve checks its adaptive
exit every min(warm_block, anneal_block) sweeps, as the JAX package's
``solve`` and ``solve_multiplexed`` do, on every warm route: the full path,
the churn-localized sub-solve and the multiplexer's lanes (batched and
serial). A cold solve keeps ``anneal_block``.

The probe: ``synthetic_problem(100, 10, seed=3)``, its busiest node killed,
a warm start from the cold with ``chains=4, steps=300, seed=4``. With
``anneal_block=64, warm_block=1`` the port must run exactly the solve of
``anneal_block=1``: the same assignment, sweeps and stats.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from fleetflow_tpu.lower import synthetic_problem as ref_synthetic
from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.solver import solve
from fleetflow_tpu_torch.solver.multiplex import MuxEntry, solve_multiplexed
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_problem import CPU


def _killed(pt, assignment):
    """Kill the busiest node of `assignment` in place; returns it."""
    dead = int(np.bincount(assignment, minlength=pt.N).argmax())
    pt.node_valid[dead] = False
    pt.eligible[:, dead] = False
    return dead


def _same_solve(a, b):
    assert np.array_equal(a.assignment, b.assignment)
    assert a.steps == b.steps
    assert a.stats == b.stats
    assert a.soft == b.soft


@pytest.fixture(scope="module")
def probe():
    pt = synthetic_problem(100, 10, seed=3)
    cold = solve(pt, device="cpu", chains=4, steps=300, seed=3)
    dead = _killed(pt, cold.assignment)
    return pt, cold, dead


def _warm(probe, **kw):
    pt, cold, _dead = probe
    return solve(pt, device="cpu", chains=4, steps=300, seed=4,
                 init_assignment=cold.assignment, **kw)


def test_warm_block_bounds_the_full_path(probe):
    fine = _warm(probe, anneal_block=1)
    capped = _warm(probe, anneal_block=64, warm_block=1)
    _same_solve(fine, capped)
    assert capped.feasible and not (capped.assignment == probe[2]).any()
    # without the cap the block decides: the exit waits for 64 sweeps
    coarse = _warm(probe, anneal_block=64, warm_block=64)
    assert coarse.steps == 64 > fine.steps


def test_warm_block_exits_earlier_than_cold_block(probe):
    """tests/test_solver.py::test_warm_block_exits_earlier_than_cold_block
    on the port."""
    pt, _cold, dead = probe
    fine = _warm(probe, warm_block=1)
    coarse = _warm(probe, warm_block=64, anneal_block=64)
    assert fine.feasible and coarse.feasible
    assert fine.steps < coarse.steps
    assert not (fine.assignment == dead).any()


def test_warm_block_matches_reference_sweeps(probe):
    """The reference's probe runs the same number of sweeps with
    anneal_block 1 and 64 under warm_block=1; so does the port."""
    pt_r = ref_synthetic(100, 10, seed=3)
    cold_r = ref_solve(pt_r, chains=4, steps=300, seed=3)
    _killed(pt_r, cold_r.assignment)
    ref = [ref_solve(pt_r, chains=4, steps=300, seed=4,
                     init_assignment=cold_r.assignment, anneal_block=b).steps
           for b in (1, 64)]
    port = [_warm(probe, anneal_block=b).steps for b in (1, 64)]
    assert ref[0] == ref[1] and port[0] == port[1]


def test_cold_solve_keeps_anneal_block():
    pt = synthetic_problem(100, 10, seed=3)
    a = solve(pt, device="cpu", chains=4, steps=300, seed=3,
              anneal_block=8, warm_block=1)
    b = solve(pt, device="cpu", chains=4, steps=300, seed=3,
              anneal_block=8)
    _same_solve(a, b)
    assert a.steps % 8 == 0


def _resident_after_kill(S, N, seed, k):
    """A bucketed resident stage, cold-solved, with its k busiest nodes
    killed through the churn merge."""
    pt = synthetic_problem(S, N, seed=seed, port_fraction=0.25,
                           volume_fraction=0.15)
    rp = ResidentProblem(pt, CPU)
    cold = solve(pt, prob=rp.prob, resident=rp, seed=seed, bucket=True,
                 steps=32, chains=1)
    valid = pt.node_valid.copy()
    valid[np.argsort(-np.bincount(cold.assignment, minlength=N))[:k]] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    return cur, rp


def test_warm_block_bounds_the_subsolve(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
    monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "0.6")
    out = []
    for kw in ({"anneal_block": 1}, {"anneal_block": 64, "warm_block": 1},
               {"anneal_block": 64, "warm_block": 64}):
        cur, rp = _resident_after_kill(140, 14, 5, 2)
        res = solve(cur, prob=rp.prob, resident=rp, resident_warm=True,
                    seed=7, steps=64, chains=1, bucket=True, **kw)
        assert res.subsolve is not None
        assert res.subsolve["outcome"] == "localized"
        out.append(res)
    _same_solve(out[0], out[1])
    assert out[0].steps > 0
    assert out[2].steps == 64 > out[0].steps


def _mux_entries(n, seed0):
    """n resident-warm stages of 60x12, each with its 2 busiest nodes
    killed (every lane sweeps, as the probe printed: 13, 4 and 3 sweeps
    from seed 40 with anneal_block=1)."""
    entries = []
    for i in range(n):
        pt = synthetic_problem(60, 12, seed=seed0 + i, port_fraction=0.3,
                               volume_fraction=0.2)
        rp = ResidentProblem(pt, CPU)
        cold = solve(pt, prob=rp.prob, resident=rp, seed=seed0 + i,
                     steps=32)
        valid = pt.node_valid.copy()
        busiest = np.argsort(-np.bincount(cold.assignment, minlength=12))
        valid[busiest[:2]] = False
        cur = dataclasses.replace(pt, node_valid=valid)
        rp.apply_delta(cur, ProblemDelta(node_valid=valid))
        entries.append(MuxEntry(stage=f"s{i}", pt=cur, resident=rp,
                                seed=seed0 + i))
    return entries


@pytest.mark.parametrize("lanes", [1, 3])
def test_warm_block_bounds_the_mux_lanes(lanes, monkeypatch):
    """Batched lanes (3 stages) and the serial route (1 stage)."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    runs = [solve_multiplexed(_mux_entries(lanes, 40), device="cpu",
                              steps=64, **kw)
            for kw in ({"anneal_block": 1},
                       {"anneal_block": 64, "warm_block": 1},
                       {"anneal_block": 64, "warm_block": 64})]
    for fine, capped, coarse in zip(*runs):
        _same_solve(fine, capped)
        assert coarse.steps >= fine.steps
    assert all(0 < f.steps < c.steps for f, c in zip(runs[0], runs[2]))
