"""The solver options of fleetflow_tpu_torch that the JAX package has
beside its main path, held against fleetflow_tpu on the CPU with the same
seeded inputs:

- ``overlap_host_work``, a zero-argument callable run once a call, after
  the solve's last launch and before the first host read of its result,
  on every route: a cold ``solve``, the resident-warm full path
  (FLEET_SUBSOLVE=0), the resident-warm sub-solve, ``solve_sharded`` on a
  1x8 mesh, the FLEET_SHARDED=1 route and the scheduler's
  ``place``/``reschedule``. Its time is ``timings_ms["overlap_host_ms"]``
  (as in the reference on the same route) and never sub-solve time: the
  solver's clock is a fake that jumps inside the callable, so the check
  is no timing race. The result is bit-equal to the call without it, and
  an exception from it propagates;
- ``do_repair=False`` through ``solve``, a resident, ``solve_sharded`` and
  ``solve_multiplexed`` (batched lanes and its serial path) on an
  instance the device cannot make feasible: the violations are the
  device winner's, equal to the host ``verify``, with 0 moves, in both
  packages; ``do_repair=True`` is the host repair of that winner;
- the sharded anneal's proposal width (``proposals_per_step``) given the
  reference's ``jax.random`` draws at that width, bit for bit;
- K6's strict mode (``greedy_place(best_effort=False)``): a service with
  no feasible node goes to node 0, as the reference's argmax of an
  all-``_NEG`` row puts it;
- ``SolveResult.acceptance_rate`` and ``Placement.services_on``.
"""

from __future__ import annotations

import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import fleetflow_tpu.solver as ref_solver_pkg
from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synthetic
from fleetflow_tpu.sched.base import Placement as RefPlacement
from fleetflow_tpu.sched.base import level_schedule as ref_levels
from fleetflow_tpu.sched.tpu import TpuSolverScheduler
from fleetflow_tpu.solver import greedy as ref_greedy
from fleetflow_tpu.solver import multiplex as ref_mux
from fleetflow_tpu.solver import problem as ref_problem
from fleetflow_tpu.solver import sharded as ref_sh
from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu.solver.api import SolveResult as RefSolveResult
from fleetflow_tpu.solver.repair import verify as ref_verify
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.sched import GpuSolverScheduler
from fleetflow_tpu_torch.sched.base import Placement, level_schedule
from fleetflow_tpu_torch.solver import api
from fleetflow_tpu_torch.solver import greedy as port_greedy
from fleetflow_tpu_torch.solver import problem as port_problem
from fleetflow_tpu_torch.solver import sharded as sh
from fleetflow_tpu_torch.solver.api import SolveResult, solve
from fleetflow_tpu_torch.solver.buckets import pad_problem as port_pad
from fleetflow_tpu_torch.solver.multiplex import MuxEntry, solve_multiplexed
from fleetflow_tpu_torch.solver.repair import repair, verify
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_problem import CPU, STRATEGIES, make_pair, to_np
from test_torch_sharded import (ANNEAL_CASES, CPU8, JaxDraws, _check_stats,
                                _meshes, _need_devices)

# the fake clock's jump inside the callable: far above any real phase here
JUMP_S = 1000.0
STEPS = 32


def _pair(S, N, seed, **kw):
    return (ref_synthetic(S, N, seed=seed, **kw),
            synthetic_problem(S, N, seed=seed, **kw))


def _kill_busiest(pt, assignment, k=1, valid=None):
    valid = (pt.node_valid if valid is None else valid).copy()
    load = np.bincount(assignment, minlength=pt.N) * valid
    valid[np.argsort(-load)[:k]] = False
    return valid


class FakeClock:
    """``time`` for the solver modules: the real perf_counter plus an
    offset that a callable moves."""

    def __init__(self):
        self.offset = 0.0

    def perf_counter(self) -> float:
        return time.perf_counter() + self.offset

    def module(self):
        return types.SimpleNamespace(perf_counter=self.perf_counter)


class Overlap:
    """A zero-argument callable that counts its calls and, given a clock,
    jumps it by JUMP_S (host work that takes that long)."""

    def __init__(self, clock: FakeClock | None = None):
        self.calls = 0
        self.clock = clock

    def __call__(self) -> None:
        self.calls += 1
        if self.clock is not None:
            self.clock.offset += JUMP_S


def _same(a, b) -> None:
    assert np.array_equal(a.assignment, b.assignment)
    assert a.stats == b.stats and a.soft == b.soft and a.steps == b.steps
    assert a.feasible == b.feasible


# -- the overlap contract, route by route --------------------------------

SUBSOLVE_ENV = {"FLEET_SUBSOLVE_MIN": "16", "FLEET_SUBSOLVE_FRAC": "0.6"}
ROUTES = ("cold", "resident_full", "resident_subsolve", "sharded_1x8",
          "sharded_route", "scheduler")


def _port_route(route, cb, monkeypatch):
    """Run `route` on the port with `cb` (None: without it); returns the
    results whose timings the contract reads (the last one is the call
    under test) and the count of calls that took the callable."""
    _, pt = _pair(140, 14, 5, port_fraction=0.25, volume_fraction=0.15)
    kw = dict(overlap_host_work=cb) if cb is not None else {}
    if route == "cold":
        return [solve(pt, device="cpu", chains=2, steps=STEPS, seed=3,
                      **kw)], 1
    if route.startswith("resident"):
        rp = ResidentProblem(pt, CPU)
        solve_kw = dict(steps=STEPS, chains=1, bucket=True)
        cold = solve(pt, prob=rp.prob, resident=rp, seed=5, **solve_kw)
        valid = _kill_busiest(pt, cold.assignment, 2)
        cur = dataclasses.replace(pt, node_valid=valid)
        rp.apply_delta(cur, ProblemDelta(node_valid=valid.copy()))
        return [solve(cur, prob=rp.prob, resident=rp, resident_warm=True,
                      seed=7, **solve_kw, **kw)], 1
    if route == "sharded_1x8":
        rp = sh.ShardedResident(pt, mesh=sh.Mesh(CPU8, (sh.SVC_AXIS,)))
        return [sh.solve_sharded(pt, resident=rp, steps=STEPS, block=4,
                                 seed=3, **kw)], 1
    if route == "sharded_route":
        monkeypatch.setenv("FLEET_SHARDED", "1")
        monkeypatch.setattr(sh, "visible_devices", lambda: CPU8)
        res = solve(pt, steps=16, seed=3, **kw)
        assert res.tempering is not None
        return [res], 1
    sched = GpuSolverScheduler(chains=1, steps=STEPS, device="cpu")
    sched.place(pt, stage="s", **kw)
    first = sched.last_result
    valid = _kill_busiest(pt, first.assignment, 2)
    cur = dataclasses.replace(pt, node_valid=valid)
    sched.reschedule(cur, delta=ProblemDelta(node_valid=valid.copy()),
                     stage="s", **kw)
    return [first, sched.last_result], 2


def _ref_route(route, cb, monkeypatch):
    """The reference's results on `route` with `cb`."""
    ref_pt, _ = _pair(140, 14, 5, port_fraction=0.25, volume_fraction=0.15)
    if route == "cold":
        return [ref_solve(ref_pt, chains=2, steps=STEPS, seed=3,
                          overlap_host_work=cb)]
    if route.startswith("resident"):
        rp = RefResident(ref_pt)
        solve_kw = dict(steps=STEPS, chains=1, bucket=True)
        cold = ref_solve(ref_pt, prob=rp.prob, resident=rp, seed=5,
                         **solve_kw)
        valid = _kill_busiest(ref_pt, cold.assignment, 2)
        cur = dataclasses.replace(ref_pt, node_valid=valid)
        rp.apply_delta(cur, RefDelta(node_valid=valid.copy()))
        return [ref_solve(cur, prob=rp.prob, resident=rp,
                          resident_warm=True, seed=7, overlap_host_work=cb,
                          **solve_kw)]
    if route == "sharded_1x8":
        mesh = JaxMesh(np.array(jax.devices()[:8]), (ref_sh.SVC_AXIS,))
        rp = ref_sh.ShardedResident(ref_pt, mesh=mesh)
        return [ref_sh.solve_sharded(ref_pt, resident=rp, steps=STEPS,
                                     block=4, seed=3, overlap_host_work=cb)]
    if route == "sharded_route":
        monkeypatch.setenv("FLEET_SHARDED", "1")
        res = ref_solve(ref_pt, steps=16, seed=3, overlap_host_work=cb)
        assert res.tempering is not None
        return [res]
    # the scheduler solves through fleetflow_tpu.solver.solve: keep what
    # it returns
    seen = []
    inner = ref_solver_pkg.solve

    def keep(*a, **k):
        seen.append(inner(*a, **k))
        return seen[-1]

    monkeypatch.setattr(ref_solver_pkg, "solve", keep)
    sched = TpuSolverScheduler(chains=1, steps=STEPS)
    p = sched.place(ref_pt, stage="s", overlap_host_work=cb)
    valid = _kill_busiest(ref_pt, p.raw, 2)
    cur = dataclasses.replace(ref_pt, node_valid=valid)
    sched.reschedule(cur, delta=RefDelta(node_valid=valid.copy()),
                     stage="s", overlap_host_work=cb)
    return seen


@pytest.mark.parametrize("route", ROUTES)
def test_overlap_contract(route, monkeypatch):
    if route.startswith("sharded"):
        _need_devices(8)
    if route == "resident_full":
        monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    if route == "resident_subsolve":
        for k, v in SUBSOLVE_ENV.items():
            monkeypatch.setenv(k, v)
    clock = FakeClock()
    monkeypatch.setattr(api, "time", clock.module())
    monkeypatch.setattr(sh, "time", clock.module())
    plain, _ = _port_route(route, None, monkeypatch)
    cb = Overlap(clock)
    got, calls = _port_route(route, cb, monkeypatch)
    # once a call, on the calling thread
    assert cb.calls == calls
    for a, b in zip(plain, got):
        _same(a, b)
        assert "overlap_host_ms" not in a.timings_ms
        t = b.timings_ms
        assert t["overlap_host_ms"] >= JUMP_S * 1e3
        # the overlapped host work is not sub-solve time, but it is inside
        # the anneal's and the call's
        assert t.get("subsolve_ms", 0.0) < JUMP_S * 1e3 / 2
        assert t["anneal_ms"] >= t["overlap_host_ms"]
        assert t["total_ms"] >= t["anneal_ms"]
    if route == "resident_subsolve":
        assert got[0].subsolve is not None
        assert got[0].telemetry["path"] == "subsolve"
    # the reference on the same route reports the same key
    ref_cb = Overlap()
    ref = _ref_route(route, ref_cb, monkeypatch)
    assert ref_cb.calls == calls
    assert all("overlap_host_ms" in r.timings_ms for r in ref[-calls:])
    assert all(r.violations == 0 for r in ref + got)
    if route == "resident_subsolve":
        assert ref[0].subsolve is not None


class Boom(RuntimeError):
    pass


def _raise():
    raise Boom("host work failed")


@pytest.mark.parametrize("subsolve", ["0", "1"])
def test_raising_overlap_propagates(subsolve, monkeypatch):
    """The exception reaches the caller; the stage's resident keeps what
    the solve had adopted (the full path's winner, or the sub-solve's
    untouched seed), and the next reschedule of the stage places with 0
    violations."""
    monkeypatch.setenv("FLEET_SUBSOLVE", subsolve)
    for k, v in SUBSOLVE_ENV.items():
        monkeypatch.setenv(k, v)
    pt = synthetic_problem(140, 14, seed=5, port_fraction=0.25,
                           volume_fraction=0.15)
    a = GpuSolverScheduler(chains=1, steps=STEPS, device="cpu")
    b = GpuSolverScheduler(chains=1, steps=STEPS, device="cpu")
    first = a.place(pt, stage="s")
    assert np.array_equal(b.place(pt, stage="s").raw, first.raw)
    valid = _kill_busiest(pt, first.raw, 2)
    cur = dataclasses.replace(pt, node_valid=valid)
    with pytest.raises(Boom):
        a.reschedule(cur, delta=ProblemDelta(node_valid=valid.copy()),
                     stage="s", overlap_host_work=_raise)
    control = b.reschedule(cur, delta=ProblemDelta(node_valid=valid.copy()),
                           stage="s")
    held = to_np(a._slots[0].resident.assignment)[:pt.S]
    if b.last_result.subsolve is None:
        # the full path adopted its winner before the callable ran
        assert subsolve == "0"
        assert np.array_equal(held, control.raw)
    else:
        # the sub-solve's callable ran before its gate read and its commit
        # writes no resident: the resident still holds its seed
        assert subsolve == "1"
        assert np.array_equal(held, first.raw)
    valid2 = _kill_busiest(pt, control.raw, 1, valid)
    cur2 = dataclasses.replace(pt, node_valid=valid2)
    again = a.reschedule(cur2, delta=ProblemDelta(node_valid=valid2.copy()),
                         stage="s")
    assert again.feasible and again.violations == 0
    assert verify(cur2, again.raw)["total"] == 0
    assert valid2[again.raw].all()


# -- do_repair=False -----------------------------------------------------

def _blocked(seed=11, S=160, N=16):
    """Every 8th service eligible only on two dead nodes: no solve can be
    feasible (the reference's [fallback] instance, cut to size)."""
    out = []
    for pt in _pair(S, N, seed, n_tenants=1):
        elig, valid = pt.eligible.copy(), pt.node_valid.copy()
        elig[::8] = False
        elig[::8, :2] = True
        valid[:2] = False
        out.append(dataclasses.replace(pt, eligible=elig, node_valid=valid))
    return out


def _unrepaired(res, pt, check) -> None:
    assert res.violations > 0 and not res.feasible
    assert res.violations == int(check(pt, res.assignment)["total"])
    assert res.moves_repaired == 0
    assert res.pre_repair_violations == res.violations


# the adaptive anneal (its winner has only the stranded rows' violations,
# which the host repair cannot move either) and a 2-sweep hot fixed budget
# (capacity and conflict violations the repair moves away)
REPAIR_RUNS = {"adaptive": dict(steps=STEPS),
               "hot_fixed": dict(steps=2, adaptive=False, t0=5.0)}


@pytest.mark.parametrize("run", sorted(REPAIR_RUNS))
def test_do_repair_false_solve(run):
    kw = REPAIR_RUNS[run]
    ref_pt, pt = _blocked()
    ref = ref_solve(ref_pt, chains=1, seed=5, do_repair=False, **kw)
    _unrepaired(ref, ref_pt, ref_verify)
    got = solve(pt, device="cpu", chains=1, seed=5, do_repair=False, **kw)
    _unrepaired(got, pt, verify)
    fixed = solve(pt, device="cpu", chains=1, seed=5, **kw)
    assert fixed.pre_repair_violations == got.violations
    rr = repair(pt, got.assignment)
    assert np.array_equal(fixed.assignment, rr.assignment)
    assert fixed.moves_repaired == rr.moves
    assert (rr.moves > 0) == (run == "hot_fixed")
    assert fixed.violations == rr.stats["total"] < got.violations or \
        rr.moves == 0


def test_do_repair_false_keeps_the_device_winner_resident():
    """A resident solve without the backstop adopts no host rewrite: the
    warm seed is the device winner, and so is the next solve's start."""
    ref_pt, pt = _blocked()
    rp = ResidentProblem(pt, CPU)
    res = solve(pt, prob=rp.prob, resident=rp, chains=1, steps=STEPS,
                seed=5, do_repair=False, bucket=rp.bucket)
    _unrepaired(res, pt, verify)
    assert np.array_equal(to_np(rp.assignment)[:pt.S], res.assignment)
    warm = solve(pt, prob=rp.prob, resident=rp, resident_warm=True,
                 chains=1, steps=STEPS, seed=6, do_repair=False,
                 bucket=rp.bucket)
    _unrepaired(warm, pt, verify)
    assert np.array_equal(to_np(rp.assignment)[:pt.S], warm.assignment)
    ref_rp = RefResident(ref_pt)
    ref = ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, chains=1,
                    steps=STEPS, seed=5, do_repair=False,
                    bucket=ref_rp.bucket)
    _unrepaired(ref, ref_pt, ref_verify)
    assert np.array_equal(np.asarray(ref_rp.assignment)[:ref_pt.S],
                          ref.assignment)


def test_do_repair_false_sharded():
    _need_devices(8)
    ref_pt, pt = _blocked()
    mesh = sh.Mesh(CPU8, (sh.SVC_AXIS,))
    got = sh.solve_sharded(pt, resident=sh.ShardedResident(pt, mesh=mesh),
                           steps=STEPS, block=4, seed=3, do_repair=False)
    _unrepaired(got, pt, verify)
    fixed = sh.solve_sharded(pt, resident=sh.ShardedResident(pt, mesh=mesh),
                             steps=STEPS, block=4, seed=3)
    rr = repair(pt, got.assignment)
    assert np.array_equal(fixed.assignment, rr.assignment)
    assert fixed.moves_repaired == rr.moves
    ref_mesh = JaxMesh(np.array(jax.devices()[:8]), (ref_sh.SVC_AXIS,))
    ref = ref_sh.solve_sharded(
        ref_pt, resident=ref_sh.ShardedResident(ref_pt, mesh=ref_mesh),
        steps=STEPS, block=4, seed=3, do_repair=False)
    _unrepaired(ref, ref_pt, ref_verify)


def _mux_stage(pt, seed, port: bool):
    """A resident-warm stage of `pt`: staged, cold-solved (repaired), then
    one more node down."""
    if port:
        rp = ResidentProblem(pt, CPU)
        cold = solve(pt, prob=rp.prob, resident=rp, seed=seed, steps=STEPS)
    else:
        rp = RefResident(pt)
        cold = ref_solve(pt, prob=rp.prob, resident=rp, seed=seed,
                         steps=STEPS)
    valid = _kill_busiest(pt, cold.assignment, 1)
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, (ProblemDelta if port else RefDelta)(
        node_valid=valid.copy()))
    return cur, rp


@pytest.mark.parametrize("lanes", [2, 1])
def test_do_repair_false_multiplexed(lanes):
    """K lanes batched (or one, the serial path): each lane unrepaired,
    equal to the solo resident-warm solve of its stage without the
    backstop; the reference's lanes report the same contract."""
    ref_pt, pt = _blocked()
    seeds = list(range(lanes))
    staged = [_mux_stage(pt, s, True) for s in seeds]
    out = solve_multiplexed([MuxEntry(pt=cur, resident=rp, seed=s)
                             for (cur, rp), s in zip(staged, seeds)],
                            steps=STEPS, do_repair=False, device="cpu")
    for (cur, rp), s, got in zip(staged, seeds, out):
        _unrepaired(got, cur, verify)
        assert np.array_equal(to_np(rp.assignment)[:pt.S], got.assignment)
        solo_cur, solo_rp = _mux_stage(pt, s, True)
        solo = solve(solo_cur, prob=solo_rp.prob, resident=solo_rp,
                     resident_warm=True, seed=s, steps=STEPS,
                     bucket=solo_rp.bucket, do_repair=False)
        _same(solo, got)
    ref_staged = [_mux_stage(ref_pt, s, False) for s in seeds]
    ref_out = ref_mux.solve_multiplexed(
        [ref_mux.MuxEntry(pt=cur, resident=rp, seed=s)
         for (cur, rp), s in zip(ref_staged, seeds)],
        steps=STEPS, do_repair=False)
    for (cur, _rp), ref in zip(ref_staged, ref_out):
        _unrepaired(ref, cur, ref_verify)


def test_do_repair_and_overlap_route():
    """The route passes both options on (the reference's _ROUTED_KW)."""
    assert {"do_repair", "overlap_host_work"} <= sh._ROUTED_KW
    assert {"do_repair", "overlap_host_work"} <= ref_sh._ROUTED_KW


# -- the sharded proposal width ------------------------------------------

WIDTH_CASES = [ANNEAL_CASES[i] for i in (1, 4, 6)]


@pytest.mark.parametrize("width", [None, 16])
@pytest.mark.parametrize("case", WIDTH_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}" for c in WIDTH_CASES])
def test_sharded_width_matches_reference(case, width):
    """anneal_sharded at `width` proposals a position (None: the default
    width) given the reference's draws at that width: bit-equal."""
    (layout, S, N, seed, adaptive, block, exchange_every, steps, packed,
     extras) = case
    _need_devices(8)
    ref_mesh, port_mesh, D = _meshes(layout)
    ref_pt, port_pt = make_pair(S, N, seed, **extras)
    dp = ref_problem.prepare_problem(ref_pt, packed=packed)
    tp = port_problem.prepare_problem(port_pt, CPU, packed=packed)
    dpp, orig = ref_sh.pad_problem(dp, D)
    tpp, _ = port_pad(tp, D)
    init = np.zeros(dpp.S, np.int32)
    key = jax.random.PRNGKey(seed)
    kw = dict(steps=steps, adaptive=adaptive, block=block, n_real=orig,
              exchange_every=exchange_every, return_stats=True,
              trace_blocks=8, proposals_per_step=width)
    ref = ref_sh.anneal_sharded(dpp, jnp.asarray(init), key, mesh=ref_mesh,
                                **kw)
    port = sh.anneal_sharded(
        tpp, torch.tensor(init), mesh=port_mesh,
        draws=JaxDraws(key, sh.REPLICA_AXIS in port_mesh.shape), **kw)
    _check_stats(ref, port)


@pytest.mark.parametrize("width", [None, 16])
def test_solve_sharded_reports_its_width(width):
    _need_devices(8)
    ref_pt, pt = _pair(73, 12, 2, port_fraction=0.3)
    got = sh.solve_sharded(
        pt, resident=sh.ShardedResident(pt, mesh=sh.tempering_mesh(
            2, 4, devices=CPU8)), steps=16, block=4, seed=2,
        proposals_per_step=width)
    ref = ref_sh.solve_sharded(
        ref_pt, resident=ref_sh.ShardedResident(
            ref_pt, mesh=ref_sh.tempering_mesh(2, 4)), steps=16, block=4,
        seed=2, proposals_per_step=width)
    assert got.proposals_per_step == ref.proposals_per_step
    assert got.proposals_per_step == (width or max(8, min(256, 80 // 4 // 2)))
    assert got.violations == 0 and ref.violations == 0


# -- K6's strict mode ----------------------------------------------------

K6_CASES = [(s, False) for s in STRATEGIES] + [("spread_across_pool", True)]


def _k6_pair(strategy, preferred, seed=3, S=200, N=20):
    """(reference DeviceProblem, port TorchProblem, order) at 45% of the
    capacity: the later services fit nowhere."""
    ref_pt, port_pt = make_pair(S, N, seed, strategy=strategy,
                                preferred=preferred)
    cap = (port_pt.capacity * np.float32(0.45)).astype(np.float32)
    ref_pt = dataclasses.replace(ref_pt, capacity=cap.copy())
    port_pt = dataclasses.replace(port_pt, capacity=cap.copy())
    dp = ref_problem.prepare_problem(ref_pt)
    tp = port_problem.prepare_problem(port_pt, CPU)
    order = port_greedy.placement_order(
        port_pt.demand, port_pt.dep_depth,
        port_problem.unify_conflict_ids(port_pt))
    return dp, tp, order


@pytest.mark.parametrize("strategy,preferred", K6_CASES,
                         ids=[f"{s}{'-pref' if p else ''}"
                              for s, p in K6_CASES])
def test_k6_strict_matches_reference(strategy, preferred):
    dp, tp, order = _k6_pair(strategy, preferred)
    o_ref, o_port = jnp.asarray(order), torch.tensor(order)
    ref_strict = np.asarray(ref_greedy.greedy_place(dp, o_ref,
                                                    best_effort=False))
    strict = to_np(port_greedy.greedy_place_plain(tp, o_port,
                                                  best_effort=False))
    assert np.array_equal(ref_strict, strict)
    # the CPU wrapper runs the plain version in both modes
    assert np.array_equal(to_np(port_greedy.greedy_place(
        tp, o_port, best_effort=False)), strict)
    # the best-effort path is unchanged
    ref_be = np.asarray(ref_greedy.greedy_place(dp, o_ref))
    be = to_np(port_greedy.greedy_place_plain(tp, o_port))
    assert np.array_equal(ref_be, be)
    assert np.array_equal(to_np(port_greedy.greedy_place_plain(
        tp, o_port, best_effort=True)), be)
    # the instance has services that fit nowhere: strict parks them on
    # node 0, where best-effort spreads them
    assert (strict != be).any()
    assert (strict == 0).sum() > (be == 0).sum()


# -- acceptance_rate and services_on ---------------------------------------

@pytest.mark.parametrize("steps,chains,width,accepted", [
    (10, 2, 64, 300), (0, 2, 64, 0), (10, 2, 64, -1), (7, 1, 16, 0),
    (3, 4, 0, 5)])
def test_acceptance_rate_matches_reference(steps, chains, width, accepted):
    kw = dict(assignment=np.zeros(3, np.int32), stats={"total": 0}, soft=0.0,
              feasible=True, chains=chains, steps=steps,
              proposals_per_step=width, accepted_moves=accepted)
    assert SolveResult(**kw).acceptance_rate == \
        RefSolveResult(**kw).acceptance_rate


def test_acceptance_rate_of_a_solve():
    _, pt = _pair(100, 10, 3)
    res = solve(pt, device="cpu", chains=2, steps=STEPS, seed=3)
    want = res.accepted_moves / (res.steps * res.chains
                                 * res.proposals_per_step)
    assert res.steps > 0 and res.acceptance_rate == want
    res = solve(pt, device="cpu", chains=2, steps=8, seed=3, adaptive=False)
    assert res.accepted_moves == -1 and res.acceptance_rate == -1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_services_on_matches_reference(seed):
    ref_pt, pt = _pair(60, 6, seed)
    raw = np.random.default_rng(seed).integers(0, pt.N, pt.S)
    assignment = {pt.service_names[i]: pt.node_names[int(raw[i])]
                  for i in range(pt.S)}
    port = Placement(assignment=assignment, levels=level_schedule(pt),
                     feasible=True)
    ref = RefPlacement(assignment=dict(assignment),
                       levels=ref_levels(ref_pt), feasible=True)
    assert port.levels == ref.levels
    for node in list(pt.node_names) + ["nowhere"]:
        assert port.services_on(node) == ref.services_on(node)
