"""The other seeds of fleetflow_tpu_torch against the JAX package, on the CPU.

K6's plain version (solver/greedy.py::greedy_place_plain) must equal the
reference's jitted greedy_place bit for bit: the three strategies, packed
and dense eligibility, with and without a preference plane, an instance
where some services fit nowhere (the best-effort argmax), one where some
services have no eligible valid node at all (the `- 1e15` mask), and a
bucketed staging with phantom rows. The host seeds (the host placer's FFD,
the partitioned seed, the numpy host greedy) must equal the reference's.
solve() with each seed_impl, the legacy host pre-repair, total_cost and the
entry() counterpart are held to the reference's results or contracts.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.native import lib as ref_native
from fleetflow_tpu.sched.host import greedy_host_place as ref_host_place
from fleetflow_tpu.solver import greedy as ref_greedy
from fleetflow_tpu.solver import kernels as ref_kernels
from fleetflow_tpu.solver import problem as ref_problem
from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu.solver.buckets import stage_problem_tiers as ref_stage
from fleetflow_tpu.solver.repair import repair as ref_repair
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
from fleetflow_tpu_torch import _ext
from fleetflow_tpu_torch.core.errors import SolverError
from fleetflow_tpu_torch.entry import ENTRY_CHAINS, entry
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.native import NativeGreedyScheduler
from fleetflow_tpu_torch.native.lib import native_place
from fleetflow_tpu_torch.sched.host import greedy_host_place
from fleetflow_tpu_torch.solver import api as port_api
from fleetflow_tpu_torch.solver import greedy as port_greedy
from fleetflow_tpu_torch.solver import kernels as port_kernels
from fleetflow_tpu_torch.solver import problem as port_problem
from fleetflow_tpu_torch.solver import solve
from fleetflow_tpu_torch.solver.buckets import stage_problem_tiers
from fleetflow_tpu_torch.solver.repair import verify
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_problem import CPU, STRATEGIES, make_pair, to_np
from torch_moved_fraction import warm_from_batched_cold

SOFT_BAND = 0.15      # |port - ref| <= 15% of |ref| (test_torch_solve.py)
MOVED_MARGIN = 0.05   # port moved fraction <= ref moved fraction + 5 points


def tier_blocked(pt, every: int = 7, nodes: int = 4):
    """Every `every`-th service may use only nodes [0, nodes), and those
    nodes are down: those services have no eligible valid node."""
    elig = pt.eligible.copy()
    elig[::every] = False
    elig[::every, :nodes] = True
    valid = pt.node_valid.copy()
    valid[:nodes] = False
    return dataclasses.replace(pt, eligible=elig, node_valid=valid)


def _scan_case(case: str):
    """(reference DeviceProblem, port TorchProblem, order) of a case."""
    parts = case.split("-")
    kind, strategy = parts[0], parts[-1]
    packed = "dense" not in parts
    # "wide": more nodes (1,100) than one block of K6 has threads
    S, N = (120, 1100) if kind == "wide" else (300, 40)
    ref_pt, port_pt = make_pair(S, N, 3, strategy=strategy,
                                preferred="pref" in parts,
                                n_tenants=1 if kind == "masked" else 3)
    if kind == "besteffort":
        # nodes at 45% of their capacity: later services fit nowhere
        cap = (port_pt.capacity * np.float32(0.45)).astype(np.float32)
        ref_pt = dataclasses.replace(ref_pt, capacity=cap.copy())
        port_pt = dataclasses.replace(port_pt, capacity=cap.copy())
    elif kind == "masked":
        ref_pt, port_pt = tier_blocked(ref_pt), tier_blocked(port_pt)
    if kind == "bucketed":
        dp, _ = ref_stage(ref_pt, reuse_device_constants=False)
        tp, _ = stage_problem_tiers(port_pt, device=CPU)
        assert tp.S > port_pt.S and dp.S == tp.S
    else:
        dp = ref_problem.prepare_problem(ref_pt, packed=packed)
        tp = port_problem.prepare_problem(port_pt, CPU, packed=packed)
    order = ref_greedy.placement_order(
        ref_pt.demand, ref_pt.dep_depth,
        np.asarray(dp.conflict_ids)[:ref_pt.S])
    assert np.array_equal(order, port_greedy.placement_order(
        port_pt.demand, port_pt.dep_depth,
        port_problem.unify_conflict_ids(port_pt)))
    if tp.S > port_pt.S:
        order = np.concatenate([order, np.arange(port_pt.S, tp.S,
                                                 dtype=np.int32)])
    return dp, tp, order.astype(np.int32), port_pt


SCAN_CASES = ([f"plain-{layout}{pref}-{s}" for s in STRATEGIES
               for layout in ("packed", "dense") for pref in ("", "-pref")]
              + [f"besteffort-{s}" for s in STRATEGIES]
              + ["masked-packed-spread_across_pool",
                 "masked-dense-pref-fill_lowest",
                 "bucketed-spread_across_pool", "bucketed-pref-pack_into_dedicated",
                 "wide-pref-spread_across_pool", "wide-dense-fill_lowest"])


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_plain_matches_reference(case):
    dp, tp, order, port_pt = _scan_case(case)
    ref = np.asarray(jax.jit(ref_greedy.greedy_place)(dp, jnp.asarray(order)))
    port = to_np(port_greedy.greedy_place_plain(tp, torch.tensor(order)))
    assert port.dtype == np.int32
    assert np.array_equal(ref, port), int((ref != port).sum())
    real = port[:port_pt.S]
    if case.startswith("besteffort"):
        assert verify(port_pt, real)["capacity"] > 0
    if case.startswith("masked"):
        # no eligible valid node: the -1e15 mask picks among every node
        assert verify(port_pt, real)["eligibility"] > 0
    if case.startswith("bucketed"):
        # phantoms park on a valid node
        assert port_pt.node_valid[port[port_pt.S:]].all()


def test_scan_wrapper_runs_plain_on_cpu_and_checks_order():
    _, tp, order, _ = _scan_case("plain-packed-spread_across_pool")
    _ext.reset_launches()
    out = port_greedy.greedy_place(tp, torch.tensor(order))
    assert torch.equal(out, port_greedy.greedy_place_plain(
        tp, torch.tensor(order)))
    assert sum(_ext.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        port_greedy.greedy_place(tp, torch.tensor(order)[None])
    with pytest.raises(ValueError):
        port_greedy.greedy_place(tp, torch.zeros(tp.S + 1, dtype=torch.int32))


# -- the host seeds ---------------------------------------------------------

def _host_args(pt):
    return (pt.demand, pt.capacity, pt.eligible, pt.node_valid,
            pt.dep_depth, pt.port_ids, pt.volume_ids, pt.anti_ids)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_native_place_matches_reference(strategy, blocked):
    ref_pt, port_pt = make_pair(350, 40, 5, strategy=strategy)
    if blocked:
        ref_pt, port_pt = tier_blocked(ref_pt), tier_blocked(port_pt)
    assert ref_native.available()
    ref_a, ref_v = ref_native.native_place(*_host_args(ref_pt),
                                           strategy=strategy)
    port_a, port_v = native_place(*_host_args(port_pt), strategy=strategy)
    host_a, host_v = greedy_host_place(port_pt)
    ref_host_a, ref_host_v = ref_host_place(ref_pt)
    assert port_a.dtype == np.int32
    assert np.array_equal(ref_a, port_a) and ref_v == port_v
    assert np.array_equal(host_a, port_a) and host_v == port_v
    assert np.array_equal(ref_host_a, host_a) and ref_host_v == host_v
    assert (port_v > 0) == blocked


@pytest.mark.parametrize("parts", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 2])
def test_partitioned_seed_matches_reference(seed, parts):
    ref_pt, port_pt = make_pair(400, 48, seed)
    assert ref_native.load() is not None     # the reference's own FFD
    ref = ref_greedy.partitioned_seed(ref_pt, parts)
    port = port_greedy.partitioned_seed(port_pt, parts)
    assert port.dtype == np.int32 and np.array_equal(ref, port)


def test_host_placer_build_failure_raises(monkeypatch, tmp_path):
    """No host placer, no fallback: every route that needs it raises."""
    _ext.host_library("ffplacer")            # built where it belongs
    monkeypatch.setattr(_ext, "_host_libs", {})
    monkeypatch.setattr(_ext, "_BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    pt = synthetic_problem(60, 8, seed=0)
    with pytest.raises(SolverError):
        native_place(*_host_args(pt))
    with pytest.raises(SolverError):
        NativeGreedyScheduler().place(pt)
    with pytest.raises(SolverError):
        port_greedy.partitioned_seed(pt, 4)
    for impl in ("native", "partitioned"):
        with pytest.raises(SolverError):
            solve(pt, device="cpu", seed_impl=impl)
    # a library already built still loads without a compiler
    monkeypatch.undo()
    monkeypatch.setattr(_ext, "_host_libs", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native_place(*_host_args(pt))[0].shape == (60,)

    # a compiler that fails is reported the same way
    monkeypatch.setattr(_ext, "_host_libs", {})
    monkeypatch.setattr(_ext, "_BUILD_ROOT", tmp_path / "other")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(SolverError):
        native_place(*_host_args(pt))


def test_native_place_rejects_bad_shapes():
    pt = synthetic_problem(30, 6, seed=0)
    args = list(_host_args(pt))
    args[2] = pt.eligible[:, :5]
    with pytest.raises(ValueError):
        native_place(*args)
    args = list(_host_args(pt))
    args[5] = pt.port_ids[:20]
    with pytest.raises(ValueError):
        native_place(*args)


# -- solve(seed_impl=...) ---------------------------------------------------

@pytest.mark.parametrize("impl", ["scan", "batched", "native",
                                  "partitioned", None])
def test_solve_seed_impl_matches_reference_contract(impl):
    ref_pt, port_pt = make_pair(400, 48, 1)
    ref = ref_solve(ref_pt, seed_impl=impl or "batched", seed=1)
    res = solve(port_pt, device="cpu", seed_impl=impl, seed=1)
    assert ref.violations == 0 and res.violations == 0
    assert verify(port_pt, res.assignment)["total"] == 0
    assert res.pre_repair_violations == 0 and res.moves_repaired == 0
    assert abs(res.soft - ref.soft) <= SOFT_BAND * abs(ref.soft)
    assert res.timings_ms["seed_ms"] > 0


def test_seed_impl_none_is_batched_and_bad_value_raises():
    _, pt = make_pair(200, 24, 2)
    a = solve(pt, device="cpu", seed=4)
    b = solve(pt, device="cpu", seed=4, seed_impl="batched")
    assert np.array_equal(a.assignment, b.assignment) and a.soft == b.soft
    with pytest.raises(ValueError, match="seed_impl must be"):
        solve(pt, device="cpu", seed_impl="ffd")


@pytest.mark.parametrize("impl", ["scan", "native"])
def test_bucketed_host_and_scan_seeds(impl):
    """A bucketed solve pads the host seed and appends the phantoms to
    the scan order; the real rows come back feasible."""
    _, pt = make_pair(300, 40, 6)
    res = solve(pt, device="cpu", seed_impl=impl, bucket=True)
    assert res.bucket is not None and res.bucket["padded_S"] > pt.S
    assert res.assignment.shape == (pt.S,) and res.violations == 0


# -- the legacy host pre-repair (prerepair=True) ----------------------------

def _kill_busiest(pt, assignment, k: int):
    valid = pt.node_valid.copy()
    valid[np.argsort(-np.bincount(assignment, minlength=pt.N))[:k]] = False
    return valid


def _capture_prepass(monkeypatch):
    calls = []
    inner = port_api.legacy_host_prepass

    def spy(pt, seed_np, seed):
        out = inner(pt, seed_np, seed)
        calls.append((np.array(seed_np, copy=True), np.array(out, copy=True),
                      seed))
        return out

    monkeypatch.setattr(port_api, "legacy_host_prepass", spy)
    return calls


def _expected_prepass(ref_pt, seed_in, seed):
    rows = np.arange(ref_pt.S)
    stranded = (~ref_pt.node_valid[seed_in]) | (~ref_pt.eligible[rows,
                                                                 seed_in])
    if not stranded.any():
        return seed_in
    return ref_repair(ref_pt, seed_in, seed=seed).assignment


# The cold solves of the prerepair tests below seed with the host FFD on
# both sides (the reference's CPU pick at this size is "native"), so the two
# warm paths start from placements of one kind. From batched-seed colds on
# both sides the reference moves as much as the port or more
# (tests/torch_moved_fraction.py prints the grid); test_warm_from_batched_cold
# holds that path to the same contract.
@pytest.mark.parametrize("prerepair", [None, True])
@pytest.mark.parametrize("kill", [1, 3])
@pytest.mark.parametrize("seed", [4, 6])
def test_warm_from_batched_cold(seed, kill, prerepair):
    r = warm_from_batched_cold(seed, kill, prerepair)
    res = r["result"]
    assert res.fused_prerepair == (prerepair is None)
    assert res.violations == 0 and not (~r["valid"][res.assignment]).any()
    assert r["ref_violations"] == 0
    assert r["moved"] <= r["ref_moved"] + MOVED_MARGIN


@pytest.mark.parametrize("kill", [1, 3])
def test_prerepair_true_init_assignment(kill, monkeypatch):
    ref_pt, port_pt = make_pair(320, 40, 4)
    ref_cold = ref_solve(ref_pt, seed=4)
    cold = solve(port_pt, device="cpu", seed=4, seed_impl="native")
    valid = _kill_busiest(port_pt, cold.assignment, kill)
    ref_valid = _kill_busiest(ref_pt, ref_cold.assignment, kill)
    calls = _capture_prepass(monkeypatch)
    cur = dataclasses.replace(port_pt, node_valid=valid)
    res = solve(cur, device="cpu", init_assignment=cold.assignment,
                prerepair=True, seed=7)
    assert len(calls) == 1
    seed_in, out, seed = calls[0]
    assert np.array_equal(seed_in, cold.assignment) and seed == 7
    ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
    assert np.array_equal(out, _expected_prepass(ref_cur, seed_in, 7))
    assert not res.fused_prerepair and res.timings_ms["prerepair_ms"] > 0
    assert res.violations == 0 and not (~valid[res.assignment]).any()
    ref_res = ref_solve(dataclasses.replace(ref_pt, node_valid=ref_valid),
                        init_assignment=ref_cold.assignment, prerepair=True,
                        seed=7)
    assert ref_res.violations == 0
    moved_ref = float((ref_res.assignment != ref_cold.assignment).mean())
    moved = float((res.assignment != cold.assignment).mean())
    assert moved <= moved_ref + MOVED_MARGIN


def test_prerepair_true_resident_warm(monkeypatch):
    ref_pt, port_pt = make_pair(300, 36, 8)
    ref_rp = RefResident(ref_pt)
    ref_cold = ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=8,
                         bucket=True)
    rp = ResidentProblem(port_pt, CPU)
    cold = solve(port_pt, prob=rp.prob, resident=rp, seed=8, bucket=True,
                 seed_impl="native")
    assert cold.feasible and ref_cold.feasible
    valid = _kill_busiest(port_pt, cold.assignment, 2)
    cur = dataclasses.replace(port_pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid.copy()))
    calls = _capture_prepass(monkeypatch)
    res = solve(cur, prob=rp.prob, resident=rp, resident_warm=True,
                prerepair=True, seed=9, bucket=True)
    assert len(calls) == 1
    seed_in, out, _ = calls[0]
    # the real rows of the resident seed came back to the host
    assert np.array_equal(seed_in, cold.assignment)
    ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
    assert np.array_equal(out, _expected_prepass(ref_cur, seed_in, 9))
    assert res.subsolve is None and not res.fused_prerepair
    assert res.violations == 0 and not (~valid[res.assignment]).any()
    ref_valid = _kill_busiest(ref_pt, ref_cold.assignment, 2)
    ref_cur = dataclasses.replace(ref_pt, node_valid=ref_valid)
    ref_rp.apply_delta(ref_cur, RefDelta(node_valid=ref_valid.copy()))
    ref_res = ref_solve(ref_cur, prob=ref_rp.prob, resident=ref_rp,
                        resident_warm=True, prerepair=True, seed=9,
                        bucket=True)
    assert ref_res.violations == 0
    moved_ref = float((ref_res.assignment != ref_cold.assignment).mean())
    moved = float((res.assignment != cold.assignment).mean())
    assert moved <= moved_ref + MOVED_MARGIN


def test_prerepair_false_runs_neither():
    _, pt = make_pair(250, 30, 3)
    cold = solve(pt, device="cpu", seed=3)
    valid = _kill_busiest(pt, cold.assignment, 1)
    cur = dataclasses.replace(pt, node_valid=valid)
    res = solve(cur, device="cpu", init_assignment=cold.assignment,
                prerepair=False, seed=3)
    assert not res.fused_prerepair and "prerepair_ms" not in res.timings_ms
    assert res.telemetry["prerepair_moves"] == 0
    assert res.violations == 0 and not (~valid[res.assignment]).any()


# -- total_cost and entry() -------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_total_cost_matches_reference(strategy):
    ref_pt, port_pt = make_pair(256, 16, 0, strategy=strategy,
                                preferred=strategy == "fill_lowest",
                                coloc=True)
    dp = ref_problem.prepare_problem(ref_pt)
    tp = port_problem.prepare_problem(port_pt, CPU)
    rng = np.random.default_rng(11)
    a = rng.integers(0, 16, (6, 256)).astype(np.int32)
    a[0] = 0                              # everything on node 0
    ref_v = np.asarray(jax.vmap(lambda x: ref_kernels.total_violations(
        dp, x))(jnp.asarray(a)))
    ref_s = np.asarray(jax.vmap(lambda x: ref_kernels.soft_score(dp, x))(
        jnp.asarray(a)))
    ref_c = np.asarray(jax.vmap(lambda x: ref_kernels.total_cost(dp, x))(
        jnp.asarray(a)))
    port_v = to_np(port_kernels.total_violations(tp, torch.tensor(a)))
    port_c = to_np(port_kernels.total_cost(tp, torch.tensor(a)))
    port_s = np.array([float(port_kernels.soft_score(tp, torch.tensor(x)))
                       for x in a], dtype=np.float32)
    assert np.array_equal(ref_v.astype(np.float32), port_v)
    np.testing.assert_allclose(port_s, ref_s, rtol=1e-6, atol=1e-6)
    # the f32 sum W_HARD * v + soft: one rounding of the soft term
    np.testing.assert_allclose(port_c, ref_c, rtol=1e-6)
    one = port_kernels.total_cost(tp, torch.tensor(a[3]))
    assert one.dim() == 0 and float(one) == float(port_c[3])


def test_entry_on_cpu():
    fn, args = entry(device="cpu")
    inits, seed = args
    assert inits.shape == (ENTRY_CHAINS, 256) and isinstance(seed, int)
    _ext.reset_launches()
    out = fn(*args)
    assert out.shape == (256,) and out.dtype == torch.int32
    assert sum(_ext.LAUNCHES.values()) == 0      # the plain versions
    prob = port_problem.prepare_problem(synthetic_problem(256, 16, seed=0),
                                        CPU)
    cost = float(port_kernels.total_cost(prob, out))
    zero = float(port_kernels.total_cost(
        prob, torch.zeros(256, dtype=torch.int32)))
    assert np.isfinite(cost) and cost <= zero
    assert torch.equal(fn(*args), out)           # seeded: reproducible
