"""The tenant multiplexer of fleetflow_tpu_torch (solver/multiplex.py) and the
lane axis of K1-K3, on the CPU, against the JAX package and against the
port's own solo solve.

- The lane ladder and the tier grouping equal the reference's.
- The lane plain versions of K1, K2 and K3, on problems carried across by
  ``stacked_problem_from_reference``, equal ``jax.vmap`` of the reference's
  ``_batched_step``, ``prerepair_state_counted`` and
  ``chain_states_from_assignment`` + ``violation_stats``: assignments,
  integer planes, stats and moves exactly, loads within atol 1e-5 as in
  test_torch_anneal.py. K1's proposals are drawn per lane with jax.random,
  as ``_batched_step`` draws them, and handed to both.
- The port's batched lanes are bit-identical to its own solo resident-warm
  ``solve`` (the reference's tests/test_multiplex.py, ported): assignment,
  stats, soft score, sweeps and telemetry rows.
- Each lane of the port's ``solve_multiplexed`` meets the contract against
  the reference's ``solve_multiplexed`` on the same fleets: feasible,
  nothing on a dead node, soft within SOFT_BAND, moved fraction within
  MOVED_MARGIN (the two packages draw different random numbers).
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.lower import synthetic_problem as ref_synthetic
from fleetflow_tpu.solver import multiplex as ref_mux
from fleetflow_tpu.solver.api import _solve as ref_solve
from fleetflow_tpu.solver.problem import prepare_problem as ref_prepare
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
from fleetflow_tpu_torch.convert import stacked_problem_from_reference
from fleetflow_tpu_torch.core.errors import SolverError
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.solver import anneal, kernels, multiplex
from fleetflow_tpu_torch.solver.api import solve
from fleetflow_tpu_torch.solver.multiplex import (MuxEntry, mux_k,
                                                  solve_multiplexed,
                                                  stack_problems)
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_anneal import jax_draws
from test_torch_problem import CPU, make_pair, ref_arrays, to_np

ref_anneal = importlib.import_module("fleetflow_tpu.solver.anneal")
ref_kernels = importlib.import_module("fleetflow_tpu.solver.kernels")


def _lanes_metric(name: str = "fleet_solver_mux_lanes_total", **labels):
    """A mux census child, read from the port's registry."""
    return REGISTRY.get(name).value(**labels)


def _batches_total() -> float:
    """Every batched dispatch, whatever its ladder rung."""
    return sum(v for k, v in REGISTRY.counter_values().items()
               if k.startswith("fleet_solver_mux_batches_total{"))

S, N = 60, 12
SOFT_BAND = 0.15      # |port - ref| <= 15% of |ref|
MOVED_MARGIN = 0.05   # port moved fraction <= ref moved fraction + 5 points


def _build(seed, steps=32, S=S, N=N):
    """A resident-warm stage on the CPU: staged, cold-solved, adopted."""
    pt = synthetic_problem(S, N, seed=seed, port_fraction=0.3,
                           volume_fraction=0.2)
    rp = ResidentProblem(pt, CPU)
    cold = solve(pt, prob=rp.prob, resident=rp, seed=seed, steps=steps)
    return pt, rp, cold


def _build_churned(seed, steps=32):
    """A resident-warm stage after one node died."""
    pt, rp, _ = _build(seed, steps)
    valid = np.asarray(pt.node_valid, bool).copy()
    valid[seed % N] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, ProblemDelta(node_valid=valid))
    return cur, rp


def _solo(pt, rp, seed, steps=32):
    return solve(pt, prob=rp.prob, resident=rp, resident_warm=True,
                 seed=seed, steps=steps, bucket=rp.bucket)


def _same(ref, got, lane):
    assert np.array_equal(ref.assignment, got.assignment), lane
    assert ref.stats == got.stats, lane
    assert ref.soft == got.soft, lane
    assert ref.steps == got.steps, lane
    assert ref.feasible == got.feasible, lane
    for key in ("blocks", "init", "prerepair_moves", "exit_sweep",
                "trace_blocks"):
        assert ref.telemetry[key] == got.telemetry[key], (lane, key)
    assert got.telemetry["path"] == "mux"
    assert got.telemetry["mux"]["lane"] == lane


class TestLadder:
    @pytest.mark.parametrize("env", [None, "4", "not-a-number"])
    def test_mux_k_equals_reference(self, env, monkeypatch):
        if env is None:
            monkeypatch.delenv("FLEET_MUX_MAX", raising=False)
        else:
            monkeypatch.setenv("FLEET_MUX_MAX", env)
        assert [mux_k(k) for k in range(41)] == [ref_mux.mux_k(k)
                                                 for k in range(41)]

    def test_pow2_ladder_and_cap(self):
        assert [mux_k(k) for k in (0, 1, 2, 3, 4, 5, 8, 9, 16)] == \
            [1, 1, 2, 4, 4, 8, 8, 16, 16]
        assert mux_k(100) == 16
        assert mux_k(100, maximum=4) == 4
        assert mux_k(3, maximum=2) == 2


class TestStacking:
    def test_stack_rejects_mismatched_tiers(self):
        _, rp_a, _ = _build(0)
        rp_b = ResidentProblem(synthetic_problem(24, 6, seed=1), CPU)
        with pytest.raises(ValueError):
            stack_problems([rp_a.prob, rp_b.prob])
        stacked = stack_problems([rp_a.prob, rp_a.prob])
        assert stacked.lanes == 2 and stacked.demand.shape[0] == 2
        assert stacked.n_real == (rp_a.prob.real_rows,) * 2

    def test_carrier_raises_where_the_reference_does(self):
        """stacked_problem_from_reference raises on the tier mismatch the
        reference's stack_problems raises on."""
        ref_a, _ = make_pair(60, 12, 0)
        ref_b, _ = make_pair(40, 12, 1)
        dp_a, dp_b = ref_prepare(ref_a), ref_prepare(ref_b)
        with pytest.raises(ValueError):
            ref_mux.stack_problems([dp_a, dp_b])
        with pytest.raises(ValueError):
            stacked_problem_from_reference([ref_arrays(dp_a),
                                            ref_arrays(dp_b)], device=CPU)
        both = stacked_problem_from_reference([ref_arrays(dp_a)] * 2,
                                              device=CPU)
        assert both.lanes == 2 and both.S == 60

    def test_groups_equal_reference(self):
        """The same entry list (two tiers, one stage never solved) groups
        into the same index lists in both packages."""
        sizes = [(60, 12), (24, 6), (60, 12), (24, 6), (60, 12), (60, 12)]

        def groups(mod, entries):
            out: dict = {}
            serial = []
            for i, e in enumerate(entries):
                if mod._eligible(e):
                    out.setdefault(mod._tier_key(e), []).append(i)
                else:
                    serial.append(i)
            return sorted(out.values()), serial

        ref_entries, port_entries = [], []
        for i, (s, n) in enumerate(sizes):
            ref_pt, port_pt = make_pair(s, n, i)
            ref_rp, port_rp = RefResident(ref_pt), ResidentProblem(port_pt,
                                                                   CPU)
            if i != 4:          # stage 4 is staged but never solved
                ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=i,
                          steps=8)
                solve(port_pt, prob=port_rp.prob, resident=port_rp, seed=i,
                      steps=8)
            ref_entries.append(ref_mux.MuxEntry(pt=ref_pt, resident=ref_rp))
            port_entries.append(MuxEntry(pt=port_pt, resident=port_rp))
        want = groups(ref_mux, ref_entries)
        assert want == ([[0, 2, 5], [1, 3]], [4])
        assert groups(multiplex, port_entries) == want


def _ref_lanes(L, *, packed=True, sticky=True, seed=3):
    """L reference DeviceProblems of one tier (one fleet, each lane with
    its own dead nodes, phantom count and stickiness) and their stack;
    returns (stacked reference problem, stacked port problem)."""
    ref_pt, _ = make_pair(240, 32, seed, coloc=True, max_skew=2, domains=4)
    base = ref_prepare(ref_pt, packed=packed)
    rng = np.random.default_rng(seed)
    lanes = []
    for i in range(L):
        valid = np.ones(32, dtype=bool)
        valid[rng.choice(32, 1 + i, replace=False)] = False
        kw = dict(node_valid=jnp.asarray(valid),
                  n_real=jnp.asarray(240 - 9 * i, jnp.int32))
        if sticky:
            kw.update(sticky_prev=jnp.asarray(
                rng.integers(0, 32, 240).astype(np.int32)),
                sticky_w=jnp.float32(0.25 + 0.25 * i))
        lanes.append(dataclasses.replace(base, **kw))
    stacked = ref_mux.stack_problems(lanes)
    port = stacked_problem_from_reference([ref_arrays(d) for d in lanes],
                                          device=CPU)
    return stacked, port


class TestLaneKernelsAgainstVmap:
    @pytest.mark.parametrize("packed", [True, False])
    def test_k3_rebuild_and_stats(self, packed):
        dps, tp = _ref_lanes(3, packed=packed, sticky=False)
        rng = np.random.default_rng(4)
        a = rng.integers(0, 32, (3, 240)).astype(np.int32)
        a[1, :80] = 0                      # an overloaded node
        st = jax.vmap(ref_anneal.chain_states_from_assignment)(
            dps, jnp.asarray(a))
        stats = jax.vmap(ref_kernels.violation_stats)(dps, jnp.asarray(a))
        load, used, coloc, topo, pstats = kernels.k3_rebuild_plain(
            tp, torch.tensor(a), with_stats=True)
        assert load.shape == (3, 1, 32, 3)
        for x, y in ((used, st.used), (coloc, st.coloc), (topo, st.topo)):
            assert np.array_equal(to_np(x[:, 0]), np.asarray(y))
        np.testing.assert_allclose(to_np(load[:, 0]), np.asarray(st.load),
                                   atol=1e-5, rtol=0)
        for j, k in enumerate(kernels.STAT_KEYS):
            assert np.array_equal(to_np(pstats[:, 0, j]),
                                  np.asarray(stats[k])), k
        assert float(pstats[1, 0, 4]) > 0

    def test_k2_prerepair(self):
        dps, tp = _ref_lanes(3)
        a = np.random.default_rng(5).integers(0, 32, (3, 240)).astype(
            np.int32)
        st = jax.vmap(ref_anneal.chain_states_from_assignment)(
            dps, jnp.asarray(a))
        ref_st, ref_moves = jax.vmap(
            lambda p, s: ref_anneal.prerepair_state_counted(p, s, 64))(dps,
                                                                       st)
        port = anneal.chain_states_from_assignment(tp, torch.tensor(a))
        port, moves = anneal.prerepair_state_counted(tp, port, 64)
        assert to_np(moves).tolist() == np.asarray(ref_moves).tolist()
        assert int(moves.min()) > 0
        for f in ("assignment", "used", "coloc", "topo"):
            assert np.array_equal(to_np(getattr(port, f)[:, 0]),
                                  np.asarray(getattr(ref_st, f))), f
        assert np.array_equal(to_np(port.load[:, 0]), np.asarray(ref_st.load))

    @pytest.mark.parametrize("temp", [1.0, 0.05])
    def test_k1_sweep_given_the_same_proposals(self, temp):
        L, M = 3, 48
        dps, tp = _ref_lanes(L)
        a = np.random.default_rng(6).integers(0, 32, (L, 240)).astype(
            np.int32)
        ref_st = jax.vmap(ref_anneal.chain_states_from_assignment)(
            dps, jnp.asarray(a))
        port = anneal.chain_states_from_assignment(tp, torch.tensor(a))
        temps = jnp.asarray([temp / (1 + i) for i in range(L)], jnp.float32)
        step = jax.jit(jax.vmap(
            lambda p, s, k, t: ref_anneal._batched_step(p, s, k, t, M)))
        lane = lambda tree, i: jax.tree_util.tree_map(  # noqa: E731
            lambda x: x[i], tree)
        total = 0
        for sweep in range(3):
            keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(i),
                                                 sweep) for i in range(L)])
            draws = [jax_draws(lane(dps, i), lane(ref_st, i), keys[i], M)
                     for i in range(L)]
            ref_st, acc = step(dps, ref_st, keys, temps)
            s_idx, b_idx, u = (torch.tensor(np.stack(x))[:, None]
                               for x in zip(*draws))
            _, applied = anneal.batched_step_apply(
                tp, port, s_idx.to(torch.int32), b_idx.to(torch.int32), u,
                [float(t) for t in temps])
            assert to_np(applied[:, 0]).tolist() == np.asarray(acc).tolist()
            total += int(np.asarray(acc).sum())
            for f in ("assignment", "used", "coloc", "topo"):
                assert np.array_equal(to_np(getattr(port, f)[:, 0]),
                                      np.asarray(getattr(ref_st, f))), f
            np.testing.assert_allclose(to_np(port.load[:, 0]),
                                       np.asarray(ref_st.load), atol=1e-5,
                                       rtol=0)
        assert total > 0

    def test_inactive_lane_stays_untouched(self):
        _dps, tp = _ref_lanes(3)
        a = torch.tensor(np.random.default_rng(7).integers(
            0, 32, (3, 2, 240)).astype(np.int32))
        st = anneal.chain_states_from_assignment(tp, a)
        before = st.clone()
        gen = torch.Generator().manual_seed(0)
        draws = [anneal.draw_proposals(tp.lane(i), st.lane(i), gen, 40)
                 for i in range(3)]
        s_idx, b_idx, u = (torch.stack([d[k] for d in draws])
                           for k in range(3))
        _, applied = anneal.batched_step_apply(tp, st, s_idx, b_idx, u,
                                               [1.0] * 3,
                                               [True, False, True])
        assert int(applied[1].sum()) == 0 and int(applied.sum()) > 0
        for x, y in zip(st, before):
            assert torch.equal(x[1], y[1])


class TestParity:
    """The port of the reference's tests/test_multiplex.py: one batched
    dispatch reproduces each solo resident-warm solve exactly."""
    K = 3

    def test_batched_lanes_bit_identical_to_serial(self):
        serial = []
        for i in range(self.K):
            pt, rp, cold = _build(i)
            serial.append((cold.assignment.copy(), _solo(pt, rp, 100 + i)))
        entries = []
        for i in range(self.K):
            pt, rp, cold = _build(i)
            assert np.array_equal(cold.assignment, serial[i][0])
            entries.append(MuxEntry(pt=pt, resident=rp, seed=100 + i))
        mres = solve_multiplexed(entries, steps=32, device=CPU)
        assert len(mres) == self.K
        for i in range(self.K):
            _same(serial[i][1], mres[i], i)
            assert mres[i].timings_ms["mux_k"] == float(mux_k(self.K))
            assert mres[i].timings_ms["mux_lane"] == float(i)

    def test_churned_lanes_match_serial_sweeps_and_telemetry(self,
                                                            monkeypatch):
        """Lanes that sweep and exit on different sweeps (one dead node
        each, and a stage with a third of its nodes dead)."""
        monkeypatch.setenv("FLEET_SUBSOLVE", "0")

        def churned(i):
            if i < self.K:
                return _build_churned(i)
            pt, rp, _ = _build(i)
            valid = np.asarray(pt.node_valid, bool).copy()
            valid[:4] = False
            cur = dataclasses.replace(pt, node_valid=valid)
            rp.apply_delta(cur, ProblemDelta(node_valid=valid))
            return cur, rp

        serial = [_solo(*churned(i), 100 + i) for i in range(self.K + 1)]
        entries = [MuxEntry(pt=cur, resident=rp, seed=100 + i)
                   for i, (cur, rp) in enumerate(churned(i) for i in
                                                 range(self.K + 1))]
        mres = solve_multiplexed(entries, steps=32, device=CPU)
        for i in range(self.K + 1):
            _same(serial[i], mres[i], i)
        assert len({r.steps for r in mres}) > 1     # per-lane exits
        assert max(r.steps for r in mres) > 0

    def test_repeat_dispatch_same_rung(self):
        """A second batch of the same stages runs on the same rung and
        equals a second solo solve of each."""
        entries, solo_stages = [], []
        for i in range(2):
            pt, rp, _ = _build(10 + i)
            entries.append(MuxEntry(pt=pt, resident=rp, seed=7 + i))
            solo_stages.append(_build(10 + i)[:2])
        batches = _lanes_metric("fleet_solver_mux_batches_total", k="2")
        for _ in range(2):
            res = solve_multiplexed(entries, steps=32, device=CPU)
            ref = [_solo(pt, rp, 7 + i)
                   for i, (pt, rp) in enumerate(solo_stages)]
            for i in range(2):
                _same(ref[i], res[i], i)
        assert _lanes_metric("fleet_solver_mux_batches_total",
                             k="2") == batches + 2

    def test_padded_batch_same_rung(self):
        """3 lanes run on the 4-lane rung; the padding lane is counted and
        discarded, every real lane gets its solo result."""
        entries, ref = [], []
        for i in range(3):
            pt, rp, _ = _build(20 + i)
            entries.append(MuxEntry(pt=pt, resident=rp, seed=7 + i))
            ref.append(_solo(*_build(20 + i)[:2], 7 + i))
        lanes = {kind: _lanes_metric(kind=kind) for kind in ("pad", "stage")}
        res = solve_multiplexed(entries, steps=32, device=CPU)
        assert len(res) == 3
        assert all(r.timings_ms["mux_k"] == 4.0 for r in res)
        assert _lanes_metric(kind="pad") == lanes["pad"] + 1
        assert _lanes_metric(kind="stage") == lanes["stage"] + 3
        for i in range(3):
            _same(ref[i], res[i], i)


class TestSerialFallback:
    def test_singleton_group_falls_back_to_serial(self):
        pt, rp, _ = _build(30)
        ref = _solo(pt, rp, 5)
        pt2, rp2, _ = _build(30)
        serial = _lanes_metric(kind="serial")
        [m] = solve_multiplexed([MuxEntry(pt=pt2, resident=rp2, seed=5)],
                                steps=32, device=CPU)
        assert np.array_equal(ref.assignment, m.assignment)
        assert "mux_k" not in m.timings_ms    # serial path, not a batch of 1
        assert _lanes_metric(kind="serial") == serial + 1

    def test_ineligible_resident_falls_back_to_serial(self):
        """A staging with no adopted assignment is not resident-warm and
        takes the serial path, with a real result."""
        pt = synthetic_problem(S, N, seed=40, port_fraction=0.3,
                               volume_fraction=0.2)
        rp = ResidentProblem(pt, CPU)          # never solved
        pt2, rp2, _ = _build(41)
        res = solve_multiplexed([MuxEntry(pt=pt, resident=rp, seed=1),
                                 MuxEntry(pt=pt2, resident=rp2, seed=2)],
                                steps=32, device=CPU)
        assert len(res) == 2
        assert all(r.assignment.shape == (S,) and r.feasible for r in res)
        assert rp.assignment is not None       # the cold solve adopted one

    def test_mixed_tiers_split_into_groups(self):
        entries = []
        for i in range(2):
            pt, rp, _ = _build(50 + i)
            entries.append(MuxEntry(pt=pt, resident=rp, seed=i))
        for i in range(2):
            pt, rp, _ = _build(60 + i, steps=16, S=24, N=6)
            entries.append(MuxEntry(pt=pt, resident=rp, seed=i))
        batches = _batches_total()
        res = solve_multiplexed(entries, steps=16, device=CPU)
        assert len(res) == 4
        assert _batches_total() == batches + 2
        assert res[0].assignment.shape == (S,)
        assert res[2].assignment.shape == (24,)
        assert all(r.timings_ms["mux_k"] == 2.0 for r in res)

    def test_default_device_raises_without_cuda(self, monkeypatch):
        """solve_multiplexed runs on the card unless the caller names the
        CPU: without CUDA it raises, even for CPU stagings."""
        pt, rp, _ = _build(0)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SolverError):
            solve_multiplexed([MuxEntry(pt=pt, resident=rp)], steps=8)
        with pytest.raises(SolverError):
            solve_multiplexed([])


def test_lanes_meet_the_reference_contract(monkeypatch):
    """Each lane of the port's solve_multiplexed against the reference's
    solve_multiplexed on the same churned fleets, at 150x24. (At 60x12 a
    lane whose pre-repair does not land feasible sweeps and moves a
    quarter to a third of its services in either package, the reference
    on seed 2 and the port on seed 1: the two packages' different random
    numbers decide which, so the moved fraction is compared where both
    pre-repairs land.)"""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    S, N = 150, 24
    ref_entries, port_entries, before, dead = [], [], [], []
    for i in range(3):
        ref_pt = ref_synthetic(S, N, seed=i, port_fraction=0.3,
                               volume_fraction=0.2)
        port_pt = synthetic_problem(S, N, seed=i, port_fraction=0.3,
                                    volume_fraction=0.2)
        ref_rp, port_rp = RefResident(ref_pt), ResidentProblem(port_pt, CPU)
        r0 = ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=i,
                       steps=32)
        p0 = solve(port_pt, prob=port_rp.prob, resident=port_rp, seed=i,
                   steps=32)
        valid = np.asarray(port_pt.node_valid, bool).copy()
        valid[int(np.bincount(p0.assignment, minlength=N).argmax())] = False
        ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
        port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
        ref_rp.apply_delta(ref_cur, RefDelta(node_valid=valid.copy()))
        port_rp.apply_delta(port_cur, ProblemDelta(node_valid=valid.copy()))
        ref_entries.append(ref_mux.MuxEntry(pt=ref_cur, resident=ref_rp,
                                            seed=100 + i))
        port_entries.append(MuxEntry(pt=port_cur, resident=port_rp,
                                     seed=100 + i))
        before.append((r0.assignment.copy(), p0.assignment.copy()))
        dead.append(~valid)
    ref_res = ref_mux.solve_multiplexed(ref_entries, steps=32)
    port_res = solve_multiplexed(port_entries, steps=32, device=CPU)
    for i, (rr, pr) in enumerate(zip(ref_res, port_res)):
        assert rr.violations == 0 and pr.violations == 0, i
        assert not dead[i][pr.assignment].any(), i
        assert abs(pr.soft - rr.soft) <= SOFT_BAND * abs(rr.soft), i
        moved_ref = float((rr.assignment != before[i][0]).mean())
        moved_port = float((pr.assignment != before[i][1]).mean())
        assert moved_port <= moved_ref + MOVED_MARGIN, i
        assert pr.timings_ms["mux_k"] == rr.timings_ms["mux_k"] == 4.0
