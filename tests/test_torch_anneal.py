"""K1 and K2 parity (fleetflow_tpu_torch/solver/anneal.py) against the JAX
package on the CPU, plus the carried-state stats and the adaptive driver.

K1: the sweep cannot match by seed (torch's generator is not threefry), so
the proposals are drawn with jax.random exactly as _batched_step draws them
(anneal.py:431-457) and handed to both steps. Given the same proposals the
assignment and integer planes must match exactly, the load within
atol=1e-5. K2 (the fused pre-repair) must match prerepair_state_counted
exactly: assignment, moves and integer planes.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.solver.problem import eligible_lookup as ref_lookup
from fleetflow_tpu_torch.solver import anneal as port_anneal
from fleetflow_tpu_torch.solver.anneal import ChainState
from test_torch_problem import STRATEGIES, staged_pair, to_np

ref_anneal = importlib.import_module("fleetflow_tpu.solver.anneal")
ref_kernels = importlib.import_module("fleetflow_tpu.solver.kernels")
_ref_step = jax.jit(ref_anneal._batched_step, static_argnums=(4,))
_ref_prerepair = jax.jit(ref_anneal.prerepair_state_counted,
                         static_argnums=(2,))


def jax_draws(dp, st, key, M):
    """The proposals _batched_step draws from `key` (same splits, same
    targeted/uniform halves)."""
    ks, kb, ka, kt = jax.random.split(key, 4)
    over_node = (st.load > dp.capacity * (1 + 1e-6)).any(-1)
    conf_node = (st.used * (st.used - 1)).sum(-1) > 0
    svc_bad = (~ref_lookup(dp.eligible, jnp.arange(dp.S), st.assignment)
               | ~dp.node_valid[st.assignment])
    hot = (over_node | conf_node)[st.assignment] | svc_bad
    logits = jnp.where(hot, 0.0, -30.0)
    s_tgt = jax.random.categorical(kt, logits, shape=(M,))
    s_uni = jax.random.randint(ks, (M,), 0, dp.S)
    s_idx = jnp.where(jnp.arange(M) < M // 2, s_tgt, s_uni)
    b_idx = jax.random.randint(kb, (M,), 0, dp.N)
    u = jax.random.uniform(ka, (M,))
    return np.asarray(s_idx), np.asarray(b_idx), np.asarray(u)


def port_state(ref_states) -> ChainState:
    """Stack per-chain reference states into one (C, ...) port state."""
    return ChainState(*(torch.tensor(np.stack([np.asarray(getattr(s, f))
                                               for s in ref_states]))
                        for f in ChainState._fields))


def check_state(ref_states, st: ChainState, atol: float = 1e-5):
    for c, rs in enumerate(ref_states):
        assert np.array_equal(to_np(st.assignment[c]),
                              np.asarray(rs.assignment)), f"chain {c}"
        for f in ("used", "coloc", "topo"):
            assert np.array_equal(to_np(getattr(st, f)[c]),
                                  np.asarray(getattr(rs, f))), (f, c)
        np.testing.assert_allclose(to_np(st.load[c]), np.asarray(rs.load),
                                   atol=atol, rtol=0)


class TestSweep:
    @pytest.mark.parametrize("temp", [1.0, 0.01])
    @pytest.mark.parametrize("sticky", [False, True])
    @pytest.mark.parametrize("strategy", STRATEGIES)
    def test_step_matches_given_same_proposals(self, strategy, sticky, temp):
        S, N, C, M = 240, 32, 2, 48
        dp, tp, _, _ = staged_pair(S, N, 11, strategy=strategy, coloc=True,
                                   preferred=strategy == "fill_lowest")
        rng = np.random.default_rng(11)
        if sticky:
            prev = rng.integers(0, N, S).astype(np.int32)
            dp = dataclasses.replace(dp, sticky_prev=jnp.asarray(prev),
                                     sticky_w=jnp.float32(0.5))
            tp = dataclasses.replace(tp, sticky_prev=torch.tensor(prev),
                                     sticky_w=0.5)
        inits = rng.integers(0, N, (C, S)).astype(np.int32)
        ref_states = [ref_anneal.chain_states_from_assignment(
            dp, jnp.asarray(inits[c])) for c in range(C)]
        st = port_state(ref_states)
        keys = jax.random.split(jax.random.PRNGKey(7), C)
        total_applied = 0
        for sweep in range(3):
            draws = []
            for c in range(C):
                k = jax.random.fold_in(keys[c], sweep)
                draws.append(jax_draws(dp, ref_states[c], k, M))
                ref_states[c], acc = _ref_step(dp, ref_states[c], k,
                                               jnp.float32(temp), M)
                total_applied += int(acc)
            s_idx, b_idx, u = (torch.tensor(np.stack(x)) for x in zip(*draws))
            st, applied = port_anneal.batched_step_apply(
                tp, st, s_idx.to(torch.int32), b_idx.to(torch.int32), u, temp)
            check_state(ref_states, st)
            assert int(applied.sum()) >= 0
        assert total_applied > 0

    def test_spread_constraint_delta(self):
        """max_skew > 0 exercises the topology term of the delta."""
        S, N, M = 160, 24, 40
        dp, tp, _, _ = staged_pair(S, N, 12, max_skew=1, domains=6)
        a = np.random.default_rng(12).integers(0, 4, S).astype(np.int32)
        rs = ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a))
        st = port_state([rs])
        for sweep in range(3):
            k = jax.random.fold_in(jax.random.PRNGKey(3), sweep)
            s_idx, b_idx, u = jax_draws(dp, rs, k, M)
            rs, _ = _ref_step(dp, rs, k, jnp.float32(0.5), M)
            port_anneal.batched_step_apply(
                tp, st, torch.tensor(s_idx[None]).int(),
                torch.tensor(b_idx[None]).int(), torch.tensor(u[None]), 0.5)
            check_state([rs], st)

    def test_draws_have_requested_shape(self):
        _, tp, _, _ = staged_pair(100, 16, 1)
        st = port_anneal.chain_states_from_assignment(
            tp, torch.zeros((3, 100), dtype=torch.int32))
        gen = torch.Generator().manual_seed(0)
        s_idx, b_idx, u = port_anneal.draw_proposals(tp, st, gen, 33)
        assert s_idx.shape == b_idx.shape == u.shape == (3, 33)
        assert s_idx.dtype == b_idx.dtype == torch.int32
        assert int(s_idx.max()) < 100 and int(b_idx.max()) < 16
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


class TestPrerepair:
    @pytest.mark.parametrize("max_moves", [3, 256])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_after_nodes_killed(self, seed, max_moves):
        S, N = 300, 40
        dp, tp, _, _ = staged_pair(S, N, seed, coloc=True, max_skew=3,
                                   domains=4)
        rng = np.random.default_rng(seed)
        a = rng.integers(0, N, S).astype(np.int32)
        dead = rng.choice(N, 4, replace=False)
        valid = np.ones(N, dtype=bool)
        valid[dead] = False
        dp = dataclasses.replace(dp, node_valid=jnp.asarray(valid))
        tp = dataclasses.replace(tp, node_valid=torch.tensor(valid))
        rs = ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a))
        rs, ref_moves = _ref_prerepair(dp, rs, max_moves)
        st = port_anneal.chain_states_from_assignment(tp, torch.tensor(a))
        st, moves = port_anneal.prerepair_state_counted(tp, st, max_moves)
        assert int(moves[0]) == int(ref_moves)
        check_state([rs], st, atol=0.0)
        if max_moves > 100:
            assert not np.isin(to_np(st.assignment[0]), dead).any()

    @pytest.mark.parametrize("seed", [0, 3])
    def test_uncounted_form_matches_reference(self, seed):
        """prerepair_state (the uncounted face) equals the reference's
        namesake on the same stranded state."""
        dp, tp, _, _ = staged_pair(240, 32, seed, coloc=True)
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 32, 240).astype(np.int32)
        valid = np.ones(32, dtype=bool)
        valid[rng.choice(32, 3, replace=False)] = False
        dp = dataclasses.replace(dp, node_valid=jnp.asarray(valid))
        tp = dataclasses.replace(tp, node_valid=torch.tensor(valid))
        rs = jax.jit(ref_anneal.prerepair_state, static_argnums=(2,))(
            dp, ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a)),
            256)
        st = port_anneal.prerepair_state(
            tp, port_anneal.chain_states_from_assignment(tp, torch.tensor(a)),
            256)
        assert isinstance(st, ChainState)
        check_state([rs], st, atol=0.0)

    def test_unplaceable_service_is_not_a_move(self):
        dp, tp, _, _ = staged_pair(50, 8, 2, n_tenants=1)
        valid = np.zeros(8, dtype=bool)
        valid[0] = True
        a = np.full(50, 3, dtype=np.int32)
        elig = np.asarray(tp.eligible).copy()
        elig[5] = 0                         # service 5: eligible nowhere
        tp = dataclasses.replace(tp, node_valid=torch.tensor(valid),
                                 eligible=torch.tensor(elig))
        dp = dataclasses.replace(dp, node_valid=jnp.asarray(valid),
                                 eligible=jnp.asarray(elig.view(np.uint32)))
        rs, ref_moves = _ref_prerepair(
            dp, ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a)),
            64)
        st = port_anneal.chain_states_from_assignment(tp, torch.tensor(a))
        st, moves = port_anneal.prerepair_state_counted(tp, st, 64)
        assert int(moves[0]) == int(ref_moves) == 49
        check_state([rs], st, atol=0.0)


    @pytest.mark.parametrize("max_moves", [1, 256])
    @pytest.mark.parametrize("packed", [True, False])
    def test_ties_and_budget_match_reference(self, packed, max_moves):
        """Identical nodes and demands, every service eligible everywhere,
        the crowded nodes 0-3 down: the empty nodes tie on utilization
        (the first index wins); service 0 may use only dead nodes, so a
        budget of 1 attempts it and moves nothing."""
        S, N = 120, 24
        dp, tp, _, _ = staged_pair(S, N, 5, packed=packed, n_tenants=1)
        valid = np.ones(N, dtype=bool)
        valid[:4] = False
        cap = np.full((N, 3), 8.0, dtype=np.float32)
        dem = np.full((S, 3), 0.5, dtype=np.float32)
        elig = np.ones((S, N), dtype=bool)
        elig[0, 4:] = False
        a = (np.arange(S) % 8).astype(np.int32)
        t_elig = torch.tensor(elig)
        d_elig = jnp.asarray(elig)
        if packed:
            words = np.packbits(np.pad(elig, ((0, 0), (0, (-N) % 32))),
                                axis=1, bitorder="little").view(np.uint32)
            t_elig = torch.tensor(words.view(np.int32))
            d_elig = jnp.asarray(words)
        tp = dataclasses.replace(tp, node_valid=torch.tensor(valid),
                                 capacity=torch.tensor(cap),
                                 demand=torch.tensor(dem), eligible=t_elig)
        dp = dataclasses.replace(dp, node_valid=jnp.asarray(valid),
                                 capacity=jnp.asarray(cap),
                                 demand=jnp.asarray(dem), eligible=d_elig)
        rs, ref_moves = _ref_prerepair(
            dp, ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a)),
            max_moves)
        st = port_anneal.chain_states_from_assignment(tp, torch.tensor(a))
        st, moves = port_anneal.prerepair_state_counted(tp, st, max_moves)
        assert int(moves[0]) == int(ref_moves)
        assert int(moves[0]) == (0 if max_moves == 1 else 59)
        check_state([rs], st, atol=0.0)


class TestCarriedScores:
    @pytest.mark.parametrize("strategy", STRATEGIES)
    def test_state_stats_and_soft_match(self, strategy):
        S, N = 200, 30
        dp, tp, _, _ = staged_pair(S, N, 6, strategy=strategy, coloc=True,
                                   max_skew=2, domains=3)
        rng = np.random.default_rng(6)
        prev = rng.integers(0, N, S).astype(np.int32)
        dp = dataclasses.replace(dp, sticky_prev=jnp.asarray(prev),
                                 sticky_w=jnp.float32(0.5))
        tp = dataclasses.replace(tp, sticky_prev=torch.tensor(prev),
                                 sticky_w=0.5)
        a = np.where(rng.random(S) < 0.5, prev,
                     rng.integers(0, N, S)).astype(np.int32)
        rs = ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a))
        st = port_anneal.chain_states_from_assignment(tp, torch.tensor(a))
        ref = ref_anneal.state_violation_stats(dp, rs)
        port = port_anneal.state_violation_stats(tp, st)
        for k in ref:
            assert float(port[k][0]) == float(ref[k]), k
        np.testing.assert_allclose(
            float(port_anneal.state_soft_score(tp, st)[0]),
            float(ref_anneal.state_soft_score(dp, rs)), rtol=1e-5, atol=1e-5)
        inelig = port_anneal._inelig_count(tp, st.assignment)
        assert float(port_anneal.violation_total_from_parts(
            tp, st.load, st.used, st.topo, inelig)[0]) == float(ref["total"])

    def test_temperature_schedule_matches(self):
        for i in (0, 1, 17, 127, 500):
            ref = float(jnp.float32(1.0) * (1e-3 ** (1.0 / 127))
                        ** jnp.minimum(i, 127).astype(jnp.float32))
            assert port_anneal.temperature(1.0, 1e-3, 128, i) == \
                pytest.approx(ref, rel=1e-6)


class TestAdaptive:
    def test_best_ever_and_feasible_exit(self):
        _, tp, _, _ = staged_pair(200, 30, 8)
        rng = np.random.default_rng(8)
        inits = torch.tensor(rng.integers(0, 30, (2, 200)).astype(np.int32))
        gen = torch.Generator().manual_seed(0)
        best, viol, soft, sweeps, acc, telem = \
            port_anneal.anneal_adaptive_states(
                tp, inits, gen, max_steps=64, block=4, trace_blocks=32)
        v0 = float(telem["init_violations"])
        assert float(viol.min()) <= v0
        assert sweeps % 4 == 0 and 0 < sweeps <= 64
        assert len(telem["blocks"]) == sweeps // 4
        if float(viol.min()) == 0:       # exited at the first feasible block
            assert sweeps < 64
        # the returned best states are what their scores say
        st = port_anneal.chain_states_from_assignment(tp, best)
        again = port_anneal.state_violation_stats(tp, st)["total"]
        assert torch.equal(again, viol)
        assert int(acc.sum()) > 0

    @pytest.mark.parametrize("feasible_init", [False, True])
    def test_anneal_adaptive_matches_reference_contract(self, feasible_init):
        """anneal_adaptive and the reference's namesake, from the same
        (C, S) starts: the draws differ (torch's generator is not
        threefry), so each is held to the reference's results where they
        do not depend on the draws: the shapes, the block-multiple sweep
        count, one block from a feasible start, and a feasible best."""
        dp, tp, _, _ = staged_pair(200, 30, 8)
        rng = np.random.default_rng(8)
        inits = rng.integers(0, 30, (2, 200)).astype(np.int32)
        if feasible_init:
            best, *_ = port_anneal.anneal_adaptive_states(
                tp, torch.tensor(inits), torch.Generator().manual_seed(1),
                max_steps=128, block=4)
            inits = np.repeat(to_np(best[:1]), 2, axis=0)
            assert float(ref_kernels.total_violations(dp, inits[0])) == 0
        ref_best, ref_sweeps, ref_acc = ref_anneal.anneal_adaptive(
            dp, jnp.asarray(inits), jax.random.PRNGKey(0), max_steps=64,
            block=8)
        best, sweeps, acc = port_anneal.anneal_adaptive(
            tp, torch.tensor(inits), torch.Generator().manual_seed(0),
            max_steps=64, block=8)
        assert best.shape == ref_best.shape and best.dtype == torch.int32
        assert acc.shape == ref_acc.shape
        assert sweeps % 8 == 0 and int(ref_sweeps) % 8 == 0
        if feasible_init:
            assert sweeps == int(ref_sweeps) == 8
        ref_viol = min(float(ref_kernels.total_violations(dp, b))
                       for b in np.asarray(ref_best))
        port_viol = min(float(ref_kernels.total_violations(dp, b))
                        for b in to_np(best))
        assert ref_viol == port_viol == 0

    def test_exit_on_feasible_init_runs_no_sweep(self):
        _, tp, _, _ = staged_pair(120, 24, 9)
        gen = torch.Generator().manual_seed(0)
        inits = torch.zeros((1, 120), dtype=torch.int32)
        best, viol, *_ = port_anneal.anneal_adaptive_states(
            tp, inits, gen, max_steps=128, block=1)
        assert float(viol[0]) == 0
        st = port_anneal.chain_states_from_assignment(tp, best[0])
        out = port_anneal.anneal_adaptive_states(
            tp, best.expand(2, -1), gen, max_steps=16, block=1,
            init_states=st.expand(2), exit_on_feasible_init=True)
        assert out[3] == 0 and float(out[1].max()) == 0
        fixed = port_anneal.anneal_states(tp, best, gen, steps=4)
        assert fixed.assignment.shape == (1, 120)
