"""K3 parity (fleetflow_tpu_torch/solver/kernels.py): the plain version of
the exact rebuild and violation gate against the JAX package's
chain_states_from_assignment / violation_stats / soft_score, on the CPU.

Integer planes and stats must match exactly; the load plane within
rtol=1e-6 (both sum each node's rows in service-index order, so it is in
practice bit-equal); the soft score within 1e-5 relative (its (N, R) sums
reduce in a different order).
"""

from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.solver import kernels as ref_kernels
from fleetflow_tpu_torch.solver import kernels as port_kernels
from fleetflow_tpu_torch.solver.anneal import chain_states_from_assignment
from test_torch_problem import STRATEGIES, staged_pair, to_np

# the solver package re-exports a function named `anneal`
ref_anneal = importlib.import_module("fleetflow_tpu.solver.anneal")


def _assignments(kind: str, S: int, N: int, seed: int, pt) -> np.ndarray:
    """Random, overloaded (a third of the fleet on 3 nodes) or conflicted
    (every port-holding service on node 0) assignments."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, N, S).astype(np.int32)
    if kind == "overloaded":
        heavy = rng.choice(S, S // 3, replace=False)
        a[heavy] = rng.integers(0, 3, heavy.size)
    elif kind == "conflicted":
        a[(pt.port_ids >= 0).any(axis=1)] = 0
    return a


def _check_planes(ref_st, load, used, coloc, topo):
    np.testing.assert_allclose(to_np(load), np.asarray(ref_st.load),
                               rtol=1e-6, atol=0)
    assert np.array_equal(to_np(used), np.asarray(ref_st.used))
    assert np.array_equal(to_np(coloc), np.asarray(ref_st.coloc))
    assert np.array_equal(to_np(topo), np.asarray(ref_st.topo))


class TestRebuild:
    @pytest.mark.parametrize("kind", ["random", "overloaded", "conflicted"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_rebuild_and_stats_match(self, kind, seed):
        dp, tp, ref_pt, _ = staged_pair(300, 40, seed, coloc=True,
                                        max_skew=2, domains=5)
        a = _assignments(kind, 300, 40, seed, ref_pt)
        ref_st = ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a))
        load, used, coloc, topo, stats = port_kernels.k3_rebuild(
            tp, torch.tensor(a), with_stats=True)
        _check_planes(ref_st, load[0], used[0], coloc[0], topo[0])
        ref_stats = ref_kernels.violation_stats(dp, jnp.asarray(a))
        for i, k in enumerate(port_kernels.STAT_KEYS):
            assert float(stats[0, i]) == float(ref_stats[k]), k
        if kind != "random":
            assert float(ref_stats["total"]) > 0

    def test_out_of_range_rows_dropped_like_xla(self):
        """An assignment past the last node adds to no load or occupancy
        plane, as the reference's ``.at[].add`` drops it. The stats differ
        on purpose (ROADMAP, deliberate differences): the port counts such
        a service off every node (2 eligibility violations, no topology
        domain); the reference's clamped gathers read node N-1's validity
        and topology domain and a bit of the last packed word. Both rules
        are asserted, the capacity and conflict stats equal."""
        N, T = 40, 5
        dp, tp, ref_pt, _ = staged_pair(300, N, 3, coloc=True,
                                        max_skew=2, domains=T)
        a = _assignments("random", 300, N, 3, ref_pt)
        a[:11] = N
        a[50:53] = N + 7
        ref_st = ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a))
        load, used, coloc, topo, stats = port_kernels.k3_rebuild(
            tp, torch.tensor(a), with_stats=True)
        np.testing.assert_allclose(to_np(load[0]), np.asarray(ref_st.load),
                                   rtol=1e-6, atol=0)
        assert np.array_equal(to_np(used[0]), np.asarray(ref_st.used))
        assert np.array_equal(to_np(coloc[0]), np.asarray(ref_st.coloc))
        inr = a < N
        rows = np.flatnonzero(inr)
        n_out = int((~inr).sum())
        topo_port = np.bincount(ref_pt.node_topology[a[rows]], minlength=T)
        topo_ref = topo_port.copy()
        topo_ref[ref_pt.node_topology[N - 1]] += n_out
        assert np.array_equal(to_np(topo[0]), topo_port)
        assert np.array_equal(np.asarray(ref_st.topo), topo_ref)
        in_bad = ((~ref_pt.eligible[rows, a[rows]]).sum()
                  + (~ref_pt.node_valid[a[rows]]).sum())
        ref_stats = ref_kernels.violation_stats(dp, jnp.asarray(a))
        assert float(stats[0, 2]) == float(in_bad + 2 * n_out)
        # the reference: the packed word's index clamps, its bit does not
        words = np.asarray(dp.eligible)
        out = np.flatnonzero(~inr)
        word = words[out, np.minimum(a[out] >> 5, words.shape[1] - 1)]
        ref_inelig = int(((word >> (a[out] & 31)) & 1 == 0).sum())
        assert float(ref_stats["eligibility"]) == float(
            in_bad + ref_inelig + n_out * (not ref_pt.node_valid[N - 1]))
        assert float(ref_stats["eligibility"]) < float(stats[0, 2])
        for i in (0, 1):
            key = port_kernels.STAT_KEYS[i]
            assert float(stats[0, i]) == float(ref_stats[key]), key

    def test_phantom_rows_carry_no_topology(self):
        """n_real < S: rows past n_real add load and occupancy but no
        topology weight, in the rebuild and in the skew stat."""
        dp, tp, ref_pt, _ = staged_pair(200, 30, 2, max_skew=1, domains=4)
        dp = dataclasses.replace(dp, n_real=jnp.asarray(150, jnp.int32))
        tp = dataclasses.replace(tp, n_real=150)
        a = _assignments("overloaded", 200, 30, 7, ref_pt)
        ref_st = ref_anneal.chain_states_from_assignment(dp, jnp.asarray(a))
        load, used, coloc, topo, stats = port_kernels.k3_rebuild(
            tp, torch.tensor(a), with_stats=True)
        _check_planes(ref_st, load[0], used[0], coloc[0], topo[0])
        assert int(topo.sum()) == 150
        ref_stats = ref_kernels.violation_stats(dp, jnp.asarray(a))
        assert float(stats[0, 3]) == float(ref_stats["skew"])
        assert float(stats[0, 4]) == float(ref_stats["total"])

    def test_rebuild_onto_frozen_base(self):
        dp, tp, _, _ = staged_pair(120, 20, 3, coloc=True)
        rng = np.random.default_rng(3)
        a = rng.integers(0, 20, 120).astype(np.int32)
        load0 = rng.random((20, 3)).astype(np.float32) * 5
        used0 = rng.integers(0, 2, (20, tp.G)).astype(np.int32)
        coloc0 = rng.integers(0, 2, (20, max(tp.Gc, 1))).astype(np.int32)
        topo0 = rng.integers(0, 3, tp.T).astype(np.int32)
        ref_st = ref_anneal.chain_states_from_assignment(
            dp, jnp.asarray(a),
            base=tuple(jnp.asarray(x) for x in (load0, used0, coloc0, topo0)))
        st = chain_states_from_assignment(
            tp, torch.tensor(a),
            base=tuple(torch.tensor(x) for x in (load0, used0, coloc0, topo0)))
        _check_planes(ref_st, st.load[0], st.used[0], st.coloc[0], st.topo[0])

    def test_batched_chains_match_one_by_one(self):
        dp, tp, _, _ = staged_pair(150, 25, 4)
        rng = np.random.default_rng(4)
        a = rng.integers(0, 25, (3, 150)).astype(np.int32)
        load, used, coloc, topo, stats = port_kernels.k3_rebuild(
            tp, torch.tensor(a), with_stats=True)
        for c in range(3):
            ref_st = ref_anneal.chain_states_from_assignment(
                dp, jnp.asarray(a[c]))
            _check_planes(ref_st, load[c], used[c], coloc[c], topo[c])
            ref_stats = ref_kernels.violation_stats(dp, jnp.asarray(a[c]))
            assert float(stats[c, 4]) == float(ref_stats["total"])


class TestSoft:
    @pytest.mark.parametrize("strategy", STRATEGIES)
    def test_soft_score_matches(self, strategy):
        dp, tp, _, _ = staged_pair(200, 30, 5, strategy=strategy,
                                   preferred=True, coloc=True)
        a = np.random.default_rng(5).integers(0, 30, 200).astype(np.int32)
        ref = float(ref_kernels.soft_score(dp, jnp.asarray(a)))
        stats, soft = port_kernels.exact_stats_and_soft(tp, torch.tensor(a))
        np.testing.assert_allclose(float(soft), ref, rtol=1e-5, atol=1e-6)
        assert float(port_kernels.soft_score(tp, torch.tensor(a))) == float(soft)
        ref_stats = ref_kernels.violation_stats(dp, jnp.asarray(a))
        assert float(stats["total"]) == float(ref_stats["total"])

    def test_node_loads_and_group_counts_match(self):
        dp, tp, ref_pt, _ = staged_pair(180, 26, 6, coloc=True)
        a = _assignments("overloaded", 180, 26, 6, ref_pt)
        np.testing.assert_allclose(
            to_np(port_kernels.node_loads(tp, torch.tensor(a))),
            np.asarray(ref_kernels.node_loads(dp, jnp.asarray(a))),
            rtol=1e-6, atol=0)
        for ids, G in ((dp.conflict_ids, dp.G), (dp.coloc_ids, dp.Gc)):
            ref = np.asarray(ref_kernels.group_counts(dp, jnp.asarray(a),
                                                      ids, G))
            port = to_np(port_kernels.group_counts(
                tp, torch.tensor(a), torch.tensor(np.asarray(ids)), G))
            assert np.array_equal(ref, port)
