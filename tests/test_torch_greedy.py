"""K4 parity (fleetflow_tpu_torch/solver/greedy.py): the plain version of the
batched greedy seed against the JAX package's greedy_place_batched on the
CPU. The assignment must match exactly, for rounds 1 and 2, the three
strategies, a preference plane, S not a multiple of the batch, and the
bucketed 2000x200 tier with more batch-mates than nodes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synth
from fleetflow_tpu.solver import buckets as ref_buckets
from fleetflow_tpu.solver import greedy as ref_greedy
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.solver import buckets as port_buckets
from fleetflow_tpu_torch.solver import greedy as port_greedy
from fleetflow_tpu_torch.solver import problem as port_problem
from test_torch_problem import STRATEGIES, staged_pair, to_np


def _orders(ref_pt, port_pt, dp, tp):
    ref = ref_greedy.placement_order(ref_pt.demand, ref_pt.dep_depth,
                                     np.asarray(dp.conflict_ids))
    port = port_greedy.placement_order(port_pt.demand, port_pt.dep_depth,
                                       to_np(tp.conflict_ids))
    assert np.array_equal(ref, port) and ref.dtype == port.dtype
    return ref


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batched_seed_matches(strategy, rounds):
    # S = 330 with batch 64: five full batches and a ragged sixth
    dp, tp, ref_pt, port_pt = staged_pair(330, 48, 21, strategy=strategy)
    order = _orders(ref_pt, port_pt, dp, tp)
    ref = np.asarray(ref_greedy.greedy_place_batched(
        dp, jnp.asarray(order), batch=64, rounds=rounds))
    port = to_np(port_greedy.greedy_place_batched(
        tp, torch.tensor(order), batch=64, rounds=rounds))
    assert port.dtype == np.int32
    assert np.array_equal(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_seed_matches_with_preferences_and_tight_nodes(seed):
    """A preference plane, and a batch wider than the node count (W = N)."""
    dp, tp, ref_pt, port_pt = staged_pair(200, 24, seed, n_tenants=2,
                                          preferred=True)
    order = _orders(ref_pt, port_pt, dp, tp)
    ref = np.asarray(ref_greedy.greedy_place_batched(
        dp, jnp.asarray(order), batch=48, rounds=2))
    port = to_np(port_greedy.greedy_place_batched(
        tp, torch.tensor(order), batch=48, rounds=2))
    assert np.array_equal(ref, port)


def test_dense_layout_matches_packed():
    dp, tp, ref_pt, port_pt = staged_pair(150, 40, 3, packed=False)
    _, tp_packed, _, _ = staged_pair(150, 40, 3, packed=True)
    order = _orders(ref_pt, port_pt, dp, tp)
    dense = to_np(port_greedy.greedy_place_batched(tp, torch.tensor(order),
                                                   batch=32))
    packed = to_np(port_greedy.greedy_place_batched(
        tp_packed, torch.tensor(order), batch=32))
    ref = np.asarray(ref_greedy.greedy_place_batched(dp, jnp.asarray(order),
                                                     batch=32))
    assert np.array_equal(dense, packed) and np.array_equal(dense, ref)


def test_rejects_bad_rounds():
    _, tp, _, _ = staged_pair(20, 4, 0)
    with pytest.raises(ValueError):
        port_greedy.greedy_place_batched(tp, torch.arange(20).int(), rounds=3)


@pytest.fixture(scope="module")
def bucketed_tier():
    """The 2000x200 mux tier (the reference bench's stage 0) on its bucketed
    staging in both packages, and the order the main path gives K4: the
    placement order, then the phantom rows."""
    kw = dict(seed=0, port_fraction=0.3, volume_fraction=0.2)
    ref_pt = ref_synth(2000, 200, **kw)
    port_pt = synthetic_problem(2000, 200, **kw)
    dp, _ = ref_buckets.stage_problem_tiers(ref_pt,
                                            reuse_device_constants=False)
    tp, _ = port_buckets.stage_problem_tiers(port_pt,
                                             device=torch.device("cpu"))
    assert tp.S > port_pt.S          # the tier pads: phantom rows exist
    ref_order = ref_greedy.placement_order(
        ref_pt.demand, ref_pt.dep_depth,
        np.asarray(dp.conflict_ids)[:ref_pt.S])
    order = port_greedy.placement_order(
        port_pt.demand, port_pt.dep_depth,
        port_problem.unify_conflict_ids(port_pt))
    assert np.array_equal(ref_order, order)
    order = np.concatenate([order, np.arange(port_pt.S, tp.S,
                                             dtype=np.int32)])
    return dp, tp, order


@pytest.mark.parametrize("batch", [256, 1024])
def test_batched_seed_matches_on_a_bucketed_tier(bucketed_tier, batch):
    """More batch-mates than nodes share a node here, so the batch-mates'
    demand prefix and the commit add many duplicates: the port's plain
    version (one service at a time, in batch order) equals the reference's
    (`mates @ d` and a scatter-add) bit for bit."""
    dp, tp, order = bucketed_tier
    ref = np.asarray(ref_greedy.greedy_place_batched(
        dp, jnp.asarray(order), batch=batch, rounds=2))
    port = to_np(port_greedy.greedy_place_batched(
        tp, torch.tensor(order), batch=batch, rounds=2))
    assert np.array_equal(ref, port), int((ref != port).sum())
