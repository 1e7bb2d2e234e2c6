"""fleetflow_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card, at small sizes, over the branches chip_smoke.py's headline
instance does not reach: pack and fill_lowest strategies, a preference
plane, the dense eligibility layout, a spread constraint, phantom rows,
stickiness, a frozen base, the lane axis of K1-K3 (1, 3 and 16 lanes, an
inactive lane) and a place_many batch; K5, the sub-solve's stage (the
mini problem and its frozen base) and commit, at the 10k x 1k headline
size with mini tiers of 256 and 4096 rows, and on a resident staging
after arrivals into phantom rows with 6 topology domains; K6, the
per-service scan seed, at 2000 x 200 for each strategy and on best-effort
instances; the host placer's build and the host seeds of
solve() on the card; K7, the sharded sweep, at 2000 x 200 on one-card
meshes of 1 x 8 and 2 x 4 positions, and a cold and a warm solve_sharded;
K4's selection where it is hardest (scores tied across nodes, fewer
feasible nodes than the batch width, no feasible node, N = 1500 and
20000, the bucketed 2000 x 200 tier) and its single device launch; K3
with several assignment tiles, a node holding half the services, and
lanes with a frozen base, phantom rows and out-of-range rows, its loads
bit-equal to the plain version on the CPU (which adds in service order);
K2 with utilization ties, a budget of 1 and of 256 moves around a service
no live node can take, and 500, 2,000 and 10,000 nodes (the last one's
planes in global memory); K1 with many winners leaving each crowded node at T = 1, and
with duplicate services and targets over 16 sticky, skewed lanes, its
loads bit-equal to the plain version on the CPU; K6 with more nodes than
a block has threads (512 x 3,000, a preference plane), with 40 and 160
conflict ids a service, with its
occupancy bitmap past shared memory and every node tied for half the
services, and with every node full from the first service on; K7 with
many winners leaving three crowded nodes from every shard at T = 1, with
a service drawn many times in one position, M not a multiple of 32 and
D = 1, 5 and 8, and its bound launcher reused over sweeps and built again
after a merge, its loads bit-equal to the plain version on the CPU; K7's
cross-rank entry points (elect, apply, reduce) for every position of 1 x 8
and 2 x 4 meshes against their plain versions on the CPU, entry point by
entry point, also at M 128, 256, 2,048 and the widest the bind takes, on
chip_smoke's adversarial draws, and a wider M refused at bind time.

Every test needs a CUDA card and skips without one. On the card (which has
no JAX, so the repository's conftest cannot load):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerances: assignments, integer planes, stats and move counts must be
equal (K5's staged planes and committed assignments too: they are
copies and counts, and K5's frozen load adds in row order, as its plain
version on the CPU does). Loads: the plain versions add with index_add_, which on the card
groups the contributions to one row before adding them, where the kernels
add one at a time in index order; float32 loads agree to rtol 1e-5.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from fleetflow_tpu_torch import _ext
from fleetflow_tpu_torch.core.model import PlacementStrategy
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.solver import anneal, greedy, kernels, subsolve
from fleetflow_tpu_torch.solver.buckets import stage_problem_tiers
from fleetflow_tpu_torch.solver.problem import (prepare_problem,
                                                unify_conflict_ids)

pytestmark = pytest.mark.gpu
STRATEGIES = ("spread_across_pool", "pack_into_dedicated", "fill_lowest")
LOAD_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda", 0)
    torch.use_deterministic_algorithms(False)


def _problem(dev, S=600, N=80, seed=0, strategy="spread_across_pool",
             packed=True, preferred=False, skew=0, coloc=True, n_real=None):
    pt = synthetic_problem(S, N, seed=seed, n_tenants=3,
                           strategy=PlacementStrategy(strategy))
    rng = np.random.default_rng(seed)
    kw = {}
    if preferred:
        kw["preferred"] = (rng.random((S, N)) * 0.5).astype(np.float32)
    if coloc:
        kw["coloc_ids"] = rng.integers(-1, 5, (S, 2)).astype(np.int32)
    if skew:
        kw["max_skew"] = skew
        kw["node_topology"] = (np.arange(N) % 6).astype(np.int32)
    pt = dataclasses.replace(pt, **kw)
    prob = prepare_problem(pt, dev, packed=packed)
    if n_real is not None:
        prob = dataclasses.replace(prob, n_real=n_real)
    return pt, prob


def _equal_states(a, b, scale_atol: bool = False):
    """Equal integer planes; loads within LOAD_RTOL of each value or, with
    `scale_atol`, of the plane's largest load (the lane tests: over many
    chains a node loses most of its services in one sweep, and the two
    float orders leave different residues of the cancelled sum)."""
    for name in ("assignment", "used", "coloc", "topo"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    atol = LOAD_RTOL * float(b.load.abs().max()) if scale_atol else 0.0
    close = torch.isclose(a.load, b.load, rtol=LOAD_RTOL, atol=atol)
    assert bool(close.all()), (
        f"{int((~close).sum())} loads differ: "
        f"{a.load[~close][:4].tolist()} vs {b.load[~close][:4].tolist()}, "
        f"plane max {float(b.load.abs().max())}")


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("with_base", [False, True])
def test_k3_matches_plain(dev, packed, with_base):
    pt, prob = _problem(dev, packed=packed, skew=2, n_real=550)
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.integers(0, prob.N, (3, prob.S)), dtype=torch.int32,
                     device=dev)
    a[1, : prob.S // 3] = 0               # a crowded, overloaded node
    base = None
    if with_base:
        base = (torch.rand((prob.N, 3), device=dev) * 3,
                torch.randint(0, 2, (prob.N, prob.G), device=dev,
                              dtype=torch.int32),
                torch.randint(0, 2, (prob.N, max(prob.Gc, 1)), device=dev,
                              dtype=torch.int32),
                torch.randint(0, 2, (prob.T,), device=dev, dtype=torch.int32))
    before = dict(_ext.LAUNCHES)
    out = kernels.k3_rebuild(prob, a, base, with_stats=True)
    ref = kernels.k3_rebuild_plain(prob, a, base, with_stats=True)
    assert _ext.LAUNCHES["k3_rebuild"] == before["k3_rebuild"] + 1
    for x, y in zip(out[1:], ref[1:]):
        assert torch.equal(x, y)
    assert torch.allclose(out[0], ref[0], rtol=LOAD_RTOL, atol=0)
    assert float(out[4][1, 4]) > 0


@pytest.mark.parametrize("sticky", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_k1_matches_plain(dev, strategy, sticky):
    pt, prob = _problem(dev, strategy=strategy, packed=strategy != "fill_lowest",
                        preferred=strategy == "pack_into_dedicated",
                        skew=3 if strategy == "fill_lowest" else 0)
    rng = np.random.default_rng(2)
    if sticky:
        prob = dataclasses.replace(
            prob, sticky_prev=torch.tensor(rng.integers(0, prob.N, prob.S),
                                           dtype=torch.int32, device=dev),
            sticky_w=0.5)
    init = torch.tensor(rng.integers(0, prob.N, (2, prob.S)),
                        dtype=torch.int32, device=dev)
    st = anneal.chain_states_from_assignment(prob, init)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for temp in (1.0, 0.01):
        st_k, st_p = st.clone(), st.clone()
        applied = 0
        for _ in range(4):
            s_idx, b_idx, u = anneal.draw_proposals(prob, st_k, gen, 96)
            _, acc_k = anneal.batched_step_apply(prob, st_k, s_idx, b_idx, u,
                                                 temp)
            _, acc_p = anneal.batched_step_plain(prob, st_p, s_idx, b_idx, u,
                                                 temp)
            assert torch.equal(acc_k, acc_p)
            applied += int(acc_k.sum())
        _equal_states(st_k, st_p)
        assert applied > 0


@pytest.mark.parametrize("packed", [True, False])
def test_k2_matches_plain(dev, packed):
    pt, prob = _problem(dev, packed=packed, skew=2)
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.integers(0, prob.N, prob.S), dtype=torch.int32,
                     device=dev)
    valid = prob.node_valid.clone()
    valid[torch.tensor(rng.choice(prob.N, 6, replace=False), device=dev)] = False
    prob = dataclasses.replace(prob, node_valid=valid)
    st = anneal.chain_states_from_assignment(prob, a)
    for max_moves in (5, 256):
        st_k, st_p = st.clone(), st.clone()
        _, mv_k = anneal.prerepair_state_counted(prob, st_k, max_moves)
        _, mv_p = anneal.prerepair_plain(prob, st_p, max_moves)
        assert torch.equal(mv_k, mv_p) and int(mv_k[0]) > 0
        _equal_states(st_k, st_p)
        assert torch.equal(st_k.load, st_p.load)


def _k2_both(prob, st, max_moves):
    """K2 on the card against its plain version on the card and on the
    CPU: moves, assignment and integer planes equal, loads bit-equal (both
    plain versions add one move at a time, in the kernel's order)."""
    st_k, st_p = st.clone(), st.clone()
    before = _ext.LAUNCHES["k2_prerepair"]
    _, mv_k = anneal.prerepair_state_counted(prob, st_k, max_moves)
    assert _ext.LAUNCHES["k2_prerepair"] == before + 1
    _, mv_p = anneal.prerepair_plain(prob, st_p, max_moves)
    st_c = anneal.ChainState(*(t.to("cpu", copy=True) for t in st))
    _, mv_c = anneal.prerepair_plain(_on_cpu(prob), st_c, max_moves)
    assert torch.equal(mv_k, mv_p) and torch.equal(mv_k.cpu(), mv_c)
    for x, y, z in zip(st_k, st_p, st_c):
        assert torch.equal(x, y) and torch.equal(x.cpu(), z)
    return st_k, mv_k


def _down(prob, nodes):
    valid = prob.node_valid.clone()
    valid[torch.as_tensor(nodes, device=valid.device)] = False
    return dataclasses.replace(prob, node_valid=valid)


def test_k2_ties_take_the_first_node(dev):
    """Identical nodes, every service eligible everywhere, four of the
    eight crowded nodes down: the empty nodes tie on utilization, and the
    first stranded service lands on the first of them."""
    _pt, prob = _ties(dev)
    prob = dataclasses.replace(
        prob, eligible=torch.full_like(prob.eligible, -1))
    prob = _down(prob, [0, 1, 2, 3])
    a = torch.arange(prob.S, dtype=torch.int32, device=dev) % 8
    st_k, mv = _k2_both(prob, anneal.chain_states_from_assignment(prob, a),
                        256)
    assert int(mv[0]) == 200
    assert int(st_k.assignment[0, 0]) == 8


@pytest.mark.parametrize("max_moves", [1, 256])
def test_k2_budget_and_an_unplaceable_service(dev, max_moves):
    """Services 0-2 are eligible only on dead nodes: each is attempted and
    is not a move, so a budget of 1 moves nothing; 256 moves every other
    stranded service."""
    pt, _ = _problem(dev, S=600, N=80, seed=11)
    dead = [0, 1, 2, 3, 4, 5]
    elig = pt.eligible.copy()
    elig[:3] = False
    elig[:3, :2] = True
    prob = _down(prepare_problem(dataclasses.replace(pt, eligible=elig), dev),
                 dead)
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.integers(0, prob.N, prob.S), dtype=torch.int32,
                     device=dev)
    a[:3] = 0
    st_k, mv = _k2_both(prob, anneal.chain_states_from_assignment(prob, a),
                        max_moves)
    assert int(mv[0]) == 0 if max_moves == 1 else int(mv[0]) > 100
    assert torch.equal(st_k.assignment[0, :3], a[:3])


@pytest.mark.parametrize("N", [500, 2000, 10000])
def test_k2_many_nodes(dev, N):
    """2 and 8 nodes a loop thread (N = 500, 2000), and past what shared
    memory holds (N = 10000): 1,024 threads walk their nodes, the node
    state and the eligibility rows in the global scratch."""
    _pt, prob = _problem(dev, S=900, N=N, seed=12)
    rng = np.random.default_rng(12)
    a = torch.tensor(rng.integers(0, 300, prob.S), dtype=torch.int32,
                     device=dev)
    prob = _down(prob, rng.choice(300, 40, replace=False))
    st_k, mv = _k2_both(prob, anneal.chain_states_from_assignment(prob, a),
                        256)
    assert int(mv[0]) > 50


def _k1_against_cpu(prob, st_k, s_idx, b_idx, u, temp, active=None):
    """One K1 sweep on the card and the plain version on the CPU copies:
    applied counts, assignment and integer planes equal, loads bit-equal
    (the CPU's index_add_ adds in proposal order, the kernel's order)."""
    st_c = anneal.ChainState(*(t.to("cpu", copy=True) for t in st_k))
    _, acc_k = anneal.batched_step_apply(prob, st_k, s_idx, b_idx, u, temp,
                                         active)
    _, acc_c = anneal.batched_step_plain(_on_cpu(prob), st_c, s_idx.cpu(),
                                         b_idx.cpu(), u.cpu(), temp, active)
    assert torch.equal(acc_k.cpu(), acc_c)
    for x, y in zip(st_k, st_c):
        assert torch.equal(x.cpu(), y)
    return int(acc_k.sum())


def test_k1_departures_keep_their_order(dev):
    """T = 1, most services crowded on three nodes, each proposal moving
    one of them to its own target: many winners leave each crowded node,
    and their departures keep proposal order per node."""
    _pt, prob = _problem(dev, S=600, N=200, seed=13, coloc=True)
    rng = np.random.default_rng(13)
    a = torch.tensor(rng.integers(0, 3, (2, prob.S)), dtype=torch.int32,
                     device=dev)
    st = anneal.chain_states_from_assignment(prob, a)
    M = 192
    s_idx = torch.tensor(np.stack([rng.permutation(prob.S)[:M]
                                   for _ in range(2)]), dtype=torch.int32,
                         device=dev)
    b_idx = torch.tensor(np.stack([3 + rng.permutation(prob.N - 3)[:M]
                                   for _ in range(2)]), dtype=torch.int32,
                         device=dev)
    u = torch.zeros((2, M), dtype=torch.float32, device=dev)
    applied = _k1_against_cpu(prob, st, s_idx, b_idx, u, 1.0)
    assert applied > M
    left = torch.bincount(a[0].long(), minlength=prob.N)[:3] - torch.bincount(
        st.assignment[0].long(), minlength=prob.N)[:3]
    assert int(left.max()) >= 20


def test_k1_duplicates_sticky_skew_16_lanes(dev):
    """16 lanes with stickiness and a spread constraint, proposals drawn
    from 12 services and 6 target nodes (many per service and per target),
    lane 1 inactive: equal to the plain version on the CPU bit for bit."""
    prob, _solo = _lanes(dev, 16)
    st = anneal.chain_states_from_assignment(
        prob, _lane_assignments(dev, prob, 2, 14))
    rng = np.random.default_rng(14)
    active = [i != 1 for i in range(16)]
    temps = [2.0 / (1 + i) for i in range(16)]
    applied = 0
    for _ in range(4):
        s_idx = torch.tensor(rng.integers(0, 12, (16, 2, 128)),
                             dtype=torch.int32, device=dev)
        b_idx = torch.tensor(rng.integers(0, 6, (16, 2, 128)),
                             dtype=torch.int32, device=dev)
        u = torch.tensor(rng.random((16, 2, 128)), dtype=torch.float32,
                         device=dev)
        applied += _k1_against_cpu(prob, st, s_idx, b_idx, u, temps, active)
    assert applied > 0


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_k4_matches_plain(dev, strategy, rounds):
    pt, prob = _problem(dev, S=700, strategy=strategy,
                        packed=strategy != "pack_into_dedicated",
                        preferred=strategy == "fill_lowest")
    order = torch.tensor(greedy.placement_order(
        pt.demand, pt.dep_depth, unify_conflict_ids(pt)), dtype=torch.int32,
        device=dev)
    out = greedy.greedy_place_batched(prob, order, batch=64, rounds=rounds)
    ref = greedy.greedy_place_batched_plain(prob, order, batch=64,
                                            rounds=rounds)
    assert torch.equal(out, ref)


def _ties(dev, S=400, N=80):
    """Identical nodes and identical services: every empty node ties."""
    pt, prob = _problem(dev, S=S, N=N, coloc=False)
    return pt, dataclasses.replace(
        prob, capacity=torch.full_like(prob.capacity, 8.0),
        demand=torch.full_like(prob.demand, 0.5))


def _few_eligible(dev, S=400, N=80, k=3):
    """Each service eligible on k nodes of its own: count_ok < W = 64."""
    pt = synthetic_problem(S, N, seed=6, n_tenants=1)
    rng = np.random.default_rng(6)
    elig = np.zeros((S, N), bool)
    for s_ in range(S):
        elig[s_, rng.choice(N, k, replace=False)] = True
    pt = dataclasses.replace(pt, eligible=elig)
    return pt, prepare_problem(pt, dev)


def _infeasible(dev, S=300, N=80):
    """Every service too big for every node: all best-effort, with the
    -1e15 mask on a third of the (service, node) pairs."""
    pt, prob = _problem(dev, S=S, N=N)
    rng = np.random.default_rng(7)
    elig = rng.random((S, N)) > 0.33
    pt = dataclasses.replace(pt, eligible=elig)
    prob = prepare_problem(pt, dev)
    big = prob.capacity.max(0).values * 2.0 + 1.0
    return pt, dataclasses.replace(prob, demand=big.repeat(S, 1))


def _wide(dev, S, N, strategy="spread_across_pool"):
    """N neither a power of two nor below 1024 (or past the old 16384)."""
    pt = synthetic_problem(S, N, seed=8, n_tenants=4,
                           strategy=PlacementStrategy(strategy))
    return pt, prepare_problem(pt, dev)


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("strategy", [0, 1, 2])
@pytest.mark.parametrize("case", ["ties", "few_eligible", "infeasible",
                                  "wide_1500", "wide_20000"])
def test_k4_edge_cases_match_plain(dev, case, strategy, rounds):
    """K4 bit-equal to its plain version where the selection is hardest:
    scores tied across nodes, fewer feasible nodes than the batch width,
    no feasible node at all, N = 1500 and N = 20000 (past the shared-memory
    sort's old 16384 limit); one launch per seed."""
    if case == "ties":
        pt, prob = _ties(dev)
    elif case == "few_eligible":
        pt, prob = _few_eligible(dev)
    elif case == "infeasible":
        pt, prob = _infeasible(dev)
    elif case == "wide_1500":
        pt, prob = _wide(dev, 2000, 1500)
    else:
        pt, prob = _wide(dev, 1200, 20000)
    prob = dataclasses.replace(prob, strategy=strategy)
    order = torch.tensor(greedy.placement_order(
        pt.demand, pt.dep_depth, unify_conflict_ids(pt)), dtype=torch.int32,
        device=dev)
    before = _ext.LAUNCHES["k4_greedy"]
    out = greedy.greedy_place_batched(prob, order, batch=64, rounds=rounds)
    assert _ext.LAUNCHES["k4_greedy"] == before + 1
    ref = greedy.greedy_place_batched_plain(prob, order, batch=64,
                                            rounds=rounds)
    assert torch.equal(out, ref)
    if case == "ties":
        assert len(set(out.tolist())) > 1


@pytest.mark.parametrize("batch", [1024, 256, 64])
def test_k4_on_a_bucketed_tier(dev, batch):
    """The 2000x200 mux tier, staged with phantom rows and placed phantoms
    last: more batch services than nodes, so several commit to one node in
    a round (1024: the largest batch, more services than the block has
    threads). Bit-equal to the plain version on the card and on the CPU."""
    pt = synthetic_problem(2000, 200, seed=0, port_fraction=0.3,
                           volume_fraction=0.2)
    prob, _ = stage_problem_tiers(pt, device=dev)
    order = torch.tensor(np.concatenate([
        greedy.placement_order(pt.demand, pt.dep_depth,
                               unify_conflict_ids(pt)),
        np.arange(pt.S, prob.S, dtype=np.int32)]), dtype=torch.int32,
        device=dev)
    out = greedy.greedy_place_batched(prob, order, batch=batch)
    ref = greedy.greedy_place_batched_plain(prob, order, batch=batch)
    cpu = greedy.greedy_place_batched_plain(_on_cpu(prob), order.cpu(),
                                            batch=batch)
    assert torch.equal(ref.cpu(), cpu)
    assert torch.equal(out.cpu(), cpu)


def test_k4_is_one_device_launch(dev):
    """The seed is one cooperative launch, whatever the batch count (the
    deterministic algorithms are off, as in a solve: under them each
    torch.empty of the wrapper fills its memory)."""
    from torch.profiler import ProfilerActivity, profile
    torch.use_deterministic_algorithms(False)
    pt, prob = _problem(dev, S=700)
    order = torch.tensor(greedy.placement_order(
        pt.demand, pt.dep_depth, unify_conflict_ids(pt)), dtype=torch.int32,
        device=dev)
    greedy.greedy_place_batched(prob, order, batch=64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        greedy.greedy_place_batched(prob, order, batch=64)
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")}
    assert list(ops.values()) == [1] and "k4_seed" in next(iter(ops)), ops


def _on_cpu(prob):
    from fleetflow_tpu_torch.solver.problem import TENSOR_FIELDS
    return dataclasses.replace(prob, **{
        name: t.cpu() for name, t in zip(TENSOR_FIELDS, prob.tensors())
        if t is not None})


@pytest.mark.parametrize("S,N", [(6000, 700), (9000, 64)])
def test_k3_load_in_service_order(dev, S, N):
    """Several assignment tiles, a partial last warp block, a node holding
    half of the services: K3's load is bit-equal to the plain version on
    the CPU, whose scatter adds in service order."""
    pt, prob = _problem(dev, S=S, N=N, seed=9)
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.integers(0, N, (2, S)), dtype=torch.int32,
                     device=dev)
    a[1, : S // 2] = N - 1
    out = kernels.k3_rebuild(prob, a, with_stats=True)
    ref = kernels.k3_rebuild_plain(_on_cpu(prob), a.cpu(), with_stats=True)
    for x, y in zip(out, ref):
        assert torch.equal(x.cpu(), y)


def test_wrappers_raise_on_bad_input(dev):
    _, prob = _problem(dev)
    with pytest.raises(ValueError):
        kernels.k3_rebuild(prob, torch.zeros(prob.S, dtype=torch.int64,
                                             device=dev))
    with pytest.raises(ValueError):
        greedy.greedy_place_batched(prob, torch.arange(prob.S, device=dev))


def test_main_path_on_the_card(dev):
    """The default scheduler: a bucketed cold place, a one-node kill that
    localizes (K5 around K1-K3), then three more nodes down."""
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    from fleetflow_tpu_torch.solver.resident import ProblemDelta
    pt = synthetic_problem(800, 64, seed=5, n_tenants=3)
    sched = GpuSolverScheduler()
    _ext.reset_launches()
    first = sched.place(pt)
    assert first.feasible and sched.last_result.bucket["padded_S"] > 800
    busiest = np.argsort(-np.bincount(first.raw, minlength=pt.N))
    valid = pt.node_valid.copy()
    for dead in (busiest[:1], busiest[1:4]):
        valid[dead] = False
        pt = dataclasses.replace(pt, node_valid=valid.copy())
        again = sched.reschedule(pt, delta=ProblemDelta(
            node_valid=valid.copy()))
        assert again.feasible and pt.node_valid[again.raw].all()
        assert sched.last_result.warm_h2d_copies == 0
        if len(dead) == 1:
            assert sched.last_result.subsolve["outcome"] == "localized"
    # every kernel of the path launched (K6 seeds only solve(seed_impl=
    # "scan"), which the scheduler does not take; K7 is the sharded path)
    off = ("k6_greedy_scan", "k7_sharded_sweep", *_ext.ENTRY_POINTS)
    assert all(v > 0 for k, v in _ext.LAUNCHES.items()
               if k not in off), _ext.LAUNCHES
    assert all(_ext.LAUNCHES[k] == 0 for k in off)


@pytest.fixture(scope="module")
def headline(request):
    """The 10k x 1k headline fleet staged bucketed on the card, packed and
    dense with a preference plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    pt = synthetic_problem(10_000, 1_000, seed=0, n_tenants=8,
                           port_fraction=0.2, volume_fraction=0.1)
    packed, _ = stage_problem_tiers(pt, device=dev, packed=True)
    pref = (np.random.default_rng(0).random((pt.S, pt.N)) * 0.5).astype(
        np.float32)
    dense, _ = stage_problem_tiers(dataclasses.replace(pt, preferred=pref),
                                   device=dev, packed=False)
    return pt, {"packed": packed, "dense": dense}


def _plan_rows(S, S_pad, tier, seed):
    rng = np.random.default_rng(seed)
    n_sub = int(tier * 0.7)
    rows = np.full(tier, S_pad, dtype=np.int32)
    rows[:n_sub] = np.sort(rng.choice(S, n_sub, replace=False))
    return rows, n_sub


def _headline_plan(pt, prob, tier, seed):
    """A plan of the K5 stage on the headline staging: the closure rows
    as _plan_rows draws them, the id lists those rows carry, every real
    row's node drawn at random (the frozen base's input)."""
    from fleetflow_tpu_torch.solver.buckets import width_bucket
    rows, n_sub = _plan_rows(pt.S, prob.S, tier, seed)
    conflict = unify_conflict_ids(pt)
    conf, coloc = subsolve.closure_ids(conflict, pt.coloc_ids,
                                       rows[:n_sub].astype(np.int64))
    plan = subsolve.ActivePlan(
        rows=rows, n_sub=n_sub, tier=tier,
        G_sub=max(min(tier, prob.G), len(conf), 16),
        Gc_sub=0 if prob.Gc == 0 else max(min(tier // 4, prob.Gc),
                                          len(coloc), 4),
        conf_ids=conf.astype(np.int32), coloc_ids=coloc.astype(np.int32),
        n_real=pt.S, Kc=width_bucket(conflict.shape[1]),
        Cc=width_bucket(pt.coloc_ids.shape[1]))
    return plan


def _assert_stage_equal(prob, a, staged, plan):
    """K5 stage on the card, one launch, equal to its plain version on
    CPU copies (which adds the frozen load in row order) on every
    output."""
    before = _ext.LAUNCHES["k5_subsolve"]
    out = subsolve.k5_stage(prob, a, staged, plan)
    assert _ext.LAUNCHES["k5_subsolve"] == before + 1
    ref = subsolve.k5_stage_plain(_on_cpu(prob), a.cpu(), staged.cpu(),
                                  plan)
    for name, x, y in zip(subsolve.SubStage._fields, out, ref):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y), name
    return out


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("tier", [256, 4096])
def test_k5_stage_matches_plain(dev, headline, layout, tier):
    pt, probs = headline
    prob = dataclasses.replace(probs[layout])
    valid = prob.node_valid.clone()
    valid[:3] = False                        # phantoms park on node 3
    prob.node_valid = valid
    plan = _headline_plan(pt, prob, tier, tier)
    staged = torch.tensor(plan.packed(), device=dev)
    a = torch.randint(0, prob.N, (prob.S,), dtype=torch.int32, device=dev)
    out = _assert_stage_equal(prob, a, staged, plan)
    assert bool((out.seed[plan.n_sub:] == 3).all())
    assert int(out.used0.sum()) > 0 and len(plan.conf_ids) > 0


def test_k5_stage_after_arrivals_with_domains(dev):
    """The resident path on the card: a staging with 6 topology domains
    and coloc ids, a node killed and 5 id-free arrivals into phantom rows
    in one delta; the plan the resident takes, staged with one upload,
    equal to the plain stage; the arrivals' id rows are -1 on the card."""
    from fleetflow_tpu_torch.convert import resident_from_reference
    from fleetflow_tpu_torch.solver.buckets import pad_assignment
    from fleetflow_tpu_torch.solver.resident import (ProblemDelta,
                                                     ResidentProblem)
    rng = np.random.default_rng(3)
    pt = synthetic_problem(2000, 60, seed=3, n_tenants=3)
    coloc = np.where(rng.random((2000, 2)) < 0.1,
                     rng.integers(0, 30, (2000, 2)), -1).astype(np.int32)
    pt = dataclasses.replace(pt, coloc_ids=coloc, max_skew=4,
                             node_topology=(np.arange(60) % 6).astype(
                                 np.int32))
    padded_S = ResidentProblem(pt, torch.device("cpu")).prob.S
    ok = pt.eligible & pt.node_valid[None, :]
    real = np.argmax(rng.random(ok.shape) * ok, axis=1).astype(np.int32)
    mirror = pad_assignment(real, padded_S, pt.node_valid)
    rp = resident_from_reference(pt, mirror, True, device=dev)
    # 5 id-free arrivals (demand 0.01, eligible everywhere)
    k, S = 5, pt.S
    grow = lambda x: np.concatenate(  # noqa: E731
        [x, np.full((k, x.shape[1]), -1, dtype=x.dtype)])
    dem = np.full((k, 3), 0.01, dtype=np.float32)
    elig = np.ones((k, 60), dtype=bool)
    names = [f"arrival{i}" for i in range(k)]
    grown = dataclasses.replace(
        pt, service_names=pt.service_names + names,
        demand=np.concatenate([pt.demand, dem]),
        eligible=np.concatenate([pt.eligible, elig]),
        dep_adj=np.pad(pt.dep_adj, ((0, k), (0, k))),
        dep_depth=np.concatenate([pt.dep_depth,
                                  np.zeros(k, pt.dep_depth.dtype)]),
        port_ids=grow(pt.port_ids), volume_ids=grow(pt.volume_ids),
        anti_ids=grow(pt.anti_ids), coloc_ids=grow(pt.coloc_ids),
        replica_of=(pt.replica_of + names if pt.replica_of
                    else pt.replica_of))
    new_rows = np.arange(S, S + k, dtype=np.int32)
    kw = dict(demand_rows=(new_rows, dem), eligible_rows=(new_rows, elig),
              n_real=S + k)
    valid = pt.node_valid.copy()
    held = np.bincount(mirror[:pt.S], minlength=60).astype(float)
    held[held == 0] = np.inf
    valid[held.argmin()] = False            # the least loaded busy node
    cur = dataclasses.replace(grown, node_valid=valid.copy())
    rp.apply_delta(cur, ProblemDelta(node_valid=valid.copy(), **kw))
    assert rp.prob.n_real == cur.S and rp.prob.T == 6
    assert bool((rp.prob.conflict_ids[pt.S:cur.S] == -1).all())
    plan = rp.take_active_plan()
    assert plan is not None and (plan.rows[:plan.n_sub] >= pt.S).sum() == 5
    before = rp.h2d_copies
    staged = subsolve.stage_subsolve(rp, plan)
    assert rp.h2d_copies == before + 1
    out = _assert_stage_equal(rp.prob, rp.assignment, staged, plan)
    assert int(out.topo0.sum()) == cur.S - plan.n_sub


@pytest.mark.parametrize("tier", [256, 4096])
def test_k5_commit_matches_plain(dev, headline, tier):
    pt, probs = headline
    S_pad = probs["packed"].S
    rows, _ = _plan_rows(pt.S, S_pad, tier, tier + 1)
    rows_t = torch.tensor(rows, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tier)
    best = torch.randint(0, 1000, (2, tier), dtype=torch.int32, device=dev,
                         generator=gen)
    a = torch.randint(0, 1000, (S_pad,), dtype=torch.int32, device=dev,
                      generator=gen)
    keep = a.clone()
    viol = torch.tensor([3.0, 1.0], device=dev)
    soft = torch.tensor([-5.0, 2.0], device=dev)
    out, b = subsolve.k5_commit(best, viol, soft, rows_t, a)
    ref, rb = subsolve.k5_commit_plain(best, viol, soft, rows_t, a)
    assert torch.equal(out, ref) and torch.equal(b, rb) and int(b[0]) == 1
    assert torch.equal(a, keep)               # the input is never written


@pytest.mark.parametrize("viol,soft,best", [
    ([0.0, 0.0], [1.5, 1.5], 0),      # full tie: the first chain
    ([2.0, 2.0], [0.5, -0.5], 1),     # tied violations: the least soft
    ([1.0, 0.0, 0.0], [-9.0, 3.0, 2.0], 2),
])
def test_k5_commit_ties(dev, viol, soft, best):
    rows = torch.tensor([0, 3, 7, 10], dtype=torch.int32, device=dev)
    C = len(viol)
    best_assign = (torch.arange(C, device=dev, dtype=torch.int32)[:, None]
                   * 10 + torch.arange(4, device=dev,
                                       dtype=torch.int32)[None])
    a = torch.full((10,), -1, dtype=torch.int32, device=dev)
    v = torch.tensor(viol, device=dev)
    s = torch.tensor(soft, device=dev)
    out, b = subsolve.k5_commit(best_assign, v, s, rows, a)
    ref, rb = subsolve.k5_commit_plain(best_assign, v, s, rows, a)
    assert int(b[0]) == int(rb[0]) == best
    assert torch.equal(out, ref)
    assert out[[0, 3, 7]].tolist() == [best * 10, best * 10 + 1,
                                       best * 10 + 2]   # row 10 dropped


def test_k5_wrappers_raise_on_bad_input(dev, headline):
    pt, probs = headline
    prob = probs["packed"]
    a = torch.zeros(prob.S, dtype=torch.int32, device=dev)
    plan = _headline_plan(pt, prob, 256, 1)
    with pytest.raises(ValueError):
        subsolve.k5_stage(prob, a, torch.tensor(plan.packed(), device=dev,
                                                dtype=torch.int64), plan)
    with pytest.raises(ValueError):      # the buffer of another plan
        subsolve.k5_stage(prob, a, torch.zeros(16, dtype=torch.int32,
                                               device=dev), plan)
    with pytest.raises(ValueError):
        subsolve.k5_commit(torch.zeros((2, 16), dtype=torch.int64,
                                       device=dev),
                           torch.zeros(2, device=dev),
                           torch.zeros(2, device=dev),
                           torch.zeros(16, dtype=torch.int32, device=dev), a)


# -- the lane axis of K1-K3 (the tenant multiplexer) ------------------------

def _lanes(dev, L, S=500, N=64, seed=0):
    """A lane-stacked problem of L lanes of one tier: one fleet with each
    lane's own node losses, demand scale, phantom count (n_real) and
    stickiness bonus, and each lane's solo problem."""
    from fleetflow_tpu_torch.solver.multiplex import stack_problems
    _pt, base = _problem(dev, S=S, N=N, seed=seed, skew=2)
    rng = np.random.default_rng(seed)
    solo = []
    for i in range(L):
        valid = base.node_valid.clone()
        valid[torch.tensor(rng.choice(N, 1 + i % 4, replace=False),
                           device=dev)] = False
        solo.append(dataclasses.replace(
            base, node_valid=valid, demand=base.demand * (1.0 + 0.05 * i),
            n_real=S - 7 * i,
            sticky_prev=torch.tensor(rng.integers(0, N, S), dtype=torch.int32,
                                     device=dev),
            sticky_w=0.25 + 0.125 * i))
    return stack_problems(solo), solo


def _lane_assignments(dev, prob, C, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, prob.N, (prob.lanes, C, prob.S)),
                        dtype=torch.int32, device=dev)


@pytest.mark.parametrize("L", [3, 16])
def test_lane_k3_matches_plain(dev, L):
    prob, _solo = _lanes(dev, L)
    a = _lane_assignments(dev, prob, 2, 5)
    a[0, 1, : prob.S // 3] = 0
    before = _ext.LAUNCHES["k3_rebuild"]
    out = kernels.k3_rebuild(prob, a, with_stats=True)
    ref = kernels.k3_rebuild_plain(prob, a, with_stats=True)
    assert _ext.LAUNCHES["k3_rebuild"] == before + 1
    assert out[0].shape == (L, 2, prob.N, 3) and out[4].shape == (L, 2, 5)
    for x, y in zip(out[1:], ref[1:]):
        assert torch.equal(x, y)
    assert torch.allclose(out[0], ref[0], rtol=LOAD_RTOL, atol=0)


@pytest.mark.parametrize("L", [1, 3, 8])
def test_lane_k3_base_phantoms_out_of_range(dev, L):
    """Lanes with a frozen base (the sub-solve's), phantom rows (each
    lane's own n_real) and out-of-range assignments (dropped from every
    plane, off every node in the stats): equal to the plain version, and
    the load bit-equal to the plain version on the CPU."""
    prob, _solo = _lanes(dev, L)
    rng = np.random.default_rng(11)
    a = _lane_assignments(dev, prob, 2, 12)
    a[:, 0, :7] = prob.N
    a[:, 1, 3:9] = prob.N + 5
    base = (torch.rand((prob.N, 3), device=dev) * 3,
            torch.randint(0, 3, (prob.N, prob.G), device=dev,
                          dtype=torch.int32),
            torch.randint(0, 2, (prob.N, max(prob.Gc, 1)), device=dev,
                          dtype=torch.int32),
            torch.tensor(rng.integers(0, 4, prob.T), dtype=torch.int32,
                         device=dev))
    out = kernels.k3_rebuild(prob, a, base, with_stats=True)
    ref = kernels.k3_rebuild_plain(prob, a, base, with_stats=True)
    for x, y in zip(out[1:], ref[1:]):
        assert torch.equal(x, y)
    assert torch.allclose(out[0], ref[0], rtol=LOAD_RTOL, atol=0)
    cpu = kernels.k3_rebuild_plain(_on_cpu(prob), a.cpu(),
                                   tuple(t.cpu() for t in base),
                                   with_stats=True)
    assert torch.equal(out[0].cpu(), cpu[0])
    assert float(out[4][..., 2].min()) >= 12   # the out-of-range services


@pytest.mark.parametrize("L", [3, 16])
def test_lane_k2_matches_plain(dev, L):
    prob, _solo = _lanes(dev, L)
    a = _lane_assignments(dev, prob, 1, 6)[:, 0]
    st = anneal.chain_states_from_assignment(prob, a)
    st_k, st_p = st.clone(), st.clone()
    _, mv_k = anneal.prerepair_state_counted(prob, st_k, 256)
    _, mv_p = anneal.prerepair_plain(prob, st_p, 256)
    assert mv_k.shape == (L,) and torch.equal(mv_k, mv_p)
    assert int(mv_k.min()) > 0
    _equal_states(st_k, st_p)
    assert torch.equal(st_k.load, st_p.load)


@pytest.mark.parametrize("L", [3, 16])
def test_lane_k1_matches_plain(dev, L):
    """Lanes of different n_real, stickiness and temperature; lane 1 is
    inactive and must stay untouched."""
    prob, solo = _lanes(dev, L)
    st = anneal.chain_states_from_assignment(
        prob, _lane_assignments(dev, prob, 2, 7))
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    active = [i != 1 for i in range(L)]
    temps = [1.0 / (1 + i) for i in range(L)]
    st_k, st_p = st.clone(), st.clone()
    applied = 0
    for _ in range(4):
        draws = [anneal.draw_proposals(solo[i], st_k.lane(i), gen, 96)
                 for i in range(L)]
        s_idx, b_idx, u = (torch.stack([d[k] for d in draws])
                           for k in range(3))
        _, acc_k = anneal.batched_step_apply(prob, st_k, s_idx, b_idx, u,
                                             temps, active)
        _, acc_p = anneal.batched_step_plain(prob, st_p, s_idx, b_idx, u,
                                             temps, active)
        assert acc_k.shape == (L, 2) and torch.equal(acc_k, acc_p)
        assert int(acc_k[1].abs().sum()) == 0
        applied += int(acc_k.sum())
    _equal_states(st_k, st_p, scale_atol=True)
    assert applied > 0
    for name in ("assignment", "load", "used", "coloc", "topo"):
        assert torch.equal(getattr(st_k, name)[1], getattr(st, name)[1])


def test_one_lane_equals_the_solo_kernels(dev):
    """L = 1 through the lane entry points equals the solo call."""
    _pt, prob = _problem(dev, skew=2, n_real=570)
    prob = dataclasses.replace(
        prob, sticky_prev=torch.zeros(prob.S, dtype=torch.int32, device=dev),
        sticky_w=0.5)
    one = prob.as_lanes()
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.integers(0, prob.N, (2, prob.S)), dtype=torch.int32,
                     device=dev)
    solo = kernels.k3_rebuild(prob, a, with_stats=True)
    lane = kernels.k3_rebuild(one, a[None], with_stats=True)
    for x, y in zip(solo, lane):
        assert torch.equal(x, y[0])
    st = anneal.chain_states_from_assignment(prob, a)
    st1 = st.clone()
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    s_idx, b_idx, u = anneal.draw_proposals(prob, st, gen, 96)
    _, acc = anneal.batched_step_apply(prob, st, s_idx, b_idx, u, 0.5)
    _, acc1 = anneal.batched_step_apply(one, st1.as_lanes(), s_idx[None],
                                        b_idx[None], u[None], [0.5])
    assert torch.equal(acc, acc1[0])
    for x, y in zip(st, st1):
        assert torch.equal(x, y)
    valid = prob.node_valid.clone()
    valid[:5] = False
    dead = dataclasses.replace(prob, node_valid=valid)
    st2 = anneal.chain_states_from_assignment(dead, a[0])
    st3 = st2.clone()
    _, mv = anneal.prerepair_state_counted(dead, st2, 64)
    _, mv1 = anneal.prerepair_state_counted(dead.as_lanes(), st3.as_lanes(),
                                            64)
    assert torch.equal(mv, mv1) and int(mv[0]) > 0
    for x, y in zip(st2, st3):
        assert torch.equal(x, y)


def test_place_many_on_the_card(dev, monkeypatch):
    """One batch of three same-tier stages through place_many equals the
    solo warm reschedules of a control scheduler."""
    from fleetflow_tpu_torch.obs.metrics import REGISTRY
    from fleetflow_tpu_torch.sched import GpuSolverScheduler
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = {k: synthetic_problem(300, 30, seed=i, port_fraction=0.3,
                                volume_fraction=0.2)
           for i, k in enumerate("ABC")}
    solo_sched = GpuSolverScheduler(steps=32, device=dev)
    many = GpuSolverScheduler(steps=32, device=dev)
    for k in "ABC":
        solo_sched.place(pts[k], stage=k)
        many.place(pts[k], stage=k)
    solo = {k: solo_sched.reschedule(pts[k], stage=k) for k in "ABC"}
    lanes = REGISTRY.get("fleet_solver_mux_lanes_total")
    stages = lanes.value(kind="stage")
    batch = many.place_many([{"pt": pts[k], "warm_start": True, "stage": k}
                             for k in "ABC"])
    assert lanes.value(kind="stage") == stages + 3
    for k, res in zip("ABC", batch):
        assert np.array_equal(solo[k].raw, res.raw), k
        assert res.feasible == solo[k].feasible


def _scan_order(pt, prob, dev):
    order = greedy.placement_order(pt.demand, pt.dep_depth,
                                   unify_conflict_ids(pt))
    if prob.S > pt.S:
        order = np.concatenate([order, np.arange(pt.S, prob.S,
                                                 dtype=np.int32)])
    return torch.tensor(order, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_k6_matches_plain(dev, strategy):
    pt, prob = _problem(dev, S=2000, N=200, strategy=strategy,
                        packed=strategy != "pack_into_dedicated",
                        preferred=strategy == "fill_lowest")
    order = _scan_order(pt, prob, dev)
    out = greedy.greedy_place(prob, order)
    assert out.dtype == torch.int32
    assert torch.equal(out, greedy.greedy_place_plain(prob, order))


@pytest.mark.parametrize("case", ["overfull", "no_eligible_node", "padded"])
def test_k6_best_effort_matches_plain(dev, case):
    """Services that fit nowhere (the best-effort argmax), services with no
    eligible valid node (the - 1e15 mask), phantom rows parked last."""
    pt = synthetic_problem(2000, 200, seed=7, n_tenants=1)
    if case == "overfull":
        pt = dataclasses.replace(
            pt, capacity=(pt.capacity * np.float32(0.45)).astype(np.float32))
    elif case == "no_eligible_node":
        elig, valid = pt.eligible.copy(), pt.node_valid.copy()
        elig[::7] = False
        elig[::7, :6] = True
        valid[:6] = False
        pt = dataclasses.replace(pt, eligible=elig, node_valid=valid)
    if case == "padded":
        prob, _ = stage_problem_tiers(pt, device=dev)
        assert prob.S > pt.S
    else:
        prob = prepare_problem(pt, dev)
    order = _scan_order(pt, prob, dev)
    _ext.reset_launches()
    out = greedy.greedy_place(prob, order)
    assert _ext.LAUNCHES["k6_greedy_scan"] == 1
    assert torch.equal(out, greedy.greedy_place_plain(prob, order))


# strict mode's shapes: one node a thread (N <= 1,024) in each strategy,
# and more nodes than a block has threads, with a preference plane
K6_STRICT = [(2000, 200, s, False) for s in STRATEGIES] + [
    (512, 3000, "spread_across_pool", True)]


@pytest.mark.parametrize("S,N,strategy,preferred", K6_STRICT,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}" for c in K6_STRICT])
def test_k6_strict_matches_plain(dev, S, N, strategy, preferred):
    """best_effort=False at 45% of the capacity: a service with no feasible
    node goes to node 0 (no best-effort pass), in one launch, equal to the
    plain version; the best-effort launch still places otherwise."""
    pt, _ = _problem(dev, S=S, N=N, strategy=strategy, preferred=preferred)
    pt = dataclasses.replace(
        pt, capacity=(pt.capacity * np.float32(0.45)).astype(np.float32))
    prob = prepare_problem(pt, dev)
    order = _scan_order(pt, prob, dev)
    _ext.reset_launches()
    out = greedy.greedy_place(prob, order, best_effort=False)
    assert _ext.LAUNCHES["k6_greedy_scan"] == 1
    assert torch.equal(out, greedy.greedy_place_plain(prob, order,
                                                      best_effort=False))
    be = greedy.greedy_place(prob, order)
    assert int((out == 0).sum()) > int((be == 0).sum())


def test_k6_raises_on_bad_input(dev):
    _, prob = _problem(dev)
    with pytest.raises(ValueError):
        greedy.greedy_place(prob, torch.arange(prob.S, device=dev))
    with pytest.raises(ValueError):
        greedy.greedy_place(prob, torch.zeros(prob.S + 1, dtype=torch.int32,
                                              device=dev))


@pytest.mark.parametrize("impl", ["native", "partitioned", "scan"])
def test_seed_impls_solve_on_the_card(dev, impl):
    from fleetflow_tpu_torch.solver import solve
    from fleetflow_tpu_torch.solver.repair import verify
    pt = synthetic_problem(2000, 200, seed=3, n_tenants=3)
    _ext.host_library("ffplacer")
    _ext.reset_launches()
    res = solve(pt, seed_impl=impl, seed=3)
    assert res.device.startswith("cuda") and res.violations == 0
    assert verify(pt, res.assignment)["total"] == 0
    assert (_ext.LAUNCHES["k6_greedy_scan"] > 0) == (impl == "scan")
    assert _ext.LAUNCHES["k4_greedy"] == 0


def _sharded_state(dev, prob, R, seed):
    rng = np.random.default_rng(seed)
    init = torch.tensor(rng.integers(0, prob.N, (R, prob.S)),
                        dtype=torch.int32, device=dev)
    return anneal.chain_states_from_assignment(prob, init)


@pytest.mark.parametrize("layout", ["1x8", "2x4"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_k7_matches_plain(dev, layout, strategy):
    """K7 against sharded_step_plain at 2000 x 200 on one-card meshes,
    from random replica states, hot and cold: equal assignments, integer
    planes and applied counts; loads within LOAD_RTOL (the plain version's
    index_add_ groups the contributions to one row on the card)."""
    from fleetflow_tpu_torch.solver import sharded
    R, D = (1, 8) if layout == "1x8" else (2, 4)
    pt, prob = _problem(dev, S=2000, N=200, strategy=strategy,
                        packed=strategy != "fill_lowest",
                        preferred=strategy == "pack_into_dedicated",
                        skew=3 if strategy == "fill_lowest" else 0,
                        n_real=1990)
    st = _sharded_state(dev, prob, R, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    draws = sharded.TorchDraws(gen)
    M = max(8, min(256, (prob.S // D) // 2))
    scratch = sharded._scratch(R, D, M, prob.N, dev)
    for temps in ([1.0] * R, [0.01 * (1.3 ** r) for r in range(R)]):
        st_k, st_p = st.clone(), st.clone()
        applied = 0
        for i in range(4):
            hot = sharded._hot(prob, st_k, D)
            s_loc, b_idx, u = draws.proposals(i, hot, prob.N, M)
            before = _ext.LAUNCHES["k7_sharded_sweep"]
            _, acc_k = sharded.sharded_step_apply(prob, st_k, s_loc, b_idx,
                                                  u, temps, scratch)
            assert _ext.LAUNCHES["k7_sharded_sweep"] == before + 1
            _, acc_p = sharded.sharded_step_plain(prob, st_p, s_loc, b_idx,
                                                  u, temps)
            assert torch.equal(acc_k, acc_p)
            applied += int(acc_k.sum())
        _equal_states(st_k, st_p)
        assert applied > 0
    # the scratch is back at its resting values after every sweep
    assert bool((scratch.ints[-R * prob.N:] == 2**31 - 1).all())
    assert bool((scratch.partial == 0).all())


def test_k7_raises_on_bad_input(dev):
    from fleetflow_tpu_torch.solver import sharded
    _pt, prob = _problem(dev, S=600, N=80)
    st = _sharded_state(dev, prob, 1, 0)
    s = torch.zeros((1, 8, 16), dtype=torch.int32, device=dev)
    u = torch.zeros((1, 8, 16), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):          # one temperature per replica
        sharded.sharded_step_apply(prob, st, s, s, u, [1.0, 1.0])
    with pytest.raises(ValueError):          # S = 600 over 7 shards
        sharded.sharded_step_apply(prob, st, s[:, :7], s[:, :7], u[:, :7],
                                   [1.0])


@pytest.mark.parametrize("layout", ["1x8", "2x4"])
def test_solve_sharded_on_the_card(dev, layout):
    """A cold and a warm solve_sharded over a one-card mesh: feasible,
    nothing on the dead node, K7 and K3 launched, K1 not, and no upload
    inside the warm dispatch."""
    from fleetflow_tpu_torch.solver.repair import verify
    from fleetflow_tpu_torch.solver.resident import ProblemDelta
    from fleetflow_tpu_torch.solver.sharded import (ShardedResident,
                                                    solve_sharded,
                                                    tempering_mesh)
    R, D = (1, 8) if layout == "1x8" else (2, 4)
    pt = synthetic_problem(997, 100, seed=0, n_tenants=8,
                           port_fraction=0.2, volume_fraction=0.1)
    rp = ShardedResident(pt, mesh=tempering_mesh(R, D, devices=[dev] * 8))
    _ext.reset_launches()
    cold = solve_sharded(pt, resident=rp, steps=64, block=4)
    assert cold.feasible and verify(pt, cold.assignment)["total"] == 0
    valid = pt.node_valid.copy()
    valid[int(np.bincount(cold.assignment, minlength=pt.N).argmax())] = False
    pt2 = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(pt2, ProblemDelta(node_valid=valid))
    warm = solve_sharded(pt2, resident=rp, resident_warm=True, steps=64,
                         block=4)
    assert warm.feasible and valid[warm.assignment].all()
    assert warm.warm_h2d_copies == 0 and warm.tempering["replicas"] == R
    assert _ext.LAUNCHES["k7_sharded_sweep"] > 0
    assert _ext.LAUNCHES["k3_rebuild"] > 0
    assert _ext.LAUNCHES["k1_sweep"] == 0


def _conflict_heavy(dev, S, N, G, strategy="fill_lowest", tie_pref=False,
                    seed=11):
    """A problem whose conflict ids run to G (each service holds port id
    s % G, so pairs of services share one): the occupancy bitmap of K6 is
    G·N bits. With `tie_pref`, even services prefer node n by 2n, which
    cancels fill_lowest's -n: every node ties and the lowest ok node
    wins."""
    pt = synthetic_problem(S, N, seed=seed, n_tenants=3,
                           strategy=PlacementStrategy(strategy))
    ports = (np.arange(S) % G).astype(np.int32)[:, None]
    kw = dict(port_ids=ports)
    if tie_pref:
        rng = np.random.default_rng(seed)
        pref = rng.random((S, N)).astype(np.float32)
        pref[::2] = 2.0 * np.arange(N, dtype=np.float32)[None, :]
        kw["preferred"] = pref
    pt = dataclasses.replace(pt, **kw)
    return pt, prepare_problem(pt, dev)


def _k6_against_plain(dev, pt, prob):
    order = _scan_order(pt, prob, dev)
    _ext.reset_launches()
    out = greedy.greedy_place(prob, order)
    assert _ext.LAUNCHES["k6_greedy_scan"] == 1
    assert torch.equal(out, greedy.greedy_place_plain(prob, order))
    return out


@pytest.mark.parametrize("strategy", ["spread_across_pool", "fill_lowest"])
def test_k6_more_nodes_than_threads(dev, strategy):
    """512 services over 3,000 nodes with a preference plane: each of the
    block's 1,024 threads owns three nodes (their load in global memory),
    equal to the plain version."""
    _pt, prob = _problem(dev, S=512, N=3000, seed=12, strategy=strategy,
                         preferred=True)
    _k6_against_plain(dev, _pt, prob)


@pytest.mark.parametrize("S,N,G", [(3000, 1000, 2500), (1600, 1500, 1300)])
def test_k6_bitmap_off_chip_with_ties(dev, S, N, G):
    """G·N bits past shared memory (the bitmap in global memory), one and
    several nodes a thread, fill_lowest with every node tied for the even
    services: equal to the plain version (the lowest ok node wins)."""
    pt, prob = _conflict_heavy(dev, S, N, G, tie_pref=True)
    assert prob.G >= G and ((prob.G + 31) // 32) * N * 4 > 227 * 1024
    _k6_against_plain(dev, pt, prob)


@pytest.mark.parametrize("K", [40, 160])
def test_k6_many_ids_a_service(dev, K):
    """Rows of more than 29 conflict ids (several elements a lane of the
    staging warp) and of more than 125 (the rest staged synchronously):
    equal to the plain version."""
    pt = synthetic_problem(300, 100, seed=17, n_tenants=2)
    rng = np.random.default_rng(17)
    ports = rng.integers(-1, 20 * K, (300, K)).astype(np.int32)
    pt = dataclasses.replace(pt, port_ids=ports)
    prob = prepare_problem(pt, dev)
    assert prob.conflict_ids.shape[1] > 29 + 96 * (K > 100)
    _k6_against_plain(dev, pt, prob)


@pytest.mark.parametrize("N", [300, 1500])
def test_k6_best_effort_every_node_full(dev, N):
    """Capacity at 0.1%: no node is ok from the first service on, so every
    step takes the best-effort argmax (overflow and exact conflict counts
    on every node), one and several nodes a thread."""
    pt = synthetic_problem(600, N, seed=13, n_tenants=3,
                           port_fraction=0.3, volume_fraction=0.2)
    pt = dataclasses.replace(pt, capacity=(
        pt.capacity * np.float32(1e-3)).astype(np.float32))
    prob = prepare_problem(pt, dev)
    out = _k6_against_plain(dev, pt, prob)
    assert len(set(out.tolist())) > 1


def _rank_entry_sweeps(dev, prob, R, D, M, temps):
    """K7's cross-rank entry points (elect, apply, reduce) for every
    position of an R x D mesh on the card, the collectives between them
    done by hand (MIN of the slots over a replica's shards, the records
    stacked in shard order: the gather), against their plain versions on
    CPU copies, one sweep a temperature of `temps` from hot random
    replica states: each entry point's outputs equal (the slots and the
    proposals' standing, the records entry for entry and the applied
    counts, the reduced planes, loads bit-equal, the slots and reduce's
    accumulator back at rest),
    one launch each a call. Returns the applied moves."""
    from fleetflow_tpu_torch.solver import sharded, sharded_ranks as sr
    whole = _sharded_state(dev, prob, R, 4)
    S_loc = prob.S // D
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    draws = sharded.TorchDraws(gen)
    both = {}
    for r in range(R):
        for d in range(D):
            pos = sr.RankPosition(r, d, R, D, prob.S, d * S_loc)
            lp = sr.shard_rows(prob, pos)
            st = anneal.ChainState(
                whole.assignment[r:r + 1, d * S_loc:(d + 1) * S_loc]
                .clone(), *(t[r:r + 1].clone() for t in whole[1:]))
            st_c = anneal.ChainState(*(t.cpu() for t in st))
            both[r, d] = (pos, (lp, st, sr.rank_scratch(lp, st, M)),
                          (_on_cpu(lp), st_c, sr.rank_scratch(lp, st_c, M)))
    applied = 0
    for i, temp in enumerate(temps):
        s_all, b_all, u_all = draws.proposals(
            i, sharded._hot(prob, whole, D), prob.N, M)
        for (r, d), (pos, k, c) in both.items():
            n0 = _ext.LAUNCHES["k7_rank_elect"]
            sr.sharded_elect(*k, pos, s_all[r, d].contiguous(),
                             b_all[r, d].contiguous(),
                             u_all[r, d].contiguous(), temp)
            assert _ext.LAUNCHES["k7_rank_elect"] == n0 + 1
            sr.sharded_elect_plain(*c, pos, s_all[r, d].cpu(),
                                   b_all[r, d].cpu(), u_all[r, d].cpu(), temp)
            assert torch.equal(k[2].slots.cpu(), c[2].slots)
            assert torch.equal(k[2].cand.cpu(), c[2].cand)
            assert bool((k[2].first == 2**31 - 1).all())
        for r in range(R):
            for side in (1, 2):
                slots = torch.stack([both[r, d][side][2].slots
                                     for d in range(D)]).min(0).values
                for d in range(D):
                    both[r, d][side][2].slots.copy_(slots)
        for (r, d), (pos, k, c) in both.items():
            n0 = _ext.LAUNCHES["k7_rank_apply"]
            sr.sharded_apply(*k, pos)
            assert _ext.LAUNCHES["k7_rank_apply"] == n0 + 1
            sr.sharded_apply_plain(*c, pos)
            for name in ("records", "applied"):
                assert torch.equal(getattr(k[2], name).cpu(),
                                   getattr(c[2], name)), name
            assert torch.equal(k[1].assignment.cpu(), c[1].assignment)
            applied += int(c[2].applied[0])
        for r in range(R):
            for side in (1, 2):
                gathered = torch.stack([both[r, d][side][2].records
                                        for d in range(D)])
                for d in range(D):
                    pos, lp_st_sc = both[r, d][0], both[r, d][side]
                    n0 = _ext.LAUNCHES["k7_rank_reduce"]
                    reduce = (sr.sharded_reduce if side == 1
                              else sr.sharded_reduce_plain)
                    reduce(*lp_st_sc, pos, gathered)
                    assert _ext.LAUNCHES["k7_rank_reduce"] == \
                        n0 + (side == 1)
        for (r, d), (pos, k, c) in both.items():
            for x, y in zip(k[1], c[1]):
                assert torch.equal(x.cpu(), y)
            assert bool((k[2].slots == 2**31 - 1).all())
            assert bool((c[2].slots == 2**31 - 1).all())
            assert torch.equal(k[2].acc.cpu(), c[2].acc)  # at rest
        # the next sweep's hot mask reads the replicas' state
        for r in range(R):
            whole.assignment[r] = torch.cat([both[r, d][1][1].assignment[0]
                                             for d in range(D)])
            for t, u_ in zip(whole[1:], both[r, 0][1][1][1:]):
                t[r] = u_[0]
    return applied


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_k7_rank_entry_points_match_plain(dev, layout, strategy):
    """K7's cross-rank entry points for every position of 1 x 8 and 2 x 4
    meshes against their plain versions (_rank_entry_sweeps), three
    sweeps at T = 1 and 0.01, each strategy, packed and dense, a
    preference plane, a spread constraint."""
    R, D = layout
    _pt, prob = _problem(dev, S=2000, N=200, strategy=strategy,
                         packed=strategy != "fill_lowest",
                         preferred=strategy == "pack_into_dedicated",
                         skew=3 if strategy == "fill_lowest" else 0,
                         n_real=1990)
    M = max(8, min(256, (prob.S // D) // 2))
    assert _rank_entry_sweeps(dev, prob, R, D, M, (1.0, 0.01, 0.01)) > 0


def _rank_widest(dev, prob):
    """The widest M ff_k7r_bind takes on position (0, 0) of a 1 x 2 mesh
    over `prob` (chip_smoke.rank_widest's bisection)."""
    import chip_smoke
    from fleetflow_tpu_torch.solver import sharded_ranks as sr
    pos = sr.RankPosition(0, 0, 1, 2, prob.S, 0)
    lp = sr.shard_rows(prob, pos)
    st = anneal.chain_states_from_assignment(
        lp, _sharded_state(dev, prob, 1, 3).assignment[:, :lp.S].clone())
    return chip_smoke.rank_widest(sr, lp, st, pos), (lp, st, pos)


@pytest.mark.parametrize("M", [128, 256, 2048, "widest"])
def test_k7_rank_entry_points_widths(dev, M):
    """The entry points at solve_sharded's proposals_per_step=128, the
    default 256, the first design's widest 2,048 and the widest M
    ff_k7r_bind takes (10,096 on an H100: clusters of 8 CTAs, several
    proposals a thread), 2 x 2 positions with a spread constraint (teams of
    8 lanes), against their plain versions."""
    _pt, prob = _problem(dev, S=2000, N=200, skew=3, n_real=1990)
    if M == "widest":
        M = _rank_widest(dev, prob)[0]
        assert M >= 2048
    assert _rank_entry_sweeps(dev, prob, 2, 2, M, (1.0, 0.01)) > 0


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
def test_k7_rank_records_at_the_widest(dev, layout):
    """At the widest M ff_k7r_bind takes, hot (T = 50, then 1), so that
    most of a replica's 200 nodes are won in a sweep: every position of
    1 x 8 and 2 x 4 meshes, the records entry for entry, the planes and
    loads after reduce bit-equal to the plain versions."""
    R, D = layout
    _pt, prob = _problem(dev, S=2000, N=200, skew=3, n_real=1990)
    M = _rank_widest(dev, prob)[0]
    assert _rank_entry_sweeps(dev, prob, R, D, M, (50.0, 1.0)) > 0


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
@pytest.mark.parametrize("case", ["one_service", "one_target",
                                  "all_rejected", "full_width"])
def test_k7_rank_entry_points_adversarial(dev, layout, case):
    """chip_smoke's adversarial draws for the election's tables and the
    apply's list (chip_smoke.rank_adversarial_draws: every proposal for
    one service; every proposal onto one node; every proposal rejected;
    M equal to the shard's rows, the phantom rows among them), two sweeps
    at T = 50 and 1 of every position, each entry point equal to its
    plain version on the CPU; nothing applied when all are rejected."""
    import chip_smoke
    from fleetflow_tpu_torch.solver import sharded_ranks as sr
    R, D = layout
    _pt, prob = _problem(dev, S=2000, N=200, skew=3, n_real=1990)
    S_loc = prob.S // D
    M = S_loc if case == "full_width" else max(8, min(256, S_loc // 2))
    whole = _sharded_state(dev, prob, R, 6)
    both = chip_smoke.rank_positions(torch, sr, anneal, prob, 1990, whole,
                                     R, D, M, dev)

    def same(name, x, y):
        assert torch.equal(x.cpu(), y), name

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    applied = 0
    for temp in (chip_smoke.RANK_HOT_TEMP, 1.0):
        now = torch.stack([torch.cat([both[r, d][1][1].assignment[0]
                                      for d in range(D)])
                           for r in range(R)])
        draws = chip_smoke.rank_adversarial_draws(torch, case, now, D,
                                                  prob.N, M, gen)
        applied += chip_smoke.rank_sweep_vs_plain(
            torch, sr, both, R, D, draws, [temp] * R, same)["applied"]
    assert (applied == 0) == (case == "all_rejected")


def test_k7_rank_bind_refuses_a_width_past_the_cluster(dev):
    """A width whose apply cluster does not fit the card's shared memory
    (past the widest the bind takes) raises at bind time, from the
    launcher and from each entry point; nothing launches and nothing runs
    the plain version in its place (the scratch stays at rest)."""
    from fleetflow_tpu_torch.core.errors import KernelError
    from fleetflow_tpu_torch.solver import sharded_ranks as sr
    _pt, prob = _problem(dev, S=2000, N=200, n_real=1990)
    widest, (lp, st, pos) = _rank_widest(dev, prob)
    sr.rank_sweep(lp, st, pos, widest)
    before = dict(_ext.LAUNCHES)
    for M in (widest + 1, 4 * widest):
        with pytest.raises(KernelError):
            sr.rank_sweep(lp, st, pos, M)
        sc = sr.rank_scratch(lp, st, M)
        s = torch.zeros(M, dtype=torch.int32, device=dev)
        with pytest.raises(KernelError):
            sr.sharded_elect(lp, st, sc, pos, s, s, s.float(), 1.0)
        with pytest.raises(KernelError):
            sr.sharded_apply(lp, st, sc, pos)
        assert bool((sc.slots == 2**31 - 1).all())
        assert int(sc.cand.abs().sum()) == 0
    assert _ext.LAUNCHES == before


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
def test_k7_rank_many_nodes(dev, layout):
    """A fleet of 16,000 nodes on 8 and on 4 shards (D·N far past what a
    map of the entries in shared memory could hold): the bind takes it,
    and two hot sweeps of every position equal their plain versions,
    reduce's accumulator back at rest."""
    R, D = layout
    _pt, prob = _problem(dev, S=2048, N=16000, n_real=2040)
    assert _rank_entry_sweeps(dev, prob, R, D, 128, (50.0, 1.0)) > 0


def _k7_against_cpu(prob, st_k, s_loc, b_idx, u, temps, sweep=None):
    """One K7 sweep on the card (through `sweep`, a bound launcher, or the
    one-shot wrapper) and the plain version on the CPU copies: applied
    counts, assignment and integer planes equal, loads bit-equal (the
    CPU's index_add_ adds each position's moves in proposal order, the
    kernel's order, and both sum the shards in shard order)."""
    from fleetflow_tpu_torch.solver import sharded
    st_c = anneal.ChainState(*(t.to("cpu", copy=True) for t in st_k))
    if sweep is None:
        _, acc_k = sharded.sharded_step_apply(prob, st_k, s_loc, b_idx, u,
                                              temps)
    else:
        acc_k = sweep(s_loc, b_idx, u, temps)
    _, acc_c = sharded.sharded_step_plain(_on_cpu(prob), st_c, s_loc.cpu(),
                                          b_idx.cpu(), u.cpu(), temps)
    assert torch.equal(acc_k.cpu(), acc_c)
    for x, y in zip(st_k, st_c):
        assert torch.equal(x.cpu(), y)
    return int(acc_k.sum())


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
def test_k7_departures_keep_their_order(dev, layout):
    """T = 1, every service on one of three nodes, each position moving
    distinct services of its shard to targets distinct across the replica
    (u = 0: most moves accepted, each applied): many winners leave each
    crowded node from every shard, each position's departures in proposal
    order and the shards' partials in shard order, bit-equal to the plain
    version on the CPU. (u = 0 still rejects a move whose delta makes
    exp(-Δ/T) underflow: an ineligible or conflicted target.)"""
    R, D = layout
    _pt, prob = _problem(dev, S=640, N=200, seed=14)
    rng = np.random.default_rng(14)
    a = torch.tensor(rng.integers(0, 3, (R, prob.S)), dtype=torch.int32,
                     device=dev)
    st = anneal.chain_states_from_assignment(prob, a)
    M = 24
    s_loc = torch.tensor(np.stack([[rng.permutation(prob.S // D)[:M]
                                    for _ in range(D)] for _ in range(R)]),
                         dtype=torch.int32, device=dev)
    b_idx = torch.tensor(np.stack([3 + rng.permutation(prob.N - 3)[:D * M]
                                   for _ in range(R)]).reshape(R, D, M),
                         dtype=torch.int32, device=dev)
    u = torch.zeros((R, D, M), dtype=torch.float32, device=dev)
    applied = _k7_against_cpu(prob, st, s_loc, b_idx, u, [1.0] * R)
    assert applied > R * D * M // 2
    left = torch.bincount(a[0].long(), minlength=prob.N)[:3] - torch.bincount(
        st.assignment[0].long(), minlength=prob.N)[:3]
    assert int(left.min()) >= 20


@pytest.mark.parametrize("R,D,M", [(2, 1, 45), (1, 8, 45), (3, 5, 33)])
def test_k7_duplicate_services_ragged_m(dev, R, D, M):
    """Each position draws its M proposals (M not a multiple of 32) from
    four services of its shard, so a service is drawn many times in one
    position (its candidate is its lowest accepted proposal), over D = 1,
    8 and 5 shards: bit-equal to the plain version on the CPU, hot and
    cold."""
    _pt, prob = _problem(dev, S=600, N=60, seed=15, skew=3)
    rng = np.random.default_rng(15)
    st = _sharded_state(dev, prob, R, 15)
    applied = 0
    for T in (1.0, 0.05):
        for _ in range(3):
            s_loc = torch.tensor(rng.integers(0, 4, (R, D, M)),
                                 dtype=torch.int32, device=dev)
            b_idx = torch.tensor(rng.integers(0, prob.N, (R, D, M)),
                                 dtype=torch.int32, device=dev)
            u = torch.tensor(rng.random((R, D, M)), dtype=torch.float32,
                             device=dev)
            applied += _k7_against_cpu(prob, st, s_loc, b_idx, u,
                                       [T * 1.3 ** r for r in range(R)])
    assert applied > 0


def test_k7_launcher_reused_then_rebuilt_after_a_merge(dev):
    """One bound launcher over 4 sweeps (one launch each), then, after a
    merge takes the busiest node down, a launcher built again over the
    merged staging for 4 more: every sweep bit-equal to the plain version
    on the CPU."""
    from fleetflow_tpu_torch.solver import sharded
    from fleetflow_tpu_torch.solver.resident import ProblemDelta
    pt = synthetic_problem(997, 100, seed=0, n_tenants=8,
                           port_fraction=0.2, volume_fraction=0.1)
    R, D = 2, 4
    rp = sharded.ShardedResident(pt, mesh=sharded.tempering_mesh(
        R, D, devices=[dev] * 8))
    res = sharded.solve_sharded(pt, resident=rp, steps=16, block=4)
    M = max(8, min(256, (rp.prob.S // D) // 2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    draws = sharded.TorchDraws(gen)

    def sweeps(first, temps):
        st = anneal.chain_states_from_assignment(
            rp.prob, rp.assignment.reshape(1, -1).expand(R, -1).contiguous())
        sweep = sharded.sweep_launcher(rp.prob, st, D, M)
        moved = 0
        for i in range(first, first + 4):
            s_loc, b_idx, u = draws.proposals(
                i, sharded._hot(rp.prob, st, D), rp.prob.N, M)
            moved += _k7_against_cpu(rp.prob, st, s_loc, b_idx, u, temps,
                                     sweep)
        return moved

    _ext.reset_launches()
    moved = sweeps(0, [1.0, 1.3])
    assert _ext.LAUNCHES["k7_sharded_sweep"] == 4
    valid = pt.node_valid.copy()
    valid[int(np.bincount(res.assignment, minlength=pt.N).argmax())] = False
    pt2 = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(pt2, ProblemDelta(node_valid=valid))
    moved += sweeps(4, [0.1, 0.13])
    assert _ext.LAUNCHES["k7_sharded_sweep"] == 8
    assert moved > 0


def test_launch_audit_on_the_card(dev):
    """The launch audit (analysis/auditor.audit_kernels) on the card at
    the audit tiers: no violation — no upload inside a warm dispatch's
    profiler range, the merges write their planes in place, the seeds
    are kept, nothing is built at a later tier — the report equal to the
    pinned golden, and every dispatch's host traffic measured."""
    import json

    from fleetflow_tpu_torch.analysis.auditor import (audit_kernels,
                                                      contract_diff,
                                                      default_contract_path)
    torch.use_deterministic_algorithms(False)
    report = audit_kernels(device=dev)
    assert report.violations == []
    with open(default_contract_path(), encoding="utf-8") as f:
        assert contract_diff(report, json.load(f)) == []
    for name, entry in report["kernels"].items():
        for tier, rec in entry["tiers"].items():
            t = rec["host_traffic"]
            assert t is not None and t["ranges"] == 1 and t["ops"] > 0, \
                (name, tier)
            if not name.endswith(".merge"):
                assert t["h2d"] == [], (name, tier)
