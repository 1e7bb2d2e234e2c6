"""Shape buckets, phantom rows and the resident merge of a bucketed staging
(fleetflow_tpu_torch/solver/buckets.py, resident.py, K5's plain gather)
against the JAX package on the CPU.

Tolerances: none. The tier ladders are integer functions; staged planes,
padded assignments, gathered planes, merged planes and re-parked
assignments are copies and must be equal bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from fleetflow_tpu.solver import buckets as ref_buckets
from fleetflow_tpu.solver import problem as ref_problem
from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
from fleetflow_tpu_torch.convert import resident_from_reference
from fleetflow_tpu_torch.solver import buckets as port_buckets
from fleetflow_tpu_torch.solver import problem as port_problem
from fleetflow_tpu_torch.solver.resident import ProblemDelta
from fleetflow_tpu_torch.solver.subsolve import (ActivePlan,
                                                 k5_stage_plain)
from test_torch_problem import CPU, make_pair, to_np

PLANES = ("demand", "capacity", "conflict_ids", "coloc_ids", "eligible",
          "node_valid", "node_topology", "preferred")
STATICS = ("S", "N", "G", "Gc", "T", "strategy", "max_skew")


def assert_problem_equal(ref_prob, port_prob):
    """Every plane bit-equal (uint32 words compared as int32), every
    static and n_real equal."""
    for name in PLANES:
        a, b = getattr(ref_prob, name), getattr(port_prob, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), to_np(b)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        assert a.shape == b.shape and np.array_equal(a, b), name
    for k in STATICS:
        assert getattr(ref_prob, k) == getattr(port_prob, k), k
    n_ref = ref_prob.n_real
    assert (None if n_ref is None else int(np.asarray(n_ref))) == \
        port_prob.n_real


@pytest.mark.parametrize("fn", ["bucket_size", "width_bucket",
                                "subsolve_tier", "bucket_bounds"])
def test_tier_functions_match_reference(fn):
    ref, port = getattr(ref_buckets, fn), getattr(port_buckets, fn)
    for k in range(1, 5001):
        assert ref(k) == port(k), (fn, k)


def test_bucket_config_reads_the_reference_names(monkeypatch):
    monkeypatch.setenv("FLEET_BUCKET", "0")
    monkeypatch.setenv("FLEET_BUCKET_GROWTH", "1.5")
    monkeypatch.setenv("FLEET_BUCKET_MIN", "32")
    a, b = ref_buckets.bucket_config(), port_buckets.bucket_config()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert not b.enabled and b.growth == 1.5 and b.minimum == 32


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("extras", [{}, {"preferred": True, "coloc": True},
                                    {"max_skew": 2, "domains": 5}])
def test_stage_problem_tiers_bit_equal(packed, extras, monkeypatch):
    monkeypatch.setenv("FLEET_PACKED", "1" if packed else "0")
    ref_pt, port_pt = make_pair(201, 37, 2, **extras)
    cfg = ref_buckets.bucket_config()
    dp, rinfo = ref_buckets.stage_problem_tiers(
        ref_pt, cfg, reuse_device_constants=False)
    tp, pinfo = port_buckets.stage_problem_tiers(
        port_pt, port_buckets.bucket_config(), CPU)
    assert tp.S > port_pt.S and tp.n_real == port_pt.S
    assert_problem_equal(dp, tp)
    assert (rinfo.orig_S, rinfo.padded_S, rinfo.G, rinfo.Gc) == \
        (pinfo.orig_S, pinfo.padded_S, pinfo.G, pinfo.Gc)
    # phantom rows: zero demand, no ids, every eligibility bit set
    ph = slice(port_pt.S, None)
    assert float(tp.demand[ph].abs().sum()) == 0
    assert bool((tp.conflict_ids[ph] == -1).all())
    assert bool((tp.coloc_ids[ph] == -1).all())
    fill = -1 if packed else True
    assert bool((tp.eligible[ph] == fill).all())


@pytest.mark.parametrize("packed", [True, False])
def test_pad_problem_tiers_matches_reference_and_staging(packed):
    ref_pt, port_pt = make_pair(150, 21, 3, preferred=not packed,
                                coloc=True)
    cfg = port_buckets.bucket_config()
    dp, _ = ref_buckets.pad_problem_tiers(
        ref_problem.prepare_problem(ref_pt, packed=packed),
        ref_buckets.bucket_config())
    tp, info = port_buckets.pad_problem_tiers(
        port_problem.prepare_problem(port_pt, CPU, packed=packed), cfg)
    assert_problem_equal(dp, tp)
    staged, _ = port_buckets.stage_problem_tiers(port_pt, cfg, CPU,
                                                 packed=packed)
    assert_problem_equal(dp, staged)
    # idempotent: a problem on its tiers comes back as the same object
    again, info2 = port_buckets.pad_problem_tiers(tp, cfg)
    assert again is tp and info2.padded_S == info.padded_S


def test_pad_problem_multiple_matches_reference():
    ref_pt, port_pt = make_pair(90, 17, 4, preferred=True)
    dp, s_ref = ref_buckets.pad_problem(
        ref_problem.prepare_problem(ref_pt, packed=True), 64)
    tp, s_port = port_buckets.pad_problem(
        port_problem.prepare_problem(port_pt, CPU, packed=True), 64)
    assert s_ref == s_port == 90 and tp.S == 128
    assert_problem_equal(dp, tp)


@pytest.mark.parametrize("first_dead", [0, 3])
def test_pad_assignment_matches_reference(first_dead):
    rng = np.random.default_rng(first_dead)
    a = rng.integers(0, 12, 50).astype(np.int32)
    valid = np.ones(12, dtype=bool)
    valid[:first_dead] = False
    ref = ref_buckets.pad_assignment(a, 64, valid)
    port = port_buckets.pad_assignment(a, 64, valid)
    assert ref.dtype == port.dtype and np.array_equal(ref, port)
    assert (port[50:] == first_dead).all()
    assert np.array_equal(port_buckets.pad_assignment(a, 50, valid), a)


@pytest.mark.parametrize("packed", [True, False])
def test_k5_gather_plain_is_fancy_indexing_of_reference_planes(packed,
                                                               monkeypatch):
    """K5's plain stage's slot planes (what the gather was) against numpy
    fancy indexing of the reference's staged planes, pad slots included."""
    monkeypatch.setenv("FLEET_PACKED", "1" if packed else "0")
    ref_pt, port_pt = make_pair(180, 40, 5, preferred=not packed)
    dp, _ = ref_buckets.stage_problem_tiers(ref_pt,
                                            reuse_device_constants=False)
    tp, _ = port_buckets.stage_problem_tiers(port_pt, device=CPU)
    S_pad = tp.S
    rng = np.random.default_rng(0)
    n_sub, tier = 37, 64
    rows = np.full(tier, S_pad, dtype=np.int32)
    rows[:n_sub] = np.sort(rng.choice(port_pt.S, n_sub, replace=False))
    rows[n_sub - 1] = S_pad + 3          # an out-of-range real slot clamps
    assignment = rng.integers(0, 40, S_pad).astype(np.int32)
    valid = np.asarray(dp.node_valid).copy()
    valid[:2] = False
    tp.node_valid = torch.tensor(valid)
    plan = ActivePlan(rows=rows, n_sub=n_sub, tier=tier, G_sub=16, Gc_sub=0,
                      conf_ids=np.empty(0, np.int32),
                      coloc_ids=np.empty(0, np.int32), n_real=port_pt.S,
                      Kc=4, Cc=4)
    demand, elig, pref, seed = k5_stage_plain(
        tp, torch.tensor(assignment), torch.tensor(plan.packed()), plan)[:4]

    g = np.minimum(rows, S_pad - 1)
    real = np.arange(tier) < n_sub
    exp_dem = np.where(real[:, None], np.asarray(dp.demand)[g], 0.0)
    e_ref = np.asarray(dp.eligible)
    if e_ref.dtype == np.uint32:
        e_ref = e_ref.view(np.int32)
    exp_elig = np.where(real[:, None], e_ref[g], -1 if packed else True)
    exp_seed = np.where(real, assignment[g], 2)
    assert np.array_equal(to_np(demand), exp_dem.astype(np.float32))
    assert to_np(elig).dtype == e_ref.dtype
    assert np.array_equal(to_np(elig), exp_elig)
    assert np.array_equal(to_np(seed), exp_seed)
    if packed:
        assert pref is None and dp.preferred is None
    else:
        exp_pref = np.where(real[:, None], np.asarray(dp.preferred)[g], 0.0)
        assert np.array_equal(to_np(pref), exp_pref.astype(np.float32))


def _grown(pt, k: int, N: int):
    """`pt` with k id-free arrivals appended (demand 0.01, eligible on every
    node but the first two), and the delta that carries them."""
    grow = lambda a: np.concatenate(  # noqa: E731
        [a, np.full((k, a.shape[1]), -1, dtype=a.dtype)])
    dem_new = np.full((k, pt.demand.shape[1]), 0.01, dtype=np.float32)
    elig_new = np.ones((k, N), dtype=bool)
    elig_new[:, :2] = False
    names = [f"arrival{i}" for i in range(k)]
    pt2 = dataclasses.replace(
        pt, service_names=pt.service_names + names,
        demand=np.concatenate([pt.demand, dem_new]),
        eligible=np.concatenate([pt.eligible, elig_new]),
        dep_adj=np.pad(pt.dep_adj, ((0, k), (0, k))),
        dep_depth=np.concatenate([pt.dep_depth,
                                  np.zeros(k, pt.dep_depth.dtype)]),
        port_ids=grow(pt.port_ids), volume_ids=grow(pt.volume_ids),
        anti_ids=grow(pt.anti_ids), coloc_ids=grow(pt.coloc_ids),
        replica_of=(pt.replica_of + names if pt.replica_of
                    else pt.replica_of))
    rows = np.arange(pt.S, pt.S + k, dtype=np.int32)
    return pt2, dict(demand_rows=(rows, dem_new),
                     eligible_rows=(rows, elig_new), n_real=pt.S + k)


def _resident_pair(S, N, seed):
    """A solved reference resident and the port's resident carrying the
    same staging and the same padded assignment."""
    ref_pt, port_pt = make_pair(S, N, seed)
    ref_rp = RefResident(ref_pt)
    ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=seed, steps=8,
              bucket=True)
    padded = np.asarray(ref_rp.assignment).copy()
    port_rp = resident_from_reference(port_pt, padded, True, device=CPU)
    return ref_rp, port_rp, ref_pt, port_pt


def test_arrival_merge_matches_reference():
    """Arrivals into phantom rows through ProblemDelta(n_real=...): the
    merged planes, n_real and the re-parked assignment equal the
    reference's bit for bit, and both take the delta path."""
    ref_rp, port_rp, ref_pt, port_pt = _resident_pair(73, 12, 4)
    ref_pt2, ref_kw = _grown(ref_pt, 3, 12)
    port_pt2, port_kw = _grown(port_pt, 3, 12)
    ref_delta, port_delta = RefDelta(**ref_kw), ProblemDelta(**port_kw)
    assert ref_rp.compatible(ref_pt2, ref_delta)
    assert port_rp.compatible(port_pt2, port_delta)
    # the richer arrivals the reference cold-stages do the same here
    assert not port_rp.compatible(port_pt2, ProblemDelta(
        demand_rows=port_kw["demand_rows"], n_real=port_pt2.S))
    pt3 = dataclasses.replace(port_pt2, port_ids=port_pt2.port_ids.copy())
    pt3.port_ids[-1, 0] = 0
    assert not port_rp.compatible(pt3, port_delta)
    ref_rp.apply_delta(ref_pt2, ref_delta)
    port_rp.apply_delta(port_pt2, port_delta)
    assert_problem_equal(ref_rp.prob, port_rp.prob)
    assert port_rp.prob.n_real == port_pt2.S
    assert np.array_equal(np.asarray(ref_rp.assignment),
                          to_np(port_rp.assignment))
    assert np.array_equal(ref_rp._mirror, port_rp._mirror)
    assert np.array_equal(ref_rp._pending_rows, port_rp._pending_rows)


def test_phantoms_reparked_when_their_node_dies():
    """Killing the first valid node (where phantoms park) re-parks every
    phantom on the next valid node, as the reference's merge does."""
    ref_rp, port_rp, ref_pt, port_pt = _resident_pair(70, 10, 6)
    S = port_pt.S
    park = int(np.argmax(port_pt.node_valid))
    assert (to_np(port_rp.assignment)[S:] == park).all()
    valid = port_pt.node_valid.copy()
    valid[park] = False
    ref_pt2 = dataclasses.replace(ref_pt, node_valid=valid.copy())
    port_pt2 = dataclasses.replace(port_pt, node_valid=valid.copy())
    ref_rp.apply_delta(ref_pt2, RefDelta(node_valid=valid.copy()))
    port_rp.apply_delta(port_pt2, ProblemDelta(node_valid=valid.copy()))
    after = to_np(port_rp.assignment)
    assert (after[S:] == int(np.argmax(valid))).all()
    assert np.array_equal(np.asarray(ref_rp.assignment), after)
    assert np.array_equal(port_rp._mirror, after)
    # real rows are not touched by the merge
    assert np.array_equal(after[:S], port_rp._mirror[:S])


def test_adopt_host_pads_and_mirrors_a_repaired_assignment():
    """A host-repaired real-row assignment goes back to the card padded,
    phantoms on the first valid node, as one counted upload, and becomes
    the sub-solve mirror (the reference's adopt_host)."""
    _ref_rp, port_rp, _ref_pt, port_pt = _resident_pair(60, 9, 7)
    valid = port_pt.node_valid.copy()
    valid[:2] = False
    repaired = np.random.default_rng(7).integers(2, 9, 60).astype(np.int32)
    before = port_rp.h2d_copies
    port_rp.adopt_host(repaired, valid)
    expect = port_buckets.pad_assignment(repaired, port_rp.prob.S, valid)
    assert port_rp.h2d_copies == before + 1
    assert np.array_equal(to_np(port_rp.assignment), expect)
    assert np.array_equal(port_rp._mirror, expect)
    assert (expect[60:] == 2).all()
