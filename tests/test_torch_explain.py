"""The port's placement explainer (fleetflow_tpu_torch.solver.explain)
against the reference's, and against the port's own objective.

The same ProblemTensors (synthetic fleets with each strategy, preference
planes, colocation and conflict groups, dead nodes, the repo's production
example lowered) and the same assignment go to both packages'
``explain_assignment``: the reports must be equal, key for key (the
explainer is float64 numpy in both, so exactly). A node's score
difference must also be the change of the port's ``kernels.soft_score``
when the service moves there, as the reference's test holds its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fleetflow_tpu.core.model import PlacementStrategy as RefStrategy
from fleetflow_tpu.lower import tensors as ref_tensors
from fleetflow_tpu.solver.explain import explain_assignment as ref_explain
from fleetflow_tpu_torch.core.model import PlacementStrategy
from fleetflow_tpu_torch.lower import tensors as port_tensors
from fleetflow_tpu_torch.sched.host import greedy_host_place
from fleetflow_tpu_torch.solver.explain import explain_assignment
from fleetflow_tpu_torch.solver.kernels import soft_score
from fleetflow_tpu_torch.solver.problem import prepare_problem
from test_torch_problem import CPU


def pair(S, N, seed, strategy="spread_across_pool", preferred=False,
         **kw):
    """The same synthetic fleet in each package, with the strategy and an
    optional preference plane, and a host-greedy assignment of it."""
    ref = ref_tensors.synthetic_problem(S, N, seed=seed,
                                        strategy=RefStrategy(strategy), **kw)
    port = port_tensors.synthetic_problem(S, N, seed=seed,
                                          strategy=PlacementStrategy(strategy),
                                          **kw)
    if preferred:
        pref = np.random.default_rng(seed).uniform(
            0, 1, (S, N)).astype(np.float32)
        ref = dataclasses.replace(ref, preferred=pref)
        port = dataclasses.replace(port, preferred=pref.copy())
    assignment, _ = greedy_host_place(port)
    return ref, port, assignment


def reports_equal(ref_pt, port_pt, assignment, names, **kw):
    for name in names:
        want = ref_explain(ref_pt, assignment, name, **kw)
        got = explain_assignment(port_pt, assignment, name, **kw)
        assert got == want, name


@pytest.mark.parametrize("strategy", ["spread_across_pool",
                                      "pack_into_dedicated", "fill_lowest"])
@pytest.mark.parametrize("preferred", [False, True])
def test_reports_equal_the_reference(strategy, preferred):
    ref, port, assignment = pair(120, 10, 7, strategy, preferred,
                                 n_tenants=2, port_fraction=0.3,
                                 volume_fraction=0.1)
    reports_equal(ref, port, assignment, port.service_names[:25])
    reports_equal(ref, port, assignment, port.service_names[25:30],
                  top_k=10)


def test_colocation_and_dead_nodes():
    ref, port, assignment = pair(80, 8, 3, port_fraction=0.3)
    coloc = port_tensors._pad_ids([[i % 5] if i % 3 == 0 else []
                                   for i in range(port.S)])
    ref = dataclasses.replace(ref, coloc_ids=coloc.copy())
    port = dataclasses.replace(port, coloc_ids=coloc)
    valid = np.ones(port.N, dtype=bool)
    valid[[int(assignment[0]), 5]] = False
    reports_equal(ref, port, assignment, port.service_names[:20])
    reports_equal(ref, port, assignment, port.service_names[:20],
                  node_valid=valid)
    out = explain_assignment(port, assignment, port.service_names[0],
                             node_valid=valid)
    assert out["chosen"]["feasible"] is False and out["chosen_rank"] is None


def test_random_assignment_and_unknown_service():
    ref, port, _ = pair(60, 6, 11, port_fraction=0.5, volume_fraction=0.3)
    assignment = np.random.default_rng(0).integers(0, 6, 60).astype(np.int32)
    reports_equal(ref, port, assignment, port.service_names)
    with pytest.raises(KeyError):
        explain_assignment(port, assignment, "nope")
    with pytest.raises(KeyError):
        ref_explain(ref, assignment, "nope")


def test_production_example_reports_equal():
    from fleetflow_tpu import core as ref_core
    from fleetflow_tpu_torch import core as port_core
    from torch_frontend_cases import EXAMPLES
    root = str(EXAMPLES / "production")
    ref_pt = ref_tensors.lower_stage(ref_core.load_project_from_root_with_stage(
        root, "live", environ={}), "live")
    port_pt = port_tensors.lower_stage(
        port_core.load_project_from_root_with_stage(root, "live",
                                                    environ={}), "live")
    assignment, _ = greedy_host_place(port_pt)
    reports_equal(ref_pt, port_pt, assignment, port_pt.service_names)


def test_blocked_counts_partition_the_nodes():
    """Two services sharing a host port, four nodes: node w ineligible for
    a, node x too small for anyone, y and z fine (the reference's case)."""
    def build(pkg, strategy):
        return pkg.ProblemTensors(
            service_names=["a", "b"], node_names=list("wxyz"),
            demand=np.array([[1.0, 100.0, 0.0], [1.0, 100.0, 0.0]],
                            dtype=np.float32),
            capacity=np.array([[4.0, 1000.0, 10.0], [0.5, 50.0, 10.0],
                               [4.0, 1000.0, 10.0], [4.0, 1000.0, 10.0]],
                              dtype=np.float32),
            dep_adj=np.zeros((2, 2), dtype=bool),
            dep_depth=np.zeros(2, dtype=np.int32),
            port_ids=pkg._pad_ids([[0], [0]]),
            volume_ids=pkg._pad_ids([[], []]),
            anti_ids=pkg._pad_ids([[], []]),
            coloc_ids=pkg._pad_ids([[], []]),
            eligible=np.array([[False, True, True, True]] + [[True] * 4]),
            node_valid=np.ones(4, dtype=bool),
            node_topology=np.arange(4, dtype=np.int32),
            strategy=strategy, replica_of=["a", "b"])
    ref = build(ref_tensors, RefStrategy.SPREAD_ACROSS_POOL)
    port = build(port_tensors, PlacementStrategy.SPREAD_ACROSS_POOL)
    asn = np.array([2, 3])
    reports_equal(ref, port, asn, ["a", "b"], top_k=4)
    bc = explain_assignment(port, asn, "a")["blocked_counts"]
    assert (bc["ineligible"], bc["capacity"], bc["conflicts"],
            bc["feasible"]) == (1, 1, 1, 1)
    port.eligible[0, :] = False
    ref.eligible[0, :] = False
    reports_equal(ref, port, asn, ["a"])
    assert explain_assignment(port, asn, "a")["alternatives"] == []


def test_score_delta_matches_port_soft_score():
    """Moving service i from its node a to node b changes the port's
    kernels.soft_score by score[b] - score[a]."""
    _ref, pt, assignment = pair(60, 8, 4, preferred=True, n_tenants=2,
                                port_fraction=0.2, volume_fraction=0.1)
    prob = prepare_problem(pt, CPU)

    def score(a):
        return float(soft_score(prob, torch.as_tensor(a, device=CPU)))
    base = score(assignment)
    for name in pt.service_names[:6]:
        i = pt.service_names.index(name)
        out = explain_assignment(pt, assignment, name)
        for row in [out["chosen"]] + out["alternatives"]:
            b = pt.node_names.index(row["node"])
            if b == assignment[i]:
                continue
            moved = assignment.copy()
            moved[i] = b
            assert row["score"] - out["chosen"]["score"] == pytest.approx(
                score(moved) - base, abs=2e-3), (name, row["node"])
