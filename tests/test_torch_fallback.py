"""The host schedulers and the relaxation ladder of fleetflow_tpu_torch
against the JAX package, on the CPU.

relax_problem and place_with_fallback over the host greedy and the native
schedulers must equal the reference's on the same problems (relaxed list,
assignment, source). Over GpuSolverScheduler(device="cpu") with a stage
key, the relaxed re-solve must be feasible, relax what the reference's
TpuSolverScheduler relaxes, and keep exactly one slot for the key.
pick_scheduler must pick the counterpart of the reference's class.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from fleetflow_tpu.native import NativeGreedyScheduler as RefNative
from fleetflow_tpu.sched import HostGreedyScheduler as RefHost
from fleetflow_tpu.sched import TpuSolverScheduler
from fleetflow_tpu.sched import pick_scheduler as ref_pick
from fleetflow_tpu.sched.fallback import place_with_fallback as ref_pwf
from fleetflow_tpu.sched.fallback import relax_problem as ref_relax
from fleetflow_tpu_torch.core.errors import SolverError
from fleetflow_tpu_torch.lower import tensors as port_tensors
from fleetflow_tpu_torch.native import NativeGreedyScheduler
from fleetflow_tpu_torch.sched import (GpuSolverScheduler,
                                       HostGreedyScheduler, gpu,
                                       pick_scheduler, place_with_fallback,
                                       relax_problem)
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.solver.repair import verify
from test_torch_problem import CPU, STRATEGIES, make_pair
from test_torch_seeds import tier_blocked

LADDER = ["preferred", "spread", "tier"]


def _placements() -> float:
    """Placements the port's registry counted, over every source."""
    return sum(v for k, v in REGISTRY.counter_values().items()
               if k.startswith("fleet_placements_total{"))


def _pair(S, N, seed, *, blocked=True, relax_order=LADDER, strategy=
          "spread_across_pool", **kw):
    ref_pt, port_pt = make_pair(S, N, seed, n_tenants=1, strategy=strategy,
                                **kw)
    if blocked:
        ref_pt, port_pt = tier_blocked(ref_pt), tier_blocked(port_pt)
    ref_pt = dataclasses.replace(ref_pt, relax_order=list(relax_order))
    port_pt = dataclasses.replace(port_pt, relax_order=list(relax_order))
    return ref_pt, port_pt


@pytest.mark.parametrize("what", ["preferred", "preferred_labels", "spread",
                                  "spread_constraint", "tier", "labels",
                                  "required_labels", "eligibility",
                                  "bogus"])
def test_relax_problem_matches_reference(what):
    ref_pt, port_pt = _pair(120, 16, 1, preferred=True, max_skew=2,
                            domains=4)
    ref, port = ref_relax(ref_pt, what), relax_problem(port_pt, what)
    assert (ref is None) == (port is None)
    if port is None:
        return
    assert (ref.preferred is None) == (port.preferred is None)
    assert ref.max_skew == port.max_skew
    assert np.array_equal(ref.eligible, port.eligible)
    assert port.eligible is not port_pt.eligible or what not in (
        "tier", "labels", "required_labels", "eligibility")
    # a second relaxation of the same class has nothing left to relax
    assert relax_problem(port, what) is None
    assert ref_relax(ref, what) is None


def test_relax_problem_absent_classes():
    _, pt = _pair(60, 8, 0, blocked=False)
    for what in ("preferred", "spread", "tier"):
        assert relax_problem(pt, what) is None


@pytest.mark.parametrize("case", [
    "blocked-ladder", "blocked-no-tier", "feasible", "blocked-pref-skew",
    "blocked-pack", "blocked-fill"])
@pytest.mark.parametrize("backend", ["host", "native"])
def test_place_with_fallback_matches_reference(backend, case):
    order = ["preferred", "spread"] if case == "blocked-no-tier" else LADDER
    strategy = {"blocked-pack": "pack_into_dedicated",
                "blocked-fill": "fill_lowest"}.get(case, "spread_across_pool")
    extra = ({"preferred": True, "max_skew": 2, "domains": 4}
             if case == "blocked-pref-skew" else {})
    ref_pt, port_pt = _pair(300, 36, 2, blocked=case != "feasible",
                            relax_order=order, strategy=strategy, **extra)
    ref_sched, sched = ((RefHost(), HostGreedyScheduler())
                        if backend == "host"
                        else (RefNative(), NativeGreedyScheduler()))
    before = _placements()
    ref_p, ref_relaxed = ref_pwf(ref_sched, ref_pt)
    port_p, relaxed = place_with_fallback(sched, port_pt)
    assert relaxed == ref_relaxed
    assert port_p.source == ref_p.source
    assert port_p.feasible == ref_p.feasible
    assert port_p.violations == ref_p.violations
    assert np.array_equal(port_p.raw, ref_p.raw)
    assert port_p.assignment == ref_p.assignment
    assert port_p.levels == ref_p.levels
    solves = 1 + len(relaxed)
    assert _placements() - before == solves
    if case == "feasible":
        assert relaxed == [] and port_p.feasible
    elif case == "blocked-no-tier":
        assert not port_p.feasible
    else:
        assert port_p.feasible and relaxed[-1] == "tier"
        assert port_p.source.endswith("+relaxed:" + ",".join(relaxed))


def test_place_with_fallback_initial_skips_first_solve():
    _, pt = _pair(200, 24, 3)
    sched = HostGreedyScheduler()
    first = sched.place(pt)
    assert not first.feasible
    before = _placements()
    placement, relaxed = place_with_fallback(sched, pt, initial=first)
    assert placement.feasible and relaxed == LADDER[2:]
    assert _placements() - before == 1


def test_gpu_scheduler_relaxes_in_the_stage_slot(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    ref_pt, port_pt = _pair(240, 30, 4, relax_order=["spread", "tier"])
    ref_p, ref_relaxed = ref_pwf(TpuSolverScheduler(), ref_pt,
                                 place_kwargs={"stage": "web"})
    sched = GpuSolverScheduler(device="cpu")
    other = sched.place(make_pair(60, 8, 0)[1], stage="db")
    placement, relaxed = place_with_fallback(sched, port_pt,
                                             place_kwargs={"stage": "web"})
    assert relaxed == ref_relaxed == ["tier"]
    assert ref_p.feasible and placement.feasible
    assert placement.source == "gpu-anneal+relaxed:tier"
    relaxed_pt = relax_problem(port_pt, "tier")
    assert verify(relaxed_pt, placement.raw)["total"] == 0
    assert [s.key for s in sched._slots].count("web") == 1
    assert [s.key for s in sched._slots].count("db") == 1 and other.feasible
    # the stage's slot warm-starts from the relaxed winner
    slot = next(s for s in sched._slots if s.key == "web")
    assert np.array_equal(slot.last_assignment, placement.raw)
    again = sched.reschedule(relaxed_pt, stage="web")
    assert again.feasible and sched.last_result.fused_prerepair


GRID = [(1, 1), (1, 500), (8, 8), (15, 34), (16, 32), (100, 1), (100, 4),
        (100, 6), (50, 1000), (1000, 49), (1000, 50), (10_000, 1000)]


@pytest.mark.parametrize("prefer", [True, False])
def test_pick_scheduler_matches_reference(prefer, monkeypatch):
    # the card's scheduler is built on the CPU here: pick_scheduler's
    # choice must not depend on whether a card is present
    monkeypatch.setattr(gpu, "resolve_device", lambda device=None: CPU)
    names = {"HostGreedyScheduler": "HostGreedyScheduler",
             "NativeGreedyScheduler": "NativeGreedyScheduler",
             "TpuSolverScheduler": "GpuSolverScheduler"}
    for S, N in GRID:
        ref = ref_pick(S, N, prefer_tpu=prefer)
        port = pick_scheduler(S, N, prefer_gpu=prefer)
        assert type(port).__name__ == names[type(ref).__name__], (S, N)
        # device= names the card solver's device and changes no choice
        named = pick_scheduler(S, N, prefer_gpu=prefer, device="cpu")
        assert type(named) is type(port), (S, N)
        if isinstance(named, GpuSolverScheduler):
            assert named.device == CPU


def test_pick_scheduler_device_reaches_the_card_solver(monkeypatch):
    """Without a card, device="cpu" builds the card solver on the host
    (its plain versions); device=None raises, and so does a device that
    names CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for S, N in GRID:
        ref = type(ref_pick(S, N)).__name__
        sched = pick_scheduler(S, N, device="cpu")
        if ref == "TpuSolverScheduler":
            assert isinstance(sched, GpuSolverScheduler)
            assert sched.device == CPU
            for dev in (None, "cuda", "cuda:0"):
                with pytest.raises(SolverError):
                    pick_scheduler(S, N, device=dev)
        else:
            assert type(sched).__name__ == ref
            assert type(pick_scheduler(S, N)).__name__ == ref


def test_pick_scheduler_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SolverError):
        pick_scheduler(10_000, 1000)
    assert isinstance(pick_scheduler(4, 4), HostGreedyScheduler)
    assert isinstance(pick_scheduler(10_000, 1000, prefer_gpu=False),
                      NativeGreedyScheduler)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_host_schedulers_place_feasible(strategy):
    _, pt = make_pair(300, 40, 5, strategy=strategy)
    host, native = HostGreedyScheduler().place(pt), \
        NativeGreedyScheduler().place(pt)
    assert host.source == "host-greedy" and native.source == "cpp-greedy"
    assert host.feasible and native.feasible
    assert host.assignment == native.assignment
    assert verify(pt, native.raw)["total"] == 0


def test_relax_classes_match_reference():
    from fleetflow_tpu.lower import tensors as ref_tensors
    for name in ("ELIGIBILITY_RELAX_CLASSES", "SPREAD_RELAX_CLASSES",
                 "PREF_RELAX_CLASSES"):
        assert getattr(port_tensors, name) == getattr(ref_tensors, name)


def test_converted_problem_relaxes_as_the_reference():
    """A reference problem with a relax order, a preference plane and a
    spread constraint, carried across by convert.tensors_from_reference,
    walks the same ladder to the same placement."""
    from fleetflow_tpu_torch.convert import tensors_from_reference
    ref_pt, _ = _pair(260, 30, 6, preferred=True, max_skew=2, domains=5)
    fields = {f.name: getattr(ref_pt, f.name)
              for f in dataclasses.fields(ref_pt)}
    pt = tensors_from_reference(fields)
    assert pt.relax_order == LADDER and pt.relax_order is not ref_pt.relax_order
    assert pt.preferred.dtype == np.float32 and pt.max_skew == 2
    ref_p, ref_relaxed = ref_pwf(RefHost(), ref_pt)
    port_p, relaxed = place_with_fallback(HostGreedyScheduler(), pt)
    assert relaxed == ref_relaxed == LADDER
    assert np.array_equal(port_p.raw, ref_p.raw)
    assert port_p.source == ref_p.source
