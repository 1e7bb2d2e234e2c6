"""The slot manager of fleetflow_tpu_torch's GpuSolverScheduler (device="cpu"):
per-stage byte accounting, LRU eviction to a count bound and a byte
budget, warm re-admission from the host snapshot, and place_many (the
reference's tests/test_sched.py::TestSlotManager, ported), plus the same
keyed call sequence through the port's and the JAX package's schedulers
leaving the same resident and evicted stage lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from fleetflow_tpu.lower import synthetic_problem as ref_synthetic
from fleetflow_tpu.sched import TpuSolverScheduler
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.sched import GpuSolverScheduler
from fleetflow_tpu_torch.solver.resident import ProblemDelta
from test_torch_problem import CPU



def _metric(name: str, **labels) -> float:
    """A family's child, read from the port's registry."""
    return REGISTRY.get(name).value(**labels)

def _pts(n=3, make=synthetic_problem):
    return {k: make(60, 12, seed=i, port_fraction=0.3, volume_fraction=0.2)
            for i, k in enumerate("ABCDEFGH"[:n])}


def _sched(**kw):
    return GpuSolverScheduler(device=CPU, steps=32, **kw)


def _stages(st):
    return ([s["stage"] for s in st["slots"]],
            [e["stage"] for e in st["evicted"]])


def test_evict_readmit_warm_seeds_bit_identically(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts()
    ctl = _sched()
    for k in "ABC":
        ctl.place(pts[k], stage=k)
    ref = ctl.reschedule(pts["A"], stage="A")

    # 2 slots: placing C evicts A (LRU); reschedule(A) re-admits it from
    # its host snapshot
    monkeypatch.setenv("FLEET_RESIDENT_STAGES", "2")
    hot = _sched()
    for k in "ABC":
        hot.place(pts[k], stage=k)
    st = hot.slots_status()
    assert _stages(st) == (["C", "B"], ["A"])
    assert st["evicted"][0]["snapshot"]
    readmits = _metric("fleet_sched_slot_readmissions_total")
    got = hot.reschedule(pts["A"], stage="A")
    assert _metric("fleet_sched_slot_readmissions_total") == readmits + 1
    assert np.array_equal(ref.raw, got.raw)
    assert got.feasible == ref.feasible
    assert hot.last_result.steps == ctl.last_result.steps
    assert _stages(hot.slots_status()) == (["A", "C"], ["A", "B"])


def test_readmission_re_parks_phantoms_like_a_merge(monkeypatch):
    """A stage evicted while the node its phantom rows sat on died is
    re-admitted with the phantoms on the first valid node, as the delta
    merge of a never-evicted slot puts them: the two stay bit-identical."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts()
    ctl, hot = _sched(), _sched()
    hot._max_slots = 1
    for sched in (ctl, hot):
        for k in "AB":
            sched.place(pts[k], stage=k)
    assert hot.slots_status()["evicted"][0]["stage"] == "A"
    assert ctl._slots[1].resident.prob.S > pts["A"].S     # phantom rows
    park = int(np.argmax(pts["A"].node_valid))
    valid = pts["A"].node_valid.copy()
    valid[park] = False
    cur = dataclasses.replace(pts["A"], node_valid=valid)
    want = ctl.reschedule(cur, stage="A",
                          delta=ProblemDelta(node_valid=valid.copy()))
    got = hot.reschedule(cur, stage="A",
                         delta=ProblemDelta(node_valid=valid.copy()))
    assert np.array_equal(want.raw, got.raw)
    assert got.feasible and not (got.raw == park).any()
    assert hot.last_result.telemetry["prerepair_moves"] == \
        ctl.last_result.telemetry["prerepair_moves"]


def test_tiny_byte_budget_never_deadlocks(monkeypatch):
    """A 1-byte budget is smaller than any slot: the admitted slot is never
    its own victim, so every stage places with one slot resident."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts()
    tiny = _sched(resident_bytes=1)
    for k in "ABC":
        assert tiny.place(pts[k], stage=k).feasible
    st = tiny.slots_status()
    assert len(st["slots"]) == 1 and st["slots"][0]["stage"] == "C"
    assert st["budget_bytes"] == 1
    assert st["resident_bytes"] > 0


def test_byte_budget_from_the_environment(monkeypatch):
    """FLEET_RESIDENT_BYTES bounds the slots: a budget of two and a half
    slots keeps two."""
    pts = _pts(4)
    one = _sched()
    one.place(pts["A"], stage="A")
    nbytes = one.slots_status()["resident_bytes"]
    monkeypatch.setenv("FLEET_RESIDENT_BYTES", str(int(2.5 * nbytes)))
    sched = _sched()
    for k in "ABCD":
        sched.place(pts[k], stage=k)
    assert _stages(sched.slots_status()) == (["D", "C"], ["A", "B"])


def test_slots_status_shape_and_accounting():
    pts = _pts(2)
    sched = _sched()
    for k in "AB":
        sched.place(pts[k], stage=k)
    st = sched.slots_status()
    assert {"budget_bytes", "max_slots", "resident_bytes", "bytes_drift",
            "slots", "evicted"} <= set(st)
    for s in st["slots"]:
        assert {"stage", "tier", "bytes", "idle_s", "evictions",
                "warm"} <= set(s)
        assert s["bytes"] > 0 and s["warm"]
        assert s["tier"] == "64x12"
    assert st["resident_bytes"] == sum(s["bytes"] for s in st["slots"])
    assert st["budget_bytes"] == 256 << 20 and st["max_slots"] == 8
    assert sched.byte_drift() == 0 == st["bytes_drift"]


def test_eviction_drops_the_device_tensors(monkeypatch):
    """An evicted slot's staging holds no tensor any more, even while a
    caller still holds the object."""
    monkeypatch.setenv("FLEET_RESIDENT_STAGES", "1")
    pts = _pts(2)
    sched = _sched()
    sched.place(pts["A"], stage="A")
    held = sched._slots[0].resident
    assert held.device_nbytes() > 0
    sched.place(pts["B"], stage="B")
    assert held.prob is None and held.assignment is None
    assert held.device_nbytes() == 0
    assert _metric("fleet_sched_slot_evictions_total") >= 1


def test_broken_delta_contract_counts_a_host_transfer(monkeypatch):
    """A warm request whose fleet a delta cannot express (relowered conflict
    ids) cold-stages the stage's slot in place and counts the host
    transfer; it still warm-starts from the stage's last assignment."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts(1)
    sched = _sched()
    first = sched.place(pts["A"], stage="A")
    relowered = dataclasses.replace(pts["A"],
                                    port_ids=pts["A"].port_ids.copy())
    count = _metric("fleet_solver_host_transfers_total")
    again = sched.reschedule(relowered, stage="A")
    assert _metric("fleet_solver_host_transfers_total") == count + 1
    assert again.feasible and len(sched._slots) == 1
    assert float((again.raw != first.raw).mean()) < 0.5


def test_place_many_matches_solo_reschedules(monkeypatch):
    """The batched path commits the placements solo warm reschedules
    would."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts()
    solo_sched = _sched()
    for k in "ABC":
        solo_sched.place(pts[k], stage=k)
    solo = {k: solo_sched.reschedule(pts[k], stage=k) for k in "ABC"}
    many = _sched()
    for k in "ABC":
        many.place(pts[k], stage=k)
    stages = _metric("fleet_solver_mux_lanes_total", kind="stage")
    batch = many.place_many([{"pt": pts[k], "warm_start": True, "stage": k}
                             for k in "ABC"])
    assert _metric("fleet_solver_mux_lanes_total", kind="stage") == stages + 3
    assert len(batch) == 3
    for k, res in zip("ABC", batch):
        assert np.array_equal(solo[k].raw, res.raw), k
        assert res.feasible == solo[k].feasible


def test_place_many_over_the_slot_bound(monkeypatch):
    """A call with more stages than slots keeps every staged slot until its
    solves are done: with 2 slots, 4 warm keyed stages (2 of them evicted
    before the call) batch into one dispatch equal to solo reschedules, and
    the evictions after it keep the placements the call returned, so each
    stage's next reschedule warm-starts from them."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts(4)
    ctl = _sched()
    for k in "ABCD":
        ctl.place(pts[k], stage=k)
    solo = {k: ctl.reschedule(pts[k], stage=k) for k in "ABCD"}
    again = {k: ctl.reschedule(pts[k], stage=k) for k in "ABCD"}

    monkeypatch.setenv("FLEET_RESIDENT_STAGES", "2")
    many = _sched()
    for k in "ABCD":
        many.place(pts[k], stage=k)
    assert _stages(many.slots_status()) == (["D", "C"], ["A", "B"])
    readmits = _metric("fleet_sched_slot_readmissions_total")
    stages = _metric("fleet_solver_mux_lanes_total", kind="stage")
    serial = _metric("fleet_solver_mux_lanes_total", kind="serial")
    batch = many.place_many([{"pt": pts[k], "warm_start": True, "stage": k}
                             for k in "ABCD"])
    assert _metric("fleet_sched_slot_readmissions_total") == readmits + 2
    assert _metric("fleet_solver_mux_lanes_total", kind="stage") == stages + 4
    assert _metric("fleet_solver_mux_lanes_total", kind="serial") == serial
    for k, res in zip("ABCD", batch):
        assert np.array_equal(solo[k].raw, res.raw), k
        assert res.feasible == solo[k].feasible
    st = many.slots_status()
    assert _stages(st) == (["D", "C"], ["A", "B"])
    assert st["resident_bytes"] == sum(s["bytes"] for s in st["slots"])
    assert many.byte_drift() == 0

    for k, res in zip("ABCD", batch):
        got = many.reschedule(pts[k], stage=k)
        assert np.array_equal(again[k].raw, got.raw), k
        if res.feasible:
            # a feasible warm seed on an unchanged fleet exits at 0 sweeps:
            # the seed is the placement the batch returned
            assert many.last_result.steps == 0
            assert np.array_equal(res.raw, got.raw), k


def test_place_many_mixes_batched_and_serial(monkeypatch):
    """A cold stage, a stage warm after churn and an unchanged warm stage in
    one call: results in request order, each what a solo call gives."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    pts = _pts(3)
    valid = pts["B"].node_valid.copy()
    valid[3] = False
    b2 = dataclasses.replace(pts["B"], node_valid=valid)
    reqs = [{"pt": pts["C"], "stage": "C"},
            {"pt": b2, "warm_start": True, "stage": "B",
             "delta": ProblemDelta(node_valid=valid.copy())},
            {"pt": pts["A"], "warm_start": True, "stage": "A"}]
    solo_sched, many = _sched(), _sched()
    for sched in (solo_sched, many):
        for k in "AB":
            sched.place(pts[k], stage=k)
    solo = [solo_sched.place(r["pt"], warm_start=r.get("warm_start", False),
                             delta=r.get("delta"), stage=r["stage"])
            for r in reqs]
    got = many.place_many(reqs)
    for want, res in zip(solo, got):
        assert np.array_equal(want.raw, res.raw)
    assert not (got[1].raw == 3).any()
    assert _stages(many.slots_status())[0] == ["A", "B", "C"]


def test_slot_lists_match_the_reference(monkeypatch):
    """With FLEET_RESIDENT_STAGES=2, one keyed sequence of place and
    reschedule calls leaves the same resident (MRU first) and evicted
    stage lists in both packages' schedulers after every call."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    monkeypatch.setenv("FLEET_RESIDENT_STAGES", "2")
    port_pts, ref_pts = _pts(4), _pts(4, make=ref_synthetic)
    port, ref = _sched(), TpuSolverScheduler(steps=32)
    calls = [("place", "A"), ("place", "B"), ("place", "C"),
             ("reschedule", "A"), ("place", "D"), ("reschedule", "B"),
             ("reschedule", "D"), ("reschedule", "C"), ("place", "A")]
    for verb, k in calls:
        getattr(port, verb)(port_pts[k], stage=k)
        getattr(ref, verb)(ref_pts[k], stage=k)
        assert _stages(port.slots_status()) == _stages(ref.slots_status()), \
            (verb, k)
    # a re-admitted stage keeps its record (its eviction count)
    assert _stages(port.slots_status()) == (["A", "C"], ["C", "A", "B", "D"])


def test_default_device_raises_without_cuda(monkeypatch):
    """place_many runs on the scheduler's device, the card by default:
    without CUDA the scheduler does not come up."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from fleetflow_tpu_torch.core.errors import SolverError
    with pytest.raises(SolverError):
        GpuSolverScheduler().place_many([{"pt": _pts(1)["A"]}])
    assert len(_sched().place_many([{"pt": _pts(1)["A"]}])) == 1
