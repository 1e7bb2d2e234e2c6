"""The solve telemetry of fleetflow_tpu_torch against the JAX package's, key
for key, on the same seeded fleets: the solo solve (cold, warm on the full
path, and warm through the churn-localized sub-solve, which adds
``subsolve``), the multiplexer's lanes and the sharded path; and with
FLEET_TRACE_FILE set, the ``solve.trace`` flight-recorder record each of
those solves writes, held to the reference's record.

The two packages draw different random numbers, so the values differ; the
schema must not: the same keys at every level, the same columns in every
``blocks`` row, and every float rounded to 6 decimals as the reference
rounds its payload.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synthetic
from fleetflow_tpu.solver import multiplex as ref_mux
from fleetflow_tpu.solver import sharded as ref_sh
from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs.trace import read_trace_file
from fleetflow_tpu_torch.solver import sharded as sh
from fleetflow_tpu_torch.solver import solve
from fleetflow_tpu_torch.solver.multiplex import MuxEntry, solve_multiplexed
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_problem import CPU


def _rounded(x) -> bool:
    return round(float(x), 6) == float(x)


def _same_schema(ref: dict, port: dict) -> None:
    assert ref is not None and port is not None
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    assert port["schema"] == ref["schema"]
    width = len(ref["schema"])
    for rows in (ref["blocks"], port["blocks"]):
        assert all(len(row) == width for row in rows)
    assert all(_rounded(x) for row in port["blocks"] for x in row)
    for key in ("init", "subsolve", "mux"):
        if key in ref:
            assert set(port[key]) == set(ref[key]), key
    if "init" in port:
        assert _rounded(port["init"]["soft"])
    for key, v in ref.items():
        if not isinstance(v, (dict, list)):
            assert type(port[key]) is type(v), key


def _pair(S, N, seed, **kw):
    return (ref_synthetic(S, N, seed=seed, **kw),
            synthetic_problem(S, N, seed=seed, **kw))


def _kill_busiest(pt, assignment, k=1):
    valid = pt.node_valid.copy()
    valid[np.argsort(-np.bincount(assignment, minlength=pt.N))[:k]] = False
    return valid


def test_solo_full_path_schema():
    """Cold and warm (the warm_block probe) solves on the full path."""
    ref_pt, port_pt = _pair(100, 10, 3)
    ref_cold = ref_solve(ref_pt, chains=4, steps=300, seed=3)
    port_cold = solve(port_pt, device="cpu", chains=4, steps=300, seed=3)
    _same_schema(ref_cold.telemetry, port_cold.telemetry)
    assert port_cold.telemetry["blocks"] and ref_cold.telemetry["blocks"]
    assert port_cold.telemetry["path"] == "full"
    valid = _kill_busiest(port_pt, port_cold.assignment)
    ref_pt.node_valid[:] = valid
    port_pt.node_valid[:] = valid
    ref_warm = ref_solve(ref_pt, chains=4, steps=300, seed=4,
                         init_assignment=port_cold.assignment)
    port_warm = solve(port_pt, device="cpu", chains=4, steps=300, seed=4,
                      init_assignment=port_cold.assignment)
    _same_schema(ref_warm.telemetry, port_warm.telemetry)
    assert "subsolve" not in port_warm.telemetry


def test_solo_subsolve_schema(monkeypatch):
    """A resident-warm solve that localizes: both packages add the
    sub-solve's record under ``subsolve``."""
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
    monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "0.6")
    kw = dict(port_fraction=0.25, volume_fraction=0.15)
    ref_pt, port_pt = _pair(140, 14, 5, **kw)
    ref_rp, port_rp = RefResident(ref_pt), ResidentProblem(port_pt, CPU)
    solve_kw = dict(steps=32, chains=1, bucket=True)
    ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=5, **solve_kw)
    cold = solve(port_pt, prob=port_rp.prob, resident=port_rp, seed=5,
                 **solve_kw)
    valid = _kill_busiest(port_pt, cold.assignment, 2)
    ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
    port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
    ref_rp.apply_delta(ref_cur, RefDelta(node_valid=valid.copy()))
    port_rp.apply_delta(port_cur, ProblemDelta(node_valid=valid.copy()))
    ref = ref_solve(ref_cur, prob=ref_rp.prob, resident=ref_rp,
                    resident_warm=True, seed=7, **solve_kw)
    port = solve(port_cur, prob=port_rp.prob, resident=port_rp,
                 resident_warm=True, seed=7, **solve_kw)
    assert ref.subsolve is not None and port.subsolve is not None
    _same_schema(ref.telemetry, port.telemetry)
    assert port.telemetry["subsolve"] == port.subsolve
    # the port's sub-solve swept, so its rows are held to the schema's
    # width (the reference's draws may exit before a sweep)
    assert port.telemetry["blocks"]
    assert port.telemetry["path"] == ("subsolve" if port.subsolve["outcome"]
                                      == "localized" else "full")


def test_mux_lane_schema(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    ref_entries, port_entries = [], []
    for i in range(3):
        ref_pt, port_pt = _pair(60, 12, 40 + i, port_fraction=0.3,
                                volume_fraction=0.2)
        ref_rp, port_rp = RefResident(ref_pt), ResidentProblem(port_pt, CPU)
        ref_solve(ref_pt, prob=ref_rp.prob, resident=ref_rp, seed=i, steps=32)
        cold = solve(port_pt, prob=port_rp.prob, resident=port_rp, seed=i,
                     steps=32)
        valid = _kill_busiest(port_pt, cold.assignment, 2)
        ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
        port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
        ref_rp.apply_delta(ref_cur, RefDelta(node_valid=valid.copy()))
        port_rp.apply_delta(port_cur, ProblemDelta(node_valid=valid.copy()))
        ref_entries.append(ref_mux.MuxEntry(pt=ref_cur, resident=ref_rp,
                                            seed=i))
        port_entries.append(MuxEntry(pt=port_cur, resident=port_rp, seed=i))
    ref_res = ref_mux.solve_multiplexed(ref_entries, steps=32)
    port_res = solve_multiplexed(port_entries, steps=32, device="cpu")
    for j, (rr, pr) in enumerate(zip(ref_res, port_res)):
        _same_schema(rr.telemetry, pr.telemetry)
        assert pr.telemetry["path"] == "mux"
        assert pr.telemetry["mux"] == {"k": 4, "lane": j}
    # the 2 killed nodes make lanes sweep, so rows are compared too
    assert any(r.telemetry["blocks"] for r in port_res)
    assert any(r.telemetry["blocks"] for r in ref_res)


def test_sharded_schema():
    ref_pt, port_pt = _pair(73, 12, 2, port_fraction=0.3)
    ref_rp = ref_sh.ShardedResident(ref_pt, mesh=ref_sh.tempering_mesh(2, 4))
    port_rp = sh.ShardedResident(port_pt, mesh=sh.tempering_mesh(
        2, 4, devices=["cpu"] * 8))
    init = np.zeros(73, np.int32)
    ref = ref_sh.solve_sharded(ref_pt, resident=ref_rp, steps=16, seed=2,
                               init_assignment=init, block=4)
    port = sh.solve_sharded(port_pt, resident=port_rp, steps=16, seed=2,
                            init_assignment=init, block=4)
    _same_schema(ref.telemetry, port.telemetry)
    assert port.telemetry["path"] == "sharded"


@pytest.mark.parametrize("blocks", ["0", "4"])
def test_trace_blocks_knob(blocks, monkeypatch):
    """FLEET_SOLVE_TRACE_BLOCKS=0 drops the payload in both packages;
    another value sets trace_blocks in both."""
    monkeypatch.setenv("FLEET_SOLVE_TRACE_BLOCKS", blocks)
    ref_pt, port_pt = _pair(60, 8, 1)
    ref = ref_solve(ref_pt, chains=2, steps=32, seed=1).telemetry
    port = solve(port_pt, device="cpu", chains=2, steps=32, seed=1).telemetry
    if blocks == "0":
        assert ref is None and port is None
    else:
        _same_schema(ref, port)
        assert port["trace_blocks"] == ref["trace_blocks"] == 4


# --------------------------------------------------------------------------
# the flight recorder: one solve.trace record a solve (FLEET_TRACE_FILE)
# --------------------------------------------------------------------------

def _traced(monkeypatch, path, fn, *args, **kw):
    """fn(*args, **kw) with FLEET_TRACE_FILE pointing at `path`."""
    monkeypatch.setenv("FLEET_TRACE_FILE", str(path))
    try:
        return fn(*args, **kw)
    finally:
        monkeypatch.delenv("FLEET_TRACE_FILE")


def _records(path) -> list:
    if not path.exists():
        return []
    return [e for e in read_trace_file(str(path))
            if e["kind"] == "telemetry" and e["name"] == "solve.trace"]


def _route_full(monkeypatch, ref_f, port_f):
    ref_pt, port_pt = _pair(100, 10, 3)
    port_res = [_traced(monkeypatch, port_f, solve, port_pt, device="cpu",
                        chains=2, steps=64, seed=3)]
    _traced(monkeypatch, ref_f, ref_solve, ref_pt, chains=2, steps=64, seed=3)
    valid = _kill_busiest(port_pt, port_res[0].assignment)
    ref_pt.node_valid[:] = valid
    port_pt.node_valid[:] = valid
    init = port_res[0].assignment
    port_res.append(_traced(monkeypatch, port_f, solve, port_pt,
                            device="cpu", chains=2, steps=64, seed=4,
                            init_assignment=init))
    _traced(monkeypatch, ref_f, ref_solve, ref_pt, chains=2, steps=64,
            seed=4, init_assignment=init)
    return port_res


def _route_subsolve(monkeypatch, ref_f, port_f):
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
    monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "0.6")
    ref_pt, port_pt = _pair(140, 14, 5, port_fraction=0.25,
                            volume_fraction=0.15)
    ref_rp, port_rp = RefResident(ref_pt), ResidentProblem(port_pt, CPU)
    kw = dict(steps=32, chains=1, bucket=True)
    _traced(monkeypatch, ref_f, ref_solve, ref_pt, prob=ref_rp.prob,
            resident=ref_rp, seed=5, **kw)
    port_res = [_traced(monkeypatch, port_f, solve, port_pt,
                        prob=port_rp.prob, resident=port_rp, seed=5, **kw)]
    valid = _kill_busiest(port_pt, port_res[0].assignment, 2)
    ref_cur = dataclasses.replace(ref_pt, node_valid=valid.copy())
    port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
    ref_rp.apply_delta(ref_cur, RefDelta(node_valid=valid.copy()))
    port_rp.apply_delta(port_cur, ProblemDelta(node_valid=valid.copy()))
    _traced(monkeypatch, ref_f, ref_solve, ref_cur, prob=ref_rp.prob,
            resident=ref_rp, resident_warm=True, seed=7, **kw)
    port_res.append(_traced(monkeypatch, port_f, solve, port_cur,
                            prob=port_rp.prob, resident=port_rp,
                            resident_warm=True, seed=7, **kw))
    assert port_res[1].subsolve is not None
    return port_res


def _route_mux(monkeypatch, ref_f, port_f):
    """Three stages' cold solves and one batch of their warm lanes. The
    reference records no lane (its multiplexer writes no solve.trace); the
    port's lane records are held to the keys of the reference's solo
    records."""
    monkeypatch.setenv("FLEET_SUBSOLVE", "0")
    port_res, entries = [], []
    for i in range(3):
        ref_pt, port_pt = _pair(60, 12, 40 + i, port_fraction=0.3,
                                volume_fraction=0.2)
        ref_rp, port_rp = RefResident(ref_pt), ResidentProblem(port_pt, CPU)
        _traced(monkeypatch, ref_f, ref_solve, ref_pt, prob=ref_rp.prob,
                resident=ref_rp, seed=i, steps=32)
        cold = _traced(monkeypatch, port_f, solve, port_pt,
                       prob=port_rp.prob, resident=port_rp, seed=i, steps=32)
        port_res.append(cold)
        valid = _kill_busiest(port_pt, cold.assignment, 2)
        port_cur = dataclasses.replace(port_pt, node_valid=valid.copy())
        port_rp.apply_delta(port_cur, ProblemDelta(node_valid=valid.copy()))
        entries.append(MuxEntry(pt=port_cur, resident=port_rp, seed=i))
    lanes = _traced(monkeypatch, port_f, solve_multiplexed, entries,
                    steps=32, device="cpu")
    assert all(r.telemetry["path"] == "mux" for r in lanes)
    return port_res + lanes


def _route_sharded(monkeypatch, ref_f, port_f):
    ref_pt, port_pt = _pair(73, 12, 2, port_fraction=0.3)
    ref_rp = ref_sh.ShardedResident(ref_pt, mesh=ref_sh.tempering_mesh(2, 4))
    port_rp = sh.ShardedResident(port_pt, mesh=sh.tempering_mesh(
        2, 4, devices=["cpu"] * 8))
    init = np.zeros(73, np.int32)
    _traced(monkeypatch, ref_f, ref_sh.solve_sharded, ref_pt,
            resident=ref_rp, steps=16, seed=2, init_assignment=init, block=4)
    return [_traced(monkeypatch, port_f, sh.solve_sharded, port_pt,
                    resident=port_rp, steps=16, seed=2,
                    init_assignment=init, block=4)]


@pytest.mark.parametrize("route", ["full", "subsolve", "mux", "sharded"])
def test_flight_recorder_record_per_solve(route, tmp_path, monkeypatch):
    """Each solve of a route writes one solve.trace record: its fields'
    keys are those of the reference's record of the same solve (of a solo
    solve for a mux lane), and its payload is the solve's
    SolveResult.telemetry."""
    ref_f, port_f = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    port_res = globals()[f"_route_{route}"](monkeypatch, ref_f, port_f)
    ref_recs, port_recs = _records(ref_f), _records(port_f)
    assert len(port_recs) == len(port_res)
    assert ref_recs
    ref_keys = {frozenset(r["fields"]) for r in ref_recs}
    assert len(ref_keys) == 1
    for rec, res in zip(port_recs, port_res):
        assert frozenset(rec["fields"]) in ref_keys
        assert rec["logger"] == "fleetflow.solver"
        assert rec["fields"]["telemetry"] == json.loads(json.dumps(
            res.telemetry))
        assert rec["fields"]["violations"] == res.violations
    if route != "mux":
        assert len(ref_recs) == len(port_recs)
        for ref_rec, port_rec in zip(ref_recs, port_recs):
            assert set(port_rec["fields"]) == set(ref_rec["fields"])
            for key in ("S", "N", "warm", "resident"):
                assert port_rec["fields"][key] == ref_rec["fields"][key]
