"""The port's logging, spans, trace correlation, flight recorder and
profile_trace (fleetflow_tpu_torch/obs/__init__.py, obs/trace.py), as the
reference's tests/test_obs.py and tests/test_trace_reentry.py hold the
reference's; the solver's log lines and dispatch scope; and the one
logger namespace both packages share (`fleetflow`): configured by both in
turn, a line is printed once."""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from fleetflow_tpu import obs as ref_obs
from fleetflow_tpu_torch import obs
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs import configure, get_logger, kv, span
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.obs.trace import (current_span_id, current_trace_id,
                                           flight_recorder, read_trace_file,
                                           read_trace_files, use_trace)
from fleetflow_tpu_torch.solver import api, solve

log = get_logger("test.trace")


@pytest.fixture(autouse=True)
def reset_logging():
    """Each test configures the fleetflow logger tree from scratch, in both
    packages."""
    yield
    root = logging.getLogger("fleetflow")
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(logging.NOTSET)
    root.propagate = True
    for name in list(logging.Logger.manager.loggerDict):
        if name.startswith("fleetflow."):
            logging.getLogger(name).setLevel(logging.NOTSET)
    obs._configured = False
    ref_obs._configured = False


def capture(spec: str) -> io.StringIO:
    buf = io.StringIO()
    configure(spec, force=True, stream=buf)
    return buf


@pytest.mark.parametrize("fields,want", [
    (dict(a=1, b="x"), "a=1 b=x"),
    (dict(a=None, msg="two words"), "msg='two words'"),
    (dict(a=""), "a=''"),
])
def test_kv(fields, want):
    assert kv(**fields) == want == ref_obs.kv(**fields)


class TestConfigure:
    def test_unset_leaves_library_mode(self):
        configure("", force=True)
        assert not logging.getLogger("fleetflow").handlers

    @pytest.mark.parametrize("spec,root_level,levels", [
        ("debug", logging.DEBUG, {}),
        ("info,solver=debug", logging.INFO,
         {"solver": logging.DEBUG, "engine": logging.INFO}),
        ("bogus=nope,debug", logging.DEBUG, {}),
        (" ,, info , solver=debug ,", logging.INFO,
         {"solver": logging.DEBUG}),
        ("solver=debug", logging.INFO, {"solver": logging.DEBUG}),
    ])
    def test_levels(self, spec, root_level, levels):
        capture(spec)
        assert logging.getLogger("fleetflow").level == root_level
        for mod, level in levels.items():
            assert logging.getLogger(
                f"fleetflow.{mod}").getEffectiveLevel() == level

    def test_trace_is_a_real_level_below_debug(self):
        assert obs.TRACE == 5 and obs.TRACE < logging.DEBUG
        assert obs._LEVELS["trace"] == obs.TRACE
        assert logging.getLevelName(obs.TRACE) == "TRACE"
        capture("solver=trace,engine=debug")
        solver = logging.getLogger("fleetflow.solver")
        engine = logging.getLogger("fleetflow.engine")
        assert solver.getEffectiveLevel() == obs.TRACE
        assert engine.getEffectiveLevel() == logging.DEBUG
        assert solver.isEnabledFor(obs.TRACE)
        assert not engine.isEnabledFor(obs.TRACE)

    def test_unknown_level_token_in_pair_is_ignored(self):
        capture("solver=verbose,info")
        assert logging.getLogger("fleetflow.solver").level == logging.NOTSET
        assert logging.getLogger("fleetflow").level == logging.INFO

    def test_repeated_force_configure_does_not_stack_handlers(self):
        for _ in range(3):
            configure("info", force=True, stream=io.StringIO())
        assert len(logging.getLogger("fleetflow").handlers) == 1

    @pytest.mark.parametrize("first", ["reference", "port"])
    def test_both_packages_configured_print_each_line_once(
            self, first, monkeypatch):
        """Both packages log under `fleetflow`, each with its own
        configured flag: whichever configures first installs the handler,
        the port's configure adds none beside it, and force=True still
        replaces it."""
        buf = io.StringIO()
        root = logging.getLogger("fleetflow")
        if first == "reference":
            ref_obs.configure("info", force=True, stream=buf)
            configure("info", stream=io.StringIO())
        else:
            # the reference's lazy configure (FLEET_LOG unset) adds nothing
            monkeypatch.delenv("FLEET_LOG", raising=False)
            configure("info", force=True, stream=buf)
        assert len(root.handlers) == 1
        get_logger("solver").info("port line")
        ref_obs.get_logger("solver").info("reference line")
        out = buf.getvalue()
        assert out.count("port line") == 1
        assert out.count("reference line") == 1
        forced = io.StringIO()
        configure("info", force=True, stream=forced)
        assert len(root.handlers) == 1
        get_logger("solver").info("after force")
        assert forced.getvalue().count("after force") == 1
        assert "after force" not in buf.getvalue()


class TestSpan:
    def test_success_logs_duration_and_fields(self):
        buf = capture("debug")
        with span(get_logger("t"), "work", stage="live") as sp:
            sp["placed"] = 3
        out = buf.getvalue()
        assert "work started stage=live" in out
        assert "duration_ms=" in out and "placed=3" in out

    def test_failure_logs_error_and_reraises(self):
        buf = capture("debug")
        with pytest.raises(ValueError):
            with span(get_logger("t"), "work"):
                raise ValueError("boom")
        assert "work failed" in buf.getvalue() and "boom" in buf.getvalue()

    def test_failure_line_carries_collected_extra_fields(self):
        buf = capture("debug")
        with pytest.raises(RuntimeError):
            with span(get_logger("t"), "work", stage="live") as sp:
                sp["placed"] = 7
                raise RuntimeError("midway")
        line = [ln for ln in buf.getvalue().splitlines()
                if "work failed" in ln][0]
        assert "placed=7" in line and "stage=live" in line
        assert "error=midway" in line

    def test_span_lines_carry_trace_and_span_ids(self):
        buf = capture("debug")
        lg = get_logger("t")
        with obs.use_trace("feedc0de"):
            with span(lg, "work"):
                lg.info("inner %s", kv(step=1))
        lines = [ln for ln in buf.getvalue().splitlines() if "trace=" in ln]
        assert len(lines) >= 2
        assert all("trace=feedc0de" in ln for ln in lines)
        assert any("span=" in ln for ln in lines)

    def test_kv_outside_any_trace_is_unchanged(self):
        assert obs.current_trace_id() == ""
        assert kv(a=1) == "a=1"

    def test_nested_spans_restore_parent_context(self):
        with obs.use_trace() as tid:
            with span(get_logger("t"), "outer"):
                outer_span = obs.current_span_id()
                with span(get_logger("t"), "inner"):
                    assert obs.current_span_id() != outer_span
                    assert obs.current_trace_id() == tid
                assert obs.current_span_id() == outer_span
        assert obs.current_trace_id() == ""


class TestFlightRecorder:
    def test_span_events_written_and_parented(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_TRACE_FILE", str(tmp_path / "t.jsonl"))
        lg = get_logger("t")
        with span(lg, "outer", stage="live") as sp:
            sp["n"] = 2
            with span(lg, "inner"):
                pass
        events = read_trace_file(str(tmp_path / "t.jsonl"))
        assert [(e["kind"], e["name"]) for e in events] == [
            ("begin", "outer"), ("begin", "inner"), ("end", "inner"),
            ("end", "outer")]
        outer_b, inner_b, inner_e, outer_e = events
        assert len({e["trace"] for e in events}) == 1
        assert inner_b["parent"] == outer_b["span"]
        assert outer_e["duration_ms"] >= inner_e["duration_ms"]
        assert outer_e["fields"] == {"stage": "live", "n": 2}

    def test_failed_span_records_fail_event(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_TRACE_FILE", str(tmp_path / "t.jsonl"))
        with pytest.raises(ValueError):
            with span(get_logger("t"), "doomed"):
                raise ValueError("nope")
        events = read_trace_file(str(tmp_path / "t.jsonl"))
        assert events[-1]["kind"] == "fail" and events[-1]["error"] == "nope"

    def test_recorder_inactive_without_env(self, monkeypatch):
        monkeypatch.delenv("FLEET_TRACE_FILE", raising=False)
        assert flight_recorder() is None
        with span(get_logger("t"), "quiet"):
            pass

    def test_reader_skips_torn_final_line(self, tmp_path):
        p = tmp_path / "t.jsonl"
        p.write_text('{"kind": "begin", "name": "a"}\n{"kind": "en')
        assert [e["kind"] for e in read_trace_file(str(p))] == ["begin"]

    def test_rotation_keeps_one_generation(self, tmp_path, monkeypatch):
        """FLEET_TRACE_MAX_MB rolls the file over between lines; the reader
        spans both generations."""
        path = tmp_path / "t.jsonl"
        monkeypatch.setenv("FLEET_TRACE_FILE", str(path))
        monkeypatch.setenv("FLEET_TRACE_MAX_MB", str(600 / 2**20))
        for i in range(12):
            with span(get_logger("t"), "op", i=i):
                pass
        assert (tmp_path / "t.jsonl.1").exists()
        events = read_trace_files(str(path))
        ends = [e["fields"]["i"] for e in events if e["kind"] == "end"]
        assert ends == sorted(ends) and ends[-1] == 11
        flight_recorder().close()


# --------------------------------------------------------------------------
# trace re-entry (the reference's tests/test_trace_reentry.py)
# --------------------------------------------------------------------------

class TestUseTrace:
    def test_adopts_explicit_id_and_restores(self):
        assert current_trace_id() == ""
        with use_trace("cafe0123feed4567") as tid:
            assert tid == "cafe0123feed4567" == current_trace_id()
        assert current_trace_id() == ""

    def test_keeps_active_trace_when_none_given(self):
        with use_trace("aaaa000011112222"):
            with use_trace() as inner:
                assert inner == "aaaa000011112222"
            assert current_trace_id() == "aaaa000011112222"

    def test_mints_fresh_id_outside_any_trace(self):
        with use_trace() as a:
            assert a and current_trace_id() == a
        with use_trace() as b:
            assert b and b != a
        assert current_trace_id() == ""

    def test_sequential_operations_cannot_leak_into_each_other(self):
        seen = []
        for _ in range(3):
            with use_trace() as tid:
                seen.append(tid)
        assert len(set(seen)) == 3 and current_trace_id() == ""


class TestExecutorHop:
    def test_plain_thread_does_not_inherit_the_trace(self):
        got = {}

        def worker():
            got["tid"], got["sid"] = current_trace_id(), current_span_id()

        with use_trace("feedbeef00000001"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert got == {"tid": "", "sid": ""}

    def test_run_in_executor_drops_context_reentry_restores(self):
        def worker(carried: str):
            before = current_trace_id()
            with use_trace(carried):
                during = current_trace_id()
            return before, during, current_trace_id()

        async def go():
            with use_trace() as tid:
                loop = asyncio.get_running_loop()
                with ThreadPoolExecutor(1) as pool:
                    return tid, await loop.run_in_executor(
                        pool, worker, current_trace_id())

        tid, (before, during, after) = asyncio.run(go())
        assert (before, during, after) == ("", tid, "")

    def test_hopped_spans_join_the_same_flight_recorder_trace(
            self, tmp_path, monkeypatch):
        trace_file = tmp_path / "hop.jsonl"
        monkeypatch.setenv("FLEET_TRACE_FILE", str(trace_file))

        def worker(carried: str) -> None:
            with use_trace(carried):
                with span(log, "agent.work") as s:
                    s["hop"] = 1

        async def go():
            with span(log, "cp.execute"):
                loop = asyncio.get_running_loop()
                with ThreadPoolExecutor(1) as pool:
                    await loop.run_in_executor(pool, worker,
                                               current_trace_id())

        asyncio.run(go())
        events = read_trace_file(str(trace_file))
        by_name: dict = {}
        for e in events:
            by_name.setdefault(e["name"], []).append(e)
        for name in ("cp.execute", "agent.work"):
            assert {e["kind"] for e in by_name[name]} == {"begin", "end"}
        assert len({e["trace"] for e in events}) == 1
        assert "parent" not in by_name["agent.work"][0]
        end = [e for e in by_name["agent.work"] if e["kind"] == "end"][0]
        assert end["fields"] == {"hop": 1}


class TestConcurrentFailureExtras:
    def test_fail_event_merges_fields_and_extras(self, tmp_path,
                                                 monkeypatch):
        trace_file = tmp_path / "fail.jsonl"
        monkeypatch.setenv("FLEET_TRACE_FILE", str(trace_file))
        with pytest.raises(RuntimeError, match="boom"):
            with span(log, "deploy.step", stage="prod") as s:
                s["placed"] = 7
                raise RuntimeError("boom")
        (fail,) = [e for e in read_trace_file(str(trace_file))
                   if e["kind"] == "fail"]
        assert fail["name"] == "deploy.step" and fail["error"] == "boom"
        assert fail["duration_ms"] >= 0
        assert fail["fields"] == {"stage": "prod", "placed": 7}

    def test_racing_failing_spans_keep_their_own_extras(self, tmp_path,
                                                        monkeypatch):
        trace_file = tmp_path / "race.jsonl"
        monkeypatch.setenv("FLEET_TRACE_FILE", str(trace_file))
        workers, rounds = 4, 25
        barrier = threading.Barrier(workers)

        def storm(who: int) -> None:
            tid = f"{who:016x}"
            barrier.wait()
            for i in range(rounds):
                with use_trace(tid):
                    try:
                        with span(log, "storm.op", who=who) as s:
                            s["round"] = i
                            raise ValueError(f"w{who}r{i}")
                    except ValueError:
                        pass

        threads = [threading.Thread(target=storm, args=(w,))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fails = [e for e in read_trace_file(str(trace_file))
                 if e["kind"] == "fail"]
        assert len(fails) == workers * rounds
        for e in fails:
            who = e["fields"]["who"]
            assert e["trace"] == f"{who:016x}"
            assert e["error"] == f"w{who}r{e['fields']['round']}"
        assert len({(e["fields"]["who"], e["fields"]["round"])
                    for e in fails}) == workers * rounds


# --------------------------------------------------------------------------
# profile_trace on torch.profiler
# --------------------------------------------------------------------------

def _chrome_names(path) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


class TestProfileTrace:
    def test_noop_without_env(self, monkeypatch):
        """Unset, the block runs with no profiler at all."""
        monkeypatch.delenv("FLEET_PROFILE_DIR", raising=False)

        def refuse(*a, **kw):
            raise AssertionError("torch.profiler.profile opened")
        monkeypatch.setattr(torch.profiler, "profile", refuse)
        with obs.profile_trace("x", lambda: refuse()):
            pass

    def test_writes_chrome_trace_when_enabled(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_PROFILE_DIR", str(tmp_path / "prof"))
        with obs.profile_trace("tiny", "cpu"):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        files = list((tmp_path / "prof").glob("tiny.*.pt.trace.json"))
        assert len(files) == 1
        assert "tiny" in _chrome_names(files[0])

    def test_solve_under_profile_dir(self, tmp_path, monkeypatch):
        """A cold solve writes one trace holding the solve range and the
        full path's fleet.refine range."""
        monkeypatch.setenv("FLEET_PROFILE_DIR", str(tmp_path))
        res = solve(synthetic_problem(60, 8, seed=1), device="cpu", steps=8)
        assert res.feasible
        (path,) = tmp_path.glob("solve.*.pt.trace.json")
        assert {"solve", api.REFINE_RANGE} <= _chrome_names(path)


# --------------------------------------------------------------------------
# the solver's lines and dispatch scope
# --------------------------------------------------------------------------

def test_solver_logs_solve_line():
    buf = capture("info")
    res = solve(synthetic_problem(16, 4, seed=0), device="cpu", chains=2,
                steps=8)
    assert res.feasible
    line = [ln for ln in buf.getvalue().splitlines()
            if "fleetflow.solver:" in ln][-1]
    assert "solve S=16 N=4" in line and "violations=0" in line
    assert "total_ms=" in line and "chains=2 steps=8" in line


def test_solve_line_not_built_in_library_mode(monkeypatch):
    """With INFO disabled (FLEET_LOG unset) the line's fields are never
    formatted."""
    configure("", force=True)

    def refuse(**fields):
        raise AssertionError("kv called")
    monkeypatch.setattr(api, "kv", refuse)
    assert not api.log.isEnabledFor(logging.INFO)
    assert solve(synthetic_problem(16, 4, seed=0), device="cpu",
                 steps=8).feasible


def test_fallback_logs_under_the_sched_logger():
    from fleetflow_tpu_torch.sched import (HostGreedyScheduler,
                                           place_with_fallback)
    from test_torch_seeds import tier_blocked
    buf = capture("info")
    pt = dataclasses.replace(tier_blocked(synthetic_problem(
        200, 24, seed=3, n_tenants=1)), relax_order=["tier"])
    _p, relaxed = place_with_fallback(HostGreedyScheduler(), pt)
    assert relaxed == ["tier"]
    assert ("fleetflow.sched: placement infeasible; relaxing what=tier "
            "order=tier") in buf.getvalue()


class _FakeCuda:
    """A device whose type reads "cuda", for the scope's allocator path."""
    type = "cuda"


def test_dispatch_scope_in_flight_and_range():
    gauge = REGISTRY.get("fleet_solver_dispatches_in_flight")
    start = gauge.value()
    with api._dispatch_scope(api.REFINE_RANGE, torch.device("cpu")):
        assert gauge.value() == start + 1
    with pytest.raises(RuntimeError):
        with api._dispatch_scope(api.SUBSOLVE_RANGE, torch.device("cpu")):
            raise RuntimeError("dispatch failed")
    assert gauge.value() == start


@pytest.mark.parametrize("flag", ["1", "", "0"])
def test_dispatch_scope_profiled_allocator_delta(flag, monkeypatch):
    """FLEET_PROFILE_SOLVER=1 on the card reads the allocator on either
    side and sets the delta; otherwise (and always on the CPU) nothing
    reads it and the gauge keeps its value."""
    reads = iter([1000, 4096])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: next(reads))
    monkeypatch.setenv("FLEET_PROFILE_SOLVER", flag)
    gauge = REGISTRY.get("fleet_solver_dispatch_device_delta_bytes")
    gauge.set(-7)
    with api._dispatch_scope(api.REFINE_RANGE, _FakeCuda()):
        pass
    assert gauge.value() == (3096 if flag == "1" else -7)
    with api._dispatch_scope(api.REFINE_RANGE, torch.device("cpu")):
        pass
    assert gauge.value() == (3096 if flag == "1" else -7)


def test_dispatch_scope_allocator_failure_raises(monkeypatch):
    def broken(dev=None):
        raise RuntimeError("allocator stats unavailable")
    monkeypatch.setattr(torch.cuda, "memory_allocated", broken)
    monkeypatch.setenv("FLEET_PROFILE_SOLVER", "1")
    with pytest.raises(RuntimeError, match="allocator"):
        with api._dispatch_scope(api.REFINE_RANGE, _FakeCuda()):
            pass
    assert REGISTRY.get("fleet_solver_dispatches_in_flight").value() == 0
