"""The port's chaos world (fleetflow_tpu_torch.chaos: the runner, the
invariants, the injector, and the control-plane state it builds) against
the reference's (fleetflow_tpu.chaos), on the CPU.

- the host path: every hand-written scenario of the pack at seed 7 and
  60 services x 10 nodes x 2 stages, and `diurnal-hotspot` at its sizing
  (200 x 20 x 4), replayed by both packages, the port on `use_gpu=False`:
  the event logs are equal and so are the `ChaosReport.digest()`s, byte
  for byte (the other three world scenarios are `slow`, as the
  reference's full pack is);
- the card scheduler on the CPU (`device="cpu"`): `rolling-kill-selfheal`,
  `cp-failover`, `arrival-storm` and `tenant-storm` at the smoke size
  hold every invariant, go through the scheduler with no host fallback,
  and reproduce their own digest on a second run;
- the canaries: the reference's TestInvariantCanaries,
  TestDegradedGracefullyCanaries and TestHooks on the port's world, each
  invariant firing on its broken world;
- device faults: a `KernelError` raised from `solve_stage` ends
  `run_schedule` with that error and is not a `deploy-failed` event; one
  raised from a collector source propagates; a plain error still is a
  failed deploy;
- failover: each promotion builds a fresh placement service, and the dead
  primary's is freed (no more than one alive after each failover); the
  world restores the process's SLO engine and removes its store
  directory, also when the run fails.
"""

from __future__ import annotations

import asyncio
import functools
import gc
import json
import os
import weakref

import pytest
import torch

from fleetflow_tpu import chaos as ref_chaos
from fleetflow_tpu_torch import chaos
from fleetflow_tpu_torch.chaos import runner as chaos_runner
from fleetflow_tpu_torch.chaos.faults import FaultSchedule
from fleetflow_tpu_torch.chaos.invariants import (agents_gauge_consistent,
                                                  capacity_accounting,
                                                  containers_converged,
                                                  metrics_monotonic,
                                                  no_dead_assignments,
                                                  pools_at_min,
                                                  reservations_terminal,
                                                  solver_feasible)
from fleetflow_tpu_torch.chaos.runner import _Runner
from fleetflow_tpu_torch.core.errors import (ControlPlaneError,
                                             DeviceUnavailable, KernelError)
from fleetflow_tpu_torch.cp import placement as cp_placement
from fleetflow_tpu_torch.cp.models import ServerAllocated, WorkerPool
from fleetflow_tpu_torch.cp.store import Store
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.obs.slo import get_engine
from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler

SMOKE = dict(services=60, nodes=10, stages=2, pool_min=2)
WORLD = dict(services=200, nodes=20, stages=4, pool_min=2)
HAND_WRITTEN = [n for n in ref_chaos.scenario_names()
                if n not in ("diurnal-hotspot", "spot-storm", "zone-outage",
                             "production-week")]
CARD_CPU = ("rolling-kill-selfheal", "cp-failover", "arrival-storm",
            "tenant-storm")


def _sizing(name: str) -> dict:
    info = chaos.scenario_info(name)
    sz = {k: int(v) for k, v in (kv.split("=")
                                 for kv in info["sizing"].split())}
    return dict(sz, pool_min=2)


# --------------------------------------------------------------------------
# the host path: the reference's own world, digest for digest
# --------------------------------------------------------------------------

def _host_pair(name: str, size: dict):
    ref = ref_chaos.run_scenario(name, seed=7, **size)
    port = chaos.run_scenario(name, seed=7, use_gpu=False, **size)
    return ref, port


def _assert_same_world(ref, port):
    assert port.ok and ref.ok, port.violations
    assert port.events == ref.events
    assert port.digest() == ref.digest()
    assert port.stats == ref.stats
    assert port.slo["virtual"] == ref.slo["virtual"]


def test_hand_written_pack_is_eight():
    assert len(HAND_WRITTEN) == 8
    assert chaos.scenario_names() == ref_chaos.scenario_names()


@pytest.mark.parametrize("name", HAND_WRITTEN)
def test_host_path_digest_equal(name):
    _assert_same_world(*_host_pair(name, SMOKE))


def test_host_path_digest_equal_world_diurnal_hotspot():
    size = _sizing("diurnal-hotspot")
    assert size == WORLD
    _assert_same_world(*_host_pair("diurnal-hotspot", size))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["spot-storm", "zone-outage",
                                  "production-week"])
def test_host_path_digest_equal_world_slow(name):
    _assert_same_world(*_host_pair(name, _sizing(name)))


def test_host_path_builds_no_card_scheduler():
    runner = _Runner(FaultSchedule("host", 1, [], horizon=0.0), 20, 4, 1, 0,
                     use_gpu=False)
    assert runner.world.state.placement._sched_gpu is None
    assert runner.world.state.placement.solver_slots()["slots"] == []


def test_card_is_the_default_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = get_engine()
    with pytest.raises(DeviceUnavailable):
        chaos.run_scenario("rolling-kill", seed=7, **SMOKE)
    with pytest.raises(DeviceUnavailable):
        chaos.run_scenario("cp-failover", seed=7, **SMOKE)
    assert get_engine() is prev


# --------------------------------------------------------------------------
# the card scheduler on the CPU
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _card_runs(name: str):
    """Two runs of `name` at the smoke size on the card scheduler's plain
    versions, with the scheduler's place calls and the churn fallbacks
    counted over both."""
    calls = []
    place = GpuSolverScheduler.place

    def counted(self, pt, **kw):
        calls.append((pt.S, pt.N))
        return place(self, pt, **kw)

    fallbacks = REGISTRY.get("fleet_placement_churn_fallbacks_total")
    fb0 = fallbacks.value()
    GpuSolverScheduler.place = counted
    try:
        runs = [chaos.run_scenario(name, seed=7, device="cpu", **SMOKE)
                for _ in range(2)]
    finally:
        GpuSolverScheduler.place = place
    return runs, len(calls), fallbacks.value() - fb0


@pytest.mark.parametrize("name", CARD_CPU)
def test_card_scheduler_holds_invariants(name):
    (a, _b), solves, fallbacks = _card_runs(name)
    assert a.ok, a.violations
    assert solves > 0
    assert fallbacks == 0


@pytest.mark.parametrize("name", CARD_CPU)
def test_card_scheduler_reproduces_digest(name):
    (a, b), _solves, _fb = _card_runs(name)
    assert a.events == b.events
    assert a.digest() == b.digest()


def test_card_scheduler_scenarios_do_their_work():
    """The reference's smoke expectations, on the card scheduler."""
    (r, _), _, _ = _card_runs("rolling-kill-selfheal")
    events = {e["event"] for e in r.events}
    assert r.stats["heals"] > 0
    assert {"heal-dead", "heal-redeliver", "heal-online"} <= events
    (r, _), _, _ = _card_runs("cp-failover")
    assert r.stats["failovers"] == 3 and r.stats["heals"] > 0
    events = {e["event"] for e in r.events}
    assert {"cp-failover", "cp-resumed", "standby-attached",
            "fencing-rejected"} <= events
    assert [e["epoch"] for e in r.events
            if e["event"] == "cp-failover"] == [2, 3, 4]
    (r, _), _, _ = _card_runs("arrival-storm")
    assert r.stats["admissions"] > 50
    assert {"admit", "admit-batch"} <= {e["event"] for e in r.events}
    (r, _), _, _ = _card_runs("tenant-storm")
    assert r.stats["admissions"] > 30 and r.stats["failovers"] == 1


# --------------------------------------------------------------------------
# failover frees the dead primary's scheduler; the world cleans up
# --------------------------------------------------------------------------

def test_failover_frees_the_dead_primary(monkeypatch):
    made: list = []
    alive_after: list = []

    class Tracked(cp_placement.PlacementService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(weakref.ref(self))

    failover = chaos.ChaosWorld.cp_failover

    async def tracked_failover(self, phase):
        await failover(self, phase)
        gc.collect()
        alive_after.append(sum(r() is not None for r in made))

    dirs = []
    tmp = chaos_runner.tempfile.TemporaryDirectory

    def recording(*a, **kw):
        d = tmp(*a, **kw)
        dirs.append(d.name)
        return d

    monkeypatch.setattr(chaos_runner, "PlacementService", Tracked)
    monkeypatch.setattr(chaos.ChaosWorld, "cp_failover", tracked_failover)
    monkeypatch.setattr(chaos_runner.tempfile, "TemporaryDirectory",
                        recording)
    prev = get_engine()
    r = chaos.run_scenario("cp-failover", seed=7, device="cpu", **SMOKE)
    assert r.ok, r.violations
    assert len(made) == 4                     # the primary + 3 promotions
    assert alive_after == [1, 1, 1]           # only the serving state's
    gc.collect()
    assert all(ref() is None for ref in made)
    assert get_engine() is prev
    assert len(dirs) == 1 and not os.path.exists(dirs[0])


# --------------------------------------------------------------------------
# device faults end the run
# --------------------------------------------------------------------------

def _failing_solve(monkeypatch, exc, after: int):
    solve = cp_placement.PlacementService.solve_stage
    calls = [0]

    def failing(self, *a, **kw):
        calls[0] += 1
        if calls[0] > after:
            raise exc
        return solve(self, *a, **kw)
    monkeypatch.setattr(cp_placement.PlacementService, "solve_stage",
                        failing)
    return calls


@pytest.mark.parametrize("after", [0, 2])
def test_kernel_error_from_solve_stage_ends_the_run(monkeypatch, after):
    """At the first stage deploy, and at a later one: the run ends with
    the KernelError, no deploy is counted or logged as failed."""
    calls = _failing_solve(monkeypatch,
                           KernelError("k4_greedy did not launch"), after)
    prev = get_engine()
    with pytest.raises(KernelError, match="k4_greedy"):
        chaos.run_scenario("rolling-kill", seed=7, device="cpu", **SMOKE)
    assert calls[0] == after + 1
    assert get_engine() is prev


def test_kernel_error_is_not_a_deploy_failed_event(monkeypatch):
    _failing_solve(monkeypatch, KernelError("k3_rebuild did not launch"), 1)
    schedule = chaos.build_schedule("rolling-kill", 7, SMOKE["services"],
                                    SMOKE["nodes"])
    runner = _Runner(schedule, SMOKE["services"], SMOKE["nodes"],
                     SMOKE["stages"], SMOKE["pool_min"], device="cpu")
    with pytest.raises(KernelError):
        asyncio.run(runner.run())
    events = [e["event"] for e in runner.world.events]
    assert "deploy-failed" not in events
    assert runner.stats["deploys_failed"] == 0
    assert events.count("deploy-ok") == 1


def test_plain_solve_error_still_is_a_failed_deploy(monkeypatch):
    _failing_solve(monkeypatch, ValueError("no capacity"), 1)
    schedule = chaos.build_schedule("rolling-kill", 7, SMOKE["services"],
                                    SMOKE["nodes"])
    runner = _Runner(schedule, SMOKE["services"], SMOKE["nodes"],
                     SMOKE["stages"], SMOKE["pool_min"], device="cpu")

    async def deploy_both():
        runner._bootstrap()
        return [await runner._deploy(st)
                for st in sorted(runner.world.flow.stages)]
    assert asyncio.run(deploy_both()) == [True, False]
    failed = [e for e in runner.world.events
              if e["event"] == "deploy-failed"]
    assert len(failed) == 1 and "no capacity" in failed[0]["error"]
    assert runner.stats["deploys_failed"] == 1


def test_kernel_error_from_collector_source_propagates(monkeypatch):
    def broken(self):
        raise KernelError("slot census: k3_rebuild did not launch")
    monkeypatch.setattr(cp_placement.PlacementService, "solver_slots",
                        broken)
    prev = get_engine()
    with pytest.raises(KernelError, match="slot census"):
        chaos.run_scenario("rolling-kill", seed=7, device="cpu", **SMOKE)
    assert get_engine() is prev


def test_plain_collector_failure_is_skipped(monkeypatch):
    """A source failing for any other reason is logged and skipped, as in
    the reference: the run goes on and its digest is unchanged."""
    base = chaos.run_scenario("rolling-kill", seed=7, use_gpu=False,
                              **SMOKE)

    def broken(self):
        raise RuntimeError("slot census unavailable")
    monkeypatch.setattr(cp_placement.PlacementService, "solver_slots",
                        broken)
    r = chaos.run_scenario("rolling-kill", seed=7, use_gpu=False, **SMOKE)
    assert r.ok and r.digest() == base.digest()


# --------------------------------------------------------------------------
# canaries: every checker proven live against a broken world
# --------------------------------------------------------------------------

def _world(services=20, nodes=4, stages=1, pool_min=0, deploy=True):
    """A small, settled chaos world with no faults applied, placing on
    the card scheduler's plain versions."""
    runner = _Runner(FaultSchedule("canary", 1, [], horizon=0.0),
                     services, nodes, stages, pool_min, device="cpu")

    async def go():
        runner._bootstrap()
        if deploy:
            for st in sorted(runner.world.flow.stages):
                assert await runner._deploy(st)
    asyncio.run(go())
    return runner.world


class TestInvariantCanaries:
    def test_capacity_accounting_fires_on_double_booking(self):
        w = _world()
        assert capacity_accounting(w) == []
        s = w.state.store.list("servers")[0]
        w.state.store.update("servers", s.id, allocated=ServerAllocated(
            cpu=s.capacity.cpu * 2, memory=1.0, disk=0.0))
        found = capacity_accounting(w)
        assert found and "double-booked" in found[0]

    def test_reservations_terminal_fires_on_leaked_reservation(self):
        w = _world()
        assert reservations_terminal(w) == []
        _pl, rid = w.state.placement.solve_stage(w.flow, "app0")
        assert rid is not None
        found = reservations_terminal(w)
        assert found and "still in flight" in found[0]

    def test_no_dead_assignments_fires_on_offline_node(self):
        w = _world()
        assert no_dead_assignments(w) == []
        key = w.stage_keys[0]
        node = sorted(w.state.placement.snapshot()[key]
                      ["assignment"].values())[0]
        s = w.state.store.server_by_slug(node)
        w.state.store.update("servers", s.id, status="offline")
        found = no_dead_assignments(w)
        assert found and "dead node" in found[0]

    def test_pools_at_min_fires_on_starved_pool(self):
        w = _world(deploy=False)
        assert pools_at_min(w) == []
        w.state.store.create("worker_pools", WorkerPool(
            tenant="default", name="starved", min_servers=1,
            preferred_labels={"provider": "sim"}))
        found = pools_at_min(w)
        assert found and "below floor" in found[0]

    def test_solver_feasible_fires_on_corrupt_assignment(self):
        w = _world()
        assert solver_feasible(w) == []
        _pt, placement = w.state.placement.retained(w.stage_keys[0])
        assert placement.raw is not None
        placement.raw[:] = 0
        found = solver_feasible(w)
        assert found and "solver checker" in found[0]

    def test_containers_converged_fires_on_exited_container(self):
        w = _world()
        assert containers_converged(w) == []
        key = w.stage_keys[0]
        view = w.state.placement.snapshot()[key]
        row, node = sorted(view["assignment"].items())[0]
        backend = w.backends[node]
        name = sorted(n for n in backend.containers
                      if backend.containers[n].running)[0]
        backend.set_state(name, "exited")
        found = containers_converged(w)
        assert found and "exited" in found[0]

    def test_selfheal_converged_fires_on_unparked_dead_assignment(self):
        from fleetflow_tpu_torch.chaos.invariants import selfheal_converged
        from fleetflow_tpu_torch.cp.reconverge import _Work
        w = _world()
        assert selfheal_converged(w) == []
        key = w.stage_keys[0]
        node = sorted(w.state.placement.snapshot()[key]
                      ["assignment"].values())[0]
        s = w.state.store.server_by_slug(node)
        w.state.store.update("servers", s.id, status="offline")
        found = selfheal_converged(w)
        assert found and "not parked" in found[0]
        w.state.reconverger._park(
            _Work(stage_key=key, idempotency_key="k", trace_id="t"),
            "infeasible")
        assert all(key not in v for v in selfheal_converged(w))

    def test_selfheal_converged_fires_on_leftover_redelivery_debt(self):
        from fleetflow_tpu_torch.chaos.invariants import selfheal_converged
        w = _world()
        assert selfheal_converged(w) == []
        w.state.reconverger._enqueue("chaosfleet/app0", "tr")
        found = selfheal_converged(w)
        assert found and "redelivery debt" in found[0]

    def test_cp_failover_converged_fires_on_lost_debt(self):
        from fleetflow_tpu_torch.chaos.invariants import cp_failover_converged
        w = _world()
        assert cp_failover_converged(w) == []
        w.cp_failovers = 1
        w.fencing_rejections = 1
        w.state.store._epoch = 2
        assert cp_failover_converged(w) == []
        w.prekill_work.add(("chaosfleet/ghost", False))
        found = cp_failover_converged(w)
        assert found and "lost across failover" in found[0]

    def test_cp_failover_converged_fires_on_double_execution(self):
        from fleetflow_tpu_torch.chaos.invariants import cp_failover_converged
        w = _world()
        w.cp_failovers = 1
        w.fencing_rejections = 1
        w.state.store._epoch = 2
        w.idem_executions["heal-k1@node000"] = ["app0", 2]
        found = cp_failover_converged(w)
        assert found and "idempotency window lost" in found[0]

    def test_cp_failover_converged_fires_on_unfenced_zombie(self):
        from fleetflow_tpu_torch.chaos.invariants import cp_failover_converged
        w = _world()
        w.cp_failovers = 2
        w.fencing_rejections = 1
        w.state.store._epoch = 3
        found = cp_failover_converged(w)
        assert found and "wrote through the fence" in found[0]

    def test_cp_failover_converged_fires_on_epoch_drift(self):
        from fleetflow_tpu_torch.chaos.invariants import cp_failover_converged
        w = _world()
        w.cp_failovers = 2
        w.fencing_rejections = 2
        w.state.store._epoch = 2
        found = cp_failover_converged(w)
        assert found and "epoch" in found[0]

    def test_metrics_monotonic_fires_on_counter_decrease(self):
        w = _world()
        assert metrics_monotonic(w) == []
        assert metrics_monotonic(w) == []
        c = REGISTRY.get("fleet_store_ops_total")
        key = next(k for k in c._children if c._children[k][0] > 0)
        c._children[key][0] -= 1.0
        try:
            found = metrics_monotonic(w)
            assert found and "decreased" in found[0]
        finally:
            c._children[key][0] += 1.0

    def test_agents_gauge_consistent_fires_on_drift(self):
        w = _world()
        assert agents_gauge_consistent(w) == []
        g = REGISTRY.get("fleet_agents_connected")
        real = g.value()
        g.set(real + 3)
        try:
            found = agents_gauge_consistent(w)
            assert found and "registry holds" in found[0]
        finally:
            g.set(real)

    def test_admission_fair_fires_on_starved_tenant(self):
        from collections import deque

        from fleetflow_tpu_torch.chaos.invariants import admission_fair
        w = _world()
        assert admission_fair(w) == []
        ctrl = w.state.admission
        ctrl.wait_samples = {"calm": deque([5.0] * 50),
                             "starved": deque([900.0] * 50)}
        found = admission_fair(w)
        assert found and "starved" in found[0]
        w.admission_burst_tenants = {"starved"}
        assert admission_fair(w) == []

    def test_admission_converged_fires_on_stuck_request(self):
        from fleetflow_tpu_torch.chaos.invariants import admission_converged
        w = _world()
        ctrl = w.state.admission
        assert admission_converged(w) == []
        ctrl.attach(w.flow, "app0")
        ctrl.submit("t0", arrivals=[{"name": "stuck-svc"}])
        found = admission_converged(w)
        assert found and "still 'queued'" in found[0]
        w.clock.advance(1.0)
        ctrl.step()
        assert admission_converged(w) == []

    def test_slo_met_fires_on_missed_objective(self):
        from fleetflow_tpu_torch.chaos.invariants import slo_met
        w = _world()
        assert slo_met(w) == []
        w.state.slo.observe("heal_s", 1e6)
        found = slo_met(w)
        assert found and "heal-p99-s" in found[0]
        assert "1000000" in found[0] or "1e+06" in found[0]

    def test_slo_met_ignores_worlds_without_engine(self):
        from fleetflow_tpu_torch.chaos.invariants import slo_met
        w = _world()
        w.state.slo = None
        assert slo_met(w) == []

    def test_admission_converged_fires_on_unplaced_live_service(self):
        from fleetflow_tpu_torch.chaos.invariants import admission_converged
        w = _world()
        ctrl = w.state.admission
        key = ctrl.attach(w.flow, "app0")
        ctrl.submit("t0", arrivals=[{"name": "real-svc"}])
        w.clock.advance(1.0)
        ctrl.step()
        assert admission_converged(w) == []
        ctrl._streams[key].streamed["ghost-svc"] = 999
        found = admission_converged(w)
        assert found and "missing from the settled placement" in found[0]


class TestDegradedGracefullyCanaries:
    def _zoned(self, home="r-a"):
        w = _world()
        w.zone_outages = 1
        w.stage_region = {k: home for k in w.stage_keys}
        return w

    def test_vacuous_without_an_outage(self):
        from fleetflow_tpu_torch.chaos.invariants import degraded_gracefully
        w = _world()
        assert degraded_gracefully(w) == []

    def test_census_flags_surviving_region_parked_stage(self):
        from fleetflow_tpu_torch.chaos.invariants import (
            degraded_gracefully, record_outage_census)
        from fleetflow_tpu_torch.cp.reconverge import _Work
        w = self._zoned(home="r-a")
        w.active_outages = {"r-b"}
        w.state.reconverger._park(
            _Work(stage_key=w.stage_keys[0], idempotency_key="k",
                  trace_id="t"), "infeasible")
        record_outage_census(w)
        assert w.outage_breaches
        assert "parked during outage" in w.outage_breaches[0]
        record_outage_census(w)
        assert len(w.outage_breaches) == 1
        w.active_outages.clear()
        found = degraded_gracefully(w)
        assert any("parked during outage" in v for v in found)
        assert any("still parked after" in v for v in found)

    def test_lost_domains_own_work_may_park(self):
        from fleetflow_tpu_torch.chaos.invariants import record_outage_census
        from fleetflow_tpu_torch.cp.reconverge import _Work
        w = self._zoned(home="r-b")
        w.active_outages = {"r-b"}
        w.state.reconverger._park(
            _Work(stage_key=w.stage_keys[0], idempotency_key="k",
                  trace_id="t"), "infeasible")
        record_outage_census(w)
        assert w.outage_breaches == []

    def test_fires_on_doubled_execution_across_revival(self):
        from fleetflow_tpu_torch.chaos.invariants import degraded_gracefully
        w = self._zoned()
        w.idem_executions["heal-k1@node000"] = ["app0", 2]
        found = degraded_gracefully(w)
        assert found and "ran 2 times" in found[0]

    def test_registered_as_final_invariant(self):
        from fleetflow_tpu_torch.chaos.invariants import FINAL_INVARIANTS
        assert "degraded-gracefully" in FINAL_INVARIANTS
        assert sorted(FINAL_INVARIANTS) == sorted(
            ref_chaos.FINAL_INVARIANTS)
        assert sorted(chaos.INSTANT_INVARIANTS) == sorted(
            ref_chaos.INSTANT_INVARIANTS)


class TestHooks:
    def test_store_observer_sees_mutations(self):
        from fleetflow_tpu_torch.cp.models import Tenant
        db = Store()
        seen = []
        db.subscribe(lambda op, table, payload: seen.append((op, table)))
        t = db.create("tenants", Tenant(name="a"))
        db.update("tenants", t.id, display_name="A")
        db.delete("tenants", t.id)
        assert seen == [("put", "tenants"), ("put", "tenants"),
                        ("del", "tenants")]
        db.unsubscribe(seen.append)

    def test_registry_delivery_hook_can_refuse(self):
        from fleetflow_tpu_torch.cp.agent_registry import AgentRegistry

        class Conn:
            _closed = False

            async def send_event(self, channel, method, payload):
                raise AssertionError("hook must fire before the send")

        async def go():
            reg = AgentRegistry()
            reg.register("n1", Conn())

            def hook(slug, command):
                raise ControlPlaneError(f"refused {slug}/{command}")
            reg.delivery_hook = hook
            with pytest.raises(ControlPlaneError, match="refused n1/ping"):
                await reg.send_command("n1", "ping", {})
        asyncio.run(go())

    def test_engine_fault_hook_fails_service(self):
        from fleetflow_tpu_torch.core.model import Flow, Service, Stage
        from fleetflow_tpu_torch.runtime.backend import (BackendError,
                                                         MockBackend)
        from fleetflow_tpu_torch.runtime.engine import (DeployEngine,
                                                        DeployRequest)
        flow = Flow(name="p", services={"a": Service(name="a", image="i",
                                                     version="1")},
                    stages={"s": Stage(name="s", services=["a"])})

        def hook(step, row):
            raise BackendError(f"injected {step} {row}")
        engine = DeployEngine(MockBackend(auto_pull=True), fault_hook=hook,
                              sleep=lambda s: None)
        res = engine.execute(DeployRequest(flow=flow, stage_name="s"))
        assert res.failed == {"a": "injected start a"}

    def test_injector_hooks_fire(self):
        """The injector's partition, slowness and armed deploy failures
        land through the registry and engine hooks."""
        from fleetflow_tpu_torch.chaos import FaultInjector
        from fleetflow_tpu_torch.runtime.backend import BackendError
        fired = []
        inj = FaultInjector(on_fire=lambda kind, target: fired.append(
            (kind, target)))
        inj.partition("n1")
        with pytest.raises(ControlPlaneError, match="partition"):
            inj.delivery_hook("n1", "deploy.execute")
        inj.heal_partition("n1")
        inj.delivery_hook("n1", "deploy.execute")
        inj.arm_deploy_fail(1)
        with pytest.raises(BackendError):
            inj.engine_hook("n2")("start", "svc")
        inj.engine_hook("n2")("start", "svc")
        inj.slow_agent("n3", 700.0)
        with pytest.raises(ControlPlaneError, match="timed out"):
            inj.delivery_hook("n3", "deploy.execute")
        inj.slow_agent("n3", 5.0)
        inj.delivery_hook("n3", "deploy.execute")
        assert fired == [("partition", "n1"), ("deploy-fail", "n2/svc"),
                         ("slow-timeout", "n3"), ("slow", "n3")]
        assert inj.fired == fired


# --------------------------------------------------------------------------
# chip_smoke's [world] phase, rehearsed on the CPU
# --------------------------------------------------------------------------

@pytest.fixture
def world_rehearsal(monkeypatch):
    """chip_smoke's [world] on the CPU: no sync to make, no card memory to
    read, and the plain versions launch no kernel to count."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "cp_expect_launches",
                        lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda torch, _ext, tag, path, off=(), size=None:
                        dict(_ext.LAUNCHES))
    return chip_smoke


RUNS = [("rolling-kill-selfheal", dict(services=60, nodes=10, stages=2)),
        ("cp-failover", dict(services=60, nodes=10, stages=2)),
        ("rolling-kill-selfheal", dict(services=60, nodes=10, stages=2))]


def test_world_phase_rehearsal(world_rehearsal, capsys):
    from fleetflow_tpu_torch import _ext
    smoke = world_rehearsal
    assert [n for n, _ in [(n, smoke.world_sizing(chaos, n))
                           for n in chaos.scenario_names()]] == \
        chaos.scenario_names()
    assert smoke.world_sizing(chaos, "zone-outage") == dict(
        services=200, nodes=21, stages=4)
    place = GpuSolverScheduler.place
    smoke.run_world_phase(torch, _ext, REGISTRY, "CARD", device="cpu",
                          runs=RUNS)
    assert GpuSolverScheduler.place is place
    lines = [json.loads(ln.split(" ", 1)[1])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[world] {")]
    runs = [ln for ln in lines if "scenario" in ln]
    assert [r["scenario"] for r in runs] == [n for n, _ in RUNS]
    assert all(r["ok"] and r["solves"] > 0 and r["fallbacks"] == 0
               for r in runs)
    assert runs[0]["digest"] == runs[2]["digest"]
    assert runs[1]["failovers"] == 3
    (mem,) = [ln for ln in lines if "memory_after" in ln]
    assert mem["memory_after"] == 0
    (budget,) = [ln for ln in lines if "budget_s" in ln]
    assert budget["budget_s"] == 300.0 and budget["runs"] == 3


def test_world_phase_fails_on_a_violation(world_rehearsal, monkeypatch):
    from fleetflow_tpu_torch import _ext
    monkeypatch.setitem(chaos_runner.CHAOS_SLOS, "placement-p99-ms", 1e-6)
    with pytest.raises(AssertionError, match="slo-met"):
        world_rehearsal.run_world_phase(torch, _ext, REGISTRY, "CARD",
                                        device="cpu", runs=RUNS[:1])


def test_world_phase_fails_on_differing_digests(world_rehearsal,
                                                monkeypatch):
    from fleetflow_tpu_torch import _ext
    run = chaos.run_scenario
    seeds = iter((7, 8, 9))

    def drifting(name, **kw):
        kw["seed"] = next(seeds)
        return run(name, **kw)
    monkeypatch.setattr(chaos, "run_scenario", drifting)
    with pytest.raises(AssertionError, match="digests differ"):
        world_rehearsal.run_world_phase(torch, _ext, REGISTRY, "CARD",
                                        device="cpu", runs=RUNS)
