"""The port's streaming admission (fleetflow_tpu_torch.cp.admission) against
the reference's, driven directly on the CPU: a store of servers, a
PlacementService and an AdmissionController per package over the same KDL
text and the same submissions, on one fake clock, with no server or chaos
world.

- host parity: both packages on their host greedy path give, after every
  drain pass, equal step summaries (placed, departed, parked, batch) and
  status() counts, and at the end equal live_names, committed placements
  and servers.allocated: tenant fairness (deficit round robin, weights),
  shed and park backpressure, tombstone reuse (also carried through a
  churn re-solve), compaction at a tier edge, quota parks and the parked
  journal;
- the card scheduler (use_gpu=True, device="cpu"): the same scenarios'
  assertions with every committed placement at 0 violations by both
  packages' verify; a stream replayed micro-batched and as one batch to
  the same live set and to the reference device path's placements; and a
  steady state of resident delta merges with no cold restage;
- the spawned drain loop: a fault of the device path ends its task with
  that exception; any other failed pass is logged and the loop goes on.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

from fleetflow_tpu.core import model as ref_model
from fleetflow_tpu.core.parser import parse_kdl_string as ref_parse
from fleetflow_tpu.cp import admission as ref_admission
from fleetflow_tpu.cp import models as ref_models
from fleetflow_tpu.cp.placement import PlacementService as RefPlacement
from fleetflow_tpu.cp.store import Store as RefStore
from fleetflow_tpu.solver.repair import verify as ref_verify
from fleetflow_tpu_torch.core import model as port_model
from fleetflow_tpu_torch.core.errors import DeviceUnavailable, KernelError
from fleetflow_tpu_torch.core.parser import parse_kdl_string as port_parse
from fleetflow_tpu_torch.cp import admission as port_admission
from fleetflow_tpu_torch.cp import models as port_models
from fleetflow_tpu_torch.cp.placement import PlacementService
from fleetflow_tpu_torch.cp.store import Store
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.solver.repair import verify as port_verify

REF = SimpleNamespace(
    name="ref", Store=RefStore, models=ref_models, adm=ref_admission,
    model=ref_model,
    parse=ref_parse, service=lambda store: RefPlacement(store))
PORT_HOST = SimpleNamespace(
    name="port-host", Store=Store, models=port_models, adm=port_admission,
    model=port_model,
    parse=port_parse,
    service=lambda store: PlacementService(store, use_gpu=False))
PORT_GPU = SimpleNamespace(
    name="port-gpu", Store=Store, models=port_models, adm=port_admission,
    model=port_model,
    parse=port_parse,
    service=lambda store: PlacementService(store, device="cpu"))


class Clock:
    def __init__(self):
        self.t = 1000.0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _kdl(services: int, nodes: int, stages: int) -> str:
    """`services` simple services a stage over `nodes` servers; svc0010 of
    each stage publishes a host port, so it cannot stream out."""
    out = ['project "adm"']
    for j in range(nodes):
        out.append(f'server "node-{j}" {{ capacity {{ cpu 8; '
                   f'memory 16384; disk 99999 }} }}')
    for st in range(stages):
        for i in range(services):
            name = f"svc{i:04d}" if st == 0 else f"s{st}-{i:04d}"
            ports = (f" ports {{ port host={18000 + 100 * st + i} "
                     f"container=80 }}" if i == 10 else "")
            out.append(f'service "{name}" {{ image "app"; resources {{ '
                       f'cpu 0.25; memory {128 + 4 * i}; disk 1 }}'
                       f'{ports} }}')
    srv = " ".join(f'"node-{j}"' for j in range(nodes))
    for st in range(stages):
        out.append(f'stage "app{st}" {{')
        for i in range(services):
            name = f"svc{i:04d}" if st == 0 else f"s{st}-{i:04d}"
            out.append(f'    service "{name}"')
        out.append(f'    servers {srv}')
        out.append('    placement { strategy "spread_across_pool" }')
        out.append('}')
    return "\n".join(out)


class World:
    """One package's control plane: store, placement service, flow and
    the fake clock."""

    def __init__(self, pkg, services=20, nodes=4, stages=1):
        self.pkg = pkg
        self.clock = Clock()
        self.store = pkg.Store()
        for j in range(nodes):
            self.store.create("servers", pkg.models.Server(
                slug=f"node-{j}", status="online", tenant="default",
                capacity=pkg.models.ServerCapacity(cpu=8.0, memory=16384.0,
                                                   disk=99999.0)))
        self.placement = pkg.service(self.store)
        self.flow = pkg.parse(_kdl(services, nodes, stages))

    def ctrl(self, journal=None, **cfg):
        defaults = dict(batch_max=8, quantum=4.0, max_queue=64,
                        shed_age_s=0.0)
        defaults.update(cfg)
        return self.pkg.adm.AdmissionController(
            self.placement, clock=self.clock.now, store=journal,
            config=self.pkg.adm.AdmissionConfig(**defaults))


_TIMING = ("solve_ms", "phase_ms")
_STATUS = ("queue_depth", "oldest_age_s", "parked", "parked_quota",
           "tenants", "streams", "pressure", "stats", "config")


class Rec:
    """What a scenario observed, for the parity comparison."""

    def __init__(self, w: World, ctrl):
        self.w, self.ctrl = w, ctrl
        self.log: list = []

    def step(self):
        self.w.clock.advance(1.0)
        out = self.ctrl.step()
        self.log.append({k: v for k, v in out.items() if k not in _TIMING})
        self.check_committed()
        return out

    def drain(self, max_steps=200):
        outs = []
        for _ in range(max_steps):
            if not self.ctrl.has_work():
                break
            outs.append(self.step())
        assert not self.ctrl.has_work(), "drain did not converge"
        st = self.ctrl.status()
        self.log.append({k: st[k] for k in _STATUS})
        return outs

    def submit(self, tenant, **kw):
        out = self.ctrl.submit(tenant, **kw)
        self.log.append(dict(out))
        return out

    def check_committed(self):
        """Every retained feasible placement verifies at 0 violations by
        both packages' exact checker."""
        for key in self.w.placement.snapshot():
            pt, pl = self.w.placement.retained(key)
            if pl.feasible:
                for verify in (port_verify, ref_verify):
                    assert verify(pt, np.asarray(pl.raw))["total"] == 0

    def final(self) -> dict:
        pl = self.w.placement
        return {
            "live": {k: self.ctrl.live_names(k) for k in pl.snapshot()},
            "placements": {k: v["assignment"]
                           for k, v in pl.snapshot().items()},
            "committed": {k: dict(r.assignment)
                          for k, r in pl._committed.items()},
            "reservations": pl.reservations_snapshot(),
            "allocated": {s.slug: dataclasses.asdict(s.allocated)
                          for s in self.w.store.list("servers")},
            "requests": sorted((r.id, r.name, r.kind, r.state)
                               for r in self.ctrl.requests.values()),
            "log": self.log}


# --------------------------------------------------------------------------
# scenarios (the reference's tests/test_admission.py cases, on both
# packages)
# --------------------------------------------------------------------------

def sc_validation(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl())
    ctrl = rec.ctrl
    ctrl.attach(w.flow, "app0")
    Service, Port = pkg.model.Service, pkg.model.Port
    for bad, match in [
            (Service(name="x", ports=[Port(host=80, container=80)]),
             "ports"),
            (Service(name="x", depends_on=["svc0000"]), "depends_on"),
            (Service(name="x", replicas=2), "replicas"),
            (Service(name="x", anti_affinity=["x"]), "anti_affinity")]:
        with pytest.raises(ValueError, match=match):
            ctrl.submit("t0", arrivals=[bad])
    rec.submit("t0", arrivals=[{"name": "a1"}])
    with pytest.raises(ValueError, match="already live or queued"):
        ctrl.submit("t0", arrivals=[{"name": "a1"}])
    with pytest.raises(ValueError, match="no such live"):
        ctrl.submit("t0", departures=["nope"])
    with pytest.raises(ValueError, match="deploy.down"):
        ctrl.submit("t0", departures=["svc0010"])
    rec.drain()
    with pytest.raises(ValueError, match="already live"):
        ctrl.submit("t0", arrivals=[{"name": "a1"}])
    return rec


def sc_fairness_flood(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(batch_max=8, quantum=4.0, max_queue=512))
    rec.ctrl.attach(w.flow, "app0")
    rec.submit("flood", arrivals=[{"name": f"f{i}"} for i in range(40)])
    rec.submit("calm", arrivals=[{"name": "c0"}, {"name": "c1"}])
    out = rec.step()
    assert {"c0", "c1"} <= set(out["placed"])
    assert len([n for n in out["placed"] if n.startswith("f")]) <= 6
    rec.drain()
    waits = rec.ctrl.wait_samples
    assert max(waits["calm"]) <= min(max(waits["flood"]), 10.0)
    return rec


def sc_fairness_weights(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(batch_max=9, quantum=3.0, max_queue=512,
                        tenant_weights={"heavy": 2.0, "light": 1.0}))
    rec.ctrl.attach(w.flow, "app0")
    rec.submit("heavy", arrivals=[{"name": f"h{i}"} for i in range(20)])
    rec.submit("light", arrivals=[{"name": f"l{i}"} for i in range(20)])
    out = rec.step()
    h = len([n for n in out["placed"] if n.startswith("h")])
    li = len([n for n in out["placed"] if n.startswith("l")])
    assert h == 2 * li, (h, li)
    rec.drain()
    return rec


def sc_shed_depth(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(max_queue=4))
    rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": f"a{i}"} for i in range(4)])
    with pytest.raises(pkg.adm.AdmissionRejected) as ei:
        rec.ctrl.submit("t0", arrivals=[{"name": "a9"}])
    assert ei.value.retryable and ei.value.reason == "queue-depth"
    assert ei.value.retry_after_s > 0
    assert rec.ctrl.pressure()["queue_depth"] == 4
    rec.drain()
    assert all(r.state in pkg.adm.AdmissionRequest.TERMINAL
               for r in rec.ctrl.requests.values())
    return rec


def sc_park_on_full(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(max_queue=2, on_full="park"))
    key = rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": "a0"}, {"name": "a1"}])
    out = rec.submit("t0", arrivals=[{"name": "a2"}])
    assert out.get("parked") == 1
    rec.drain()
    assert rec.ctrl.live_names(key) == ["a0", "a1"]
    rec.submit("t0", departures=["a0"])
    rec.drain()
    assert rec.ctrl.stats["unparked"] == 1
    assert rec.ctrl.live_names(key) == ["a1", "a2"]
    return rec


def sc_shed_age(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(shed_age_s=5.0, batch_max=1))
    rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": f"a{i}"} for i in range(3)])
    w.clock.advance(10.0)
    out = rec.step()
    assert out["batch"] == 0 and rec.ctrl.stats["sheds"] == 3
    assert all(r.state == "shed" for r in rec.ctrl.requests.values())
    return rec


def sc_departures_bypass_depth(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(max_queue=3))
    key = rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": f"a{i}"} for i in range(3)])
    rec.drain()
    rec.submit("t0", arrivals=[{"name": f"b{i}"} for i in range(3)])
    with pytest.raises(pkg.adm.AdmissionRejected):
        rec.ctrl.submit("t0", arrivals=[{"name": "b9"}])
    out = rec.submit("t0", departures=["a0", "a1"])
    assert len(out["accepted"]) == 2
    rec.drain()
    assert sorted(rec.ctrl.live_names(key)) == ["a2", "b0", "b1", "b2"]
    return rec


def sc_infeasible_parks(pkg):
    w = World(pkg, services=6, nodes=2)
    rec = Rec(w, w.ctrl())
    key = rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": "whale", "cpu": 1e6,
                                "memory": 1e9}])
    out = rec.step()
    assert out["parked"] == ["whale"]
    assert rec.ctrl.pressure()["parked"] == 1
    assert "whale" not in rec.ctrl.live_names(key)
    req = next(r for r in rec.ctrl.requests.values() if r.name == "whale")
    rec.submit("t0", departures=["whale"])
    rec.drain()
    assert req.state == "cancelled"
    return rec


def sc_tombstone_reuse(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl())
    key = rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": "a0"}, {"name": "a1"}])
    rec.drain()
    rows = rec.ctrl.status()["streams"][key]["rows"]
    with pytest.raises(ValueError, match="already pending"):
        rec.ctrl.submit("t0", departures=["a0", "a0"])
    rec.submit("t0", departures=["a0"])
    with pytest.raises(ValueError, match="already pending"):
        rec.ctrl.submit("t1", departures=["a0"])
    rec.drain()
    st = rec.ctrl.status()["streams"][key]
    assert (st["tombstones"], st["free_rows"]) == (1, 1)
    rec.submit("t0", arrivals=[{"name": "a2"}])
    rec.drain()
    st = rec.ctrl.status()["streams"][key]
    # the arrival took the departed row: no growth, the tombstone gone
    assert (st["rows"], st["tombstones"], st["free_rows"]) == (rows, 0, 0)
    assert "a0" not in w.placement.snapshot()[key]["assignment"]
    return rec


def sc_tombstones_through_churn(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl())
    key = rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": f"a{i}"} for i in range(4)])
    rec.drain()
    rec.submit("t0", departures=["a0", "a1"])
    rec.drain()
    victim = sorted(set(w.placement.snapshot()[key]["assignment"]
                        .values()))[0]
    w.placement.node_events([(victim, False)])
    w.placement.node_events([(victim, True)])
    rows_before = rec.ctrl.status()["streams"][key]["rows"]
    rec.submit("t0", arrivals=[{"name": "fresh"}])
    rec.drain()
    st = rec.ctrl.status()["streams"][key]
    snap = w.placement.snapshot()[key]
    assert "a0" not in snap["assignment"] and "a1" not in snap["assignment"]
    assert "fresh" in snap["assignment"]
    assert st["rows"] == rows_before
    assert st["tombstones"] == 1 and st["free_rows"] == 1
    return rec


def sc_compaction(pkg):
    w = World(pkg)
    rec = Rec(w, w.ctrl(batch_max=128, max_queue=512))
    key = rec.ctrl.attach(w.flow, "app0")
    rec.submit("t0", arrivals=[{"name": f"a{i}"} for i in range(40)])
    rec.drain()
    rec.submit("t0", departures=[f"a{i}" for i in range(10)])
    rec.drain()
    assert rec.ctrl.status()["streams"][key]["tombstones"] == 10
    before = rec.ctrl.stats["compactions"]
    # 60 rows + 15 arrivals - 10 free rows crosses the 64-row tier
    rec.submit("t0", arrivals=[{"name": f"b{i}"} for i in range(15)])
    rec.drain()
    assert rec.ctrl.stats["compactions"] == before + 1
    assert rec.ctrl.status()["streams"][key]["tombstones"] == 0
    assert set(rec.ctrl.live_names(key)) == (
        {f"a{i}" for i in range(10, 40)} | {f"b{i}" for i in range(15)})
    return rec


def sc_quota_journal(pkg):
    w = World(pkg)
    journal = pkg.Store.connect_memory()
    rec = Rec(w, w.ctrl(journal=journal, tenant_caps={"acme": 2}))
    key = rec.ctrl.attach(w.flow, "app0")
    res = rec.submit("acme", arrivals=[{"name": f"q{i}", "cpu": 0.05,
                                        "memory": 8.0} for i in range(4)])
    assert res.get("quota_parked") == 2 and not res.get("shed")
    assert len(journal.list("admission_parked")) == 2
    rec.drain()
    st = rec.ctrl.status()
    assert st["tenants"]["acme"]["live"] == 2 and st["parked_quota"] == 2
    assert rec.ctrl.pressure()["drained"] is True
    # the failover: a new controller over the same journal
    rec.ctrl = w.ctrl(journal=journal, tenant_caps={"acme": 2})
    rec.ctrl.attach(w.flow, "app0")
    assert rec.ctrl.status()["stats"]["restored"] == 2
    out = rec.submit("beta", arrivals=[{"name": "b1", "cpu": 0.05,
                                        "memory": 8.0}])
    assert len(out["accepted"]) == 1
    rec.submit("acme", departures=["q0", "q1"])
    rec.drain()
    assert rec.ctrl.status()["parked_quota"] == 0
    assert len(journal.list("admission_parked")) == 0
    live = rec.ctrl.live_names(key)
    assert "q2" in live and "q3" in live
    return rec


SCENARIOS = [sc_validation, sc_fairness_flood, sc_fairness_weights,
             sc_shed_depth, sc_park_on_full, sc_shed_age,
             sc_departures_bypass_depth, sc_infeasible_parks,
             sc_tombstone_reuse, sc_tombstones_through_churn, sc_compaction,
             sc_quota_journal]
IDS = [s.__name__[3:] for s in SCENARIOS]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_host_parity(scenario):
    """Both packages' controllers on their host greedy path: every step
    summary, status() after every drain, live_names, the placements, the
    reservations, servers.allocated and every request's final state are
    equal."""
    ref, port = scenario(REF).final(), scenario(PORT_HOST).final()
    assert len(ref["log"]) == len(port["log"])
    for a, b in zip(ref["log"], port["log"]):
        assert a == b
    assert ref == port


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_card_scheduler(scenario):
    """The card scheduler's plain versions run every scenario to its
    assertions, each committed placement at 0 violations."""
    rec = scenario(PORT_GPU)
    rec.check_committed()
    for key, snap in rec.w.placement.snapshot().items():
        assert snap["source"] == "gpu-anneal", (key, snap["source"])


# --------------------------------------------------------------------------
# the replay property and the resident delta path, on the card scheduler
# --------------------------------------------------------------------------

def _gen_stream(seed: int, n: int):
    rng = random.Random(seed)
    events, live = [], []
    for i in range(n):
        if live and rng.random() < 0.35:
            events.append(("departure", live.pop(rng.randrange(len(live)))))
        else:
            spec = {"name": f"s{seed}-{i:03d}", "cpu": 0.01,
                    "memory": 16.0 + i * 0.125}
            events.append(("arrival", spec))
            live.append(spec["name"])
    return events


def _replay(pkg, seed: int, batch_max: int):
    w = World(pkg, services=16, nodes=4)
    rec = Rec(w, w.ctrl(batch_max=batch_max, max_queue=10_000))
    key = rec.ctrl.attach(w.flow, "app0")
    for kind, payload in _gen_stream(seed, 40):
        if kind == "arrival":
            rec.ctrl.submit("t0", arrivals=[payload])
        else:
            rec.ctrl.submit("t0", departures=[payload])
    rec.drain()
    return (dict(w.placement._committed[key].assignment),
            rec.ctrl.live_names(key))


@pytest.mark.parametrize("seed", range(4))
def test_replay_on_the_card_scheduler_equals_the_reference_device_path(
        seed, monkeypatch):
    """The card scheduler replays a stream, micro-batched by 4 and as one
    batch, to the same live set as the reference's TpuSolverScheduler and
    to its committed placement exactly, when the reference solves with the
    seed its solve() picks on an accelerator backend (the batched greedy:
    K4's counterpart). The bit-equal replay property of the reference's
    docstring holds only on its host path and on its CPU backend's native
    seed, which parks every phantom row on the first valid node: with the
    batched seed, rows that arrivals activate keep their spread phantom
    placement, and neither package's device path keeps the placement
    independent of the chunking."""
    import functools

    import fleetflow_tpu.solver as ref_solver
    monkeypatch.setattr(ref_solver, "solve", functools.partial(
        ref_solver.solve, seed_impl="batched"))
    ref_device = SimpleNamespace(**{**vars(REF), "service": lambda store:
                                    RefPlacement(store, use_tpu=True)})
    lives, ref_placements = set(), []
    for batch_max in (4, 10_000):
        got = _replay(PORT_GPU, seed, batch_max)
        ref = _replay(ref_device, seed, batch_max)
        assert got == ref
        lives.add(tuple(got[1]))
        ref_placements.append(ref[0])
    assert len(lives) == 1
    # the deviation is the reference's own: its device path commits a
    # different placement micro-batched by 4 than as one batch
    assert ref_placements[0] != ref_placements[1]


@pytest.mark.parametrize("seed", range(4))
def test_replay_property_on_the_host_path(seed):
    """The reference's replay property on the port's host path: a stream
    micro-batched by 4 commits the same final placement and live set as
    one batch, and both equal the reference's."""
    micro = _replay(PORT_HOST, seed, batch_max=4)
    batch = _replay(PORT_HOST, seed, batch_max=10_000)
    assert micro == batch
    assert micro == _replay(REF, seed, batch_max=4)


def test_steady_state_rides_the_resident_delta_path():
    """After warm-up (an arrival append, a departure tombstone, a row
    reuse), every admission micro-solve merges into the card scheduler's
    resident staging: no cold restage and no host transfer counted."""
    w = World(PORT_GPU, services=24, nodes=6)
    ctrl = w.ctrl(batch_max=16)
    key = ctrl.attach(w.flow, "app0")
    reuse = REGISTRY.get("fleet_solver_resident_reuse_total")
    xfer = REGISTRY.get("fleet_solver_host_transfers_total")
    ctrl.submit("t0", arrivals=[{"name": f"w{i}"} for i in range(3)])
    w.clock.advance(1.0)
    ctrl.step()
    ctrl.submit("t0", departures=["w0"])
    w.clock.advance(1.0)
    ctrl.step()
    ctrl.submit("t0", arrivals=[{"name": "w3"}])
    w.clock.advance(1.0)
    ctrl.step()
    cold0, delta0 = reuse.value(outcome="cold"), reuse.value(outcome="delta")
    xfer0 = xfer.value()
    for i in range(3):
        ctrl.submit("t0", arrivals=[{"name": f"s{i}"}],
                    departures=[f"w{i + 1}"])
        w.clock.advance(1.0)
        out = ctrl.step()
        assert out["violations"] == 0 and out["placed"] == [f"s{i}"]
    assert reuse.value(outcome="cold") == cold0
    assert reuse.value(outcome="delta") == delta0 + 3
    assert xfer.value() == xfer0
    assert sorted(ctrl.live_names(key)) == ["s0", "s1", "s2"]


# --------------------------------------------------------------------------
# the spawned drain loop
# --------------------------------------------------------------------------

class _Boom:
    """A card scheduler whose every solve raises `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def reschedule(self, pt, **kw):
        raise self.exc

    def place(self, pt, **kw):
        raise self.exc


def _spawned(ctrl, until, timeout_s=30.0):
    """Run `ctrl.spawn()` on a fresh event loop until `until()` holds or
    the task ends; stop the loop's task and return it."""
    async def main():
        ctrl.spawn()
        task = ctrl._task
        deadline = time.monotonic() + timeout_s
        while not task.done() and not until():
            assert time.monotonic() < deadline, "drain loop stalled"
            await asyncio.sleep(0.01)
        if not task.done():
            ctrl.stop()
        await asyncio.gather(task, return_exceptions=True)
        return task
    return asyncio.run(main())


@pytest.mark.parametrize("exc", [
    KernelError("k5_subsolve: CUDA error 700: an illegal memory access "
                "was encountered"),
    DeviceUnavailable("no CUDA")], ids=["kernel-error", "device-unavailable"])
def test_spawned_loop_ends_on_a_device_fault(exc):
    w = World(PORT_GPU, services=8, nodes=2)
    ctrl = w.ctrl(drain_interval_s=0.0)
    key = ctrl.attach(w.flow, "app0")
    ctrl.submit("t0", arrivals=[{"name": "x0"}])
    w.placement._sched_gpu = _Boom(exc)
    before = REGISTRY.get("fleet_placement_churn_fallbacks_total").value()
    task = _spawned(ctrl, until=lambda: False)
    assert not task.cancelled() and task.exception() is exc
    assert "x0" not in ctrl.live_names(key)
    assert REGISTRY.get(
        "fleet_placement_churn_fallbacks_total").value() == before


def test_spawned_loop_logs_other_failures_and_goes_on(caplog):
    w = World(PORT_GPU, services=8, nodes=2)
    ctrl = w.ctrl(drain_interval_s=0.0)
    key = ctrl.attach(w.flow, "app0")
    ctrl.submit("t0", arrivals=[{"name": "x0"}])
    step, calls = ctrl.step, []

    def flaky_step():
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("a pass failed")
        return step()

    ctrl.step = flaky_step
    task = _spawned(ctrl, until=lambda: not ctrl.has_work())
    assert task.cancelled()
    assert len(calls) >= 2 and ctrl.live_names(key) == ["x0"]
    assert "admission drain pass failed" in caplog.text
