"""The port's control plane (fleetflow_tpu_torch.cp) against the reference's
(fleetflow_tpu.cp), on the CPU.

- the store: every case of the reference's TestStore run on both packages'
  Store, and each package's snapshot and journal read back by the other's
  to equal records;
- exact host parity: both PlacementServices on their host greedy path
  (the reference's default, the port's use_gpu=False) over the same store
  contents and KDL text give equal placements, reservation snapshots and
  servers.allocated after every step of every TestAdmissionDuringChurn
  case, and equal explain reports;
- the card scheduler (use_gpu=True, device="cpu": the same scheduler's
  plain PyTorch versions) held to the contract on the same cases: every
  feasible placement has 0 violations by both packages' verify, no server
  is double-booked across stages, and a churn re-solve moves only the
  displaced services;
- the degrade path: a solver failure degrades to the host greedy and is
  counted (the reference's TestChurnSolverFallback), a fault of the device
  path (KernelError, DeviceUnavailable) propagates uncounted, and the
  default PlacementService is the card's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fleetflow_tpu.core import model as ref_model
from fleetflow_tpu.core.parser import parse_kdl_string as ref_parse
from fleetflow_tpu.cp import models as ref_models
from fleetflow_tpu.cp.placement import PlacementService as RefPlacement
from fleetflow_tpu.cp.store import Store as RefStore
from fleetflow_tpu.obs.metrics import REGISTRY as REF_REGISTRY
from fleetflow_tpu.solver.repair import verify as ref_verify
from fleetflow_tpu_torch import _ext
from fleetflow_tpu_torch.core import model as port_model
from fleetflow_tpu_torch.core.errors import (DeviceUnavailable, KernelError,
                                             SolverError)
from fleetflow_tpu_torch.core.parser import parse_kdl_string as port_parse
from fleetflow_tpu_torch.cp import models as port_models
from fleetflow_tpu_torch.cp.placement import PlacementService
from fleetflow_tpu_torch.cp.store import Store
from fleetflow_tpu_torch.device import resolve_device
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.sched import relax_problem
from fleetflow_tpu_torch.solver.repair import verify as port_verify

# the three ways a case is run: the reference on its default host path,
# the port asking for its host path, and the port's card scheduler on the
# CPU
REF = SimpleNamespace(
    name="ref", Store=RefStore, models=ref_models, model=ref_model,
    parse=ref_parse, registry=REF_REGISTRY,
    service=lambda store: RefPlacement(store))
PORT_HOST = SimpleNamespace(
    name="port-host", Store=Store, models=port_models, model=port_model,
    parse=port_parse, registry=REGISTRY,
    service=lambda store: PlacementService(store, use_gpu=False))
PORT_GPU = SimpleNamespace(
    name="port-gpu", Store=Store, models=port_models, model=port_model,
    parse=port_parse, registry=REGISTRY,
    service=lambda store: PlacementService(store, device="cpu"))


def _churn_entry(svc):
    """(object, attribute) of the call a churn re-solve makes: the card
    scheduler's reschedule, or the host greedy's place."""
    if getattr(svc, "use_gpu", False):
        return svc._sched_gpu, "reschedule"
    return svc._sched_host, "place"


# --------------------------------------------------------------------------
# the store (test_cp.py::TestStore, both packages)
# --------------------------------------------------------------------------

STORES = [pytest.param(REF, id="ref"), pytest.param(PORT_HOST, id="port")]


class TestStore:
    @pytest.mark.parametrize("pkg", STORES)
    def test_persistence_roundtrip(self, pkg, tmp_path):
        path = str(tmp_path / "cp.json")
        db = pkg.Store(path)
        db.ensure_tenant("acme")
        db.register_server("n1", hostname="host1")
        db.upsert_alert("n1", "web", "unhealthy", "boom")
        db2 = pkg.Store(path)
        assert db2.tenant_by_name("acme") is not None
        assert db2.server_by_slug("n1").hostname == "host1"
        assert len(db2.active_alerts()) == 1

    @pytest.mark.parametrize("pkg", STORES)
    def test_observed_replacement(self, pkg):
        Obs = pkg.models.ObservedContainer
        db = pkg.Store.connect_memory()
        db.replace_observed("n1", [Obs(name="a"), Obs(name="b")])
        db.replace_observed("n1", [Obs(name="c")])
        assert [o.name for o in db.observed_on("n1")] == ["c"]

    @pytest.mark.parametrize("pkg", STORES)
    def test_heartbeats_do_not_rewrite_database(self, pkg, tmp_path):
        path = str(tmp_path / "cp.json")
        db = pkg.Store(path)
        with db.batch():
            for i in range(1000):
                db.register_server(f"n{i}", hostname=f"host{i}")
        db.flush()
        base = db.journal_stats()
        snap_before = (tmp_path / "cp.json").stat().st_mtime_ns
        for i in range(1000):
            db.heartbeat(f"n{i}")
        st = db.journal_stats()
        assert st["compactions"] == base["compactions"]
        assert st["entries"] - base["entries"] == 1000
        assert (st["bytes"] - base["bytes"]) / 1000 < 2048
        assert (tmp_path / "cp.json").stat().st_mtime_ns == snap_before
        db2 = pkg.Store(path)
        assert db2.server_by_slug("n999").status == "online"
        assert db2.server_by_slug("n0").last_heartbeat > 0

    @pytest.mark.parametrize("pkg", STORES)
    def test_journal_compaction_bounds_size(self, pkg, tmp_path):
        path = str(tmp_path / "cp.json")
        db = pkg.Store(path, journal_max_entries=100)
        for i in range(350):
            db.register_server(f"s{i % 7}", hostname=f"h{i}")
        st = db.journal_stats()
        assert st["compactions"] >= 3
        assert st["entries"] < 100
        assert pkg.Store(path).server_by_slug("s6").hostname == "h349"

    @pytest.mark.parametrize("pkg", STORES)
    def test_torn_journal_tail_is_dropped(self, pkg, tmp_path):
        path = str(tmp_path / "cp.json")
        db = pkg.Store(path)
        db.ensure_tenant("acme")
        db.register_server("n1", hostname="h1")
        with open(str(tmp_path / "cp.json.journal"), "a") as f:
            f.write('{"op": "put", "t": "servers", "r": {"id": "tr')
        db2 = pkg.Store(path)
        assert db2.server_by_slug("n1").hostname == "h1"
        assert db2.tenant_by_name("acme") is not None

    @pytest.mark.parametrize("pkg", STORES)
    def test_delete_survives_restart(self, pkg, tmp_path):
        path = str(tmp_path / "cp.json")
        db = pkg.Store(path)
        s = db.register_server("gone", hostname="h")
        db.register_server("kept", hostname="h2")
        db.delete("servers", s.id)
        db2 = pkg.Store(path)
        assert db2.server_by_slug("gone") is None
        assert db2.server_by_slug("kept") is not None

    @pytest.mark.parametrize("pkg", STORES)
    def test_fsync_knob_env_and_kwarg(self, pkg, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_STORE_FSYNC", "1")
        db = pkg.Store(str(tmp_path / "cp.json"))
        assert db._fsync is True
        db.register_server("n1", hostname="h1")
        db.flush()
        monkeypatch.setenv("FLEET_STORE_FSYNC", "0")
        assert pkg.Store(str(tmp_path / "cp.json"))._fsync is False
        assert pkg.Store(str(tmp_path / "b.json"), fsync=True)._fsync is True

    @pytest.mark.parametrize("pkg", STORES)
    def test_crash_between_snapshot_and_truncate(self, pkg, tmp_path):
        path = str(tmp_path / "cp.json")
        journal = tmp_path / "cp.json.journal"
        db = pkg.Store(path, fsync=True)
        s = db.register_server("dead", hostname="h0")
        db.register_server("live", hostname="h1")
        db.heartbeat("live")
        db.delete("servers", s.id)
        stale = journal.read_bytes()
        db.flush()
        journal.write_bytes(stale)
        db2 = pkg.Store(path)
        assert db2.server_by_slug("dead") is None
        assert db2.server_by_slug("live").hostname == "h1"
        assert db2.server_by_slug("live").last_heartbeat > 0
        assert pkg.Store(path).journal_stats()["entries"] == 0


def _fill(pkg, db) -> None:
    """The same mutations through either package's store, on its clock."""
    m = pkg.models
    db.ensure_tenant("acme")
    s = db.register_server("n1", hostname="h1", status="online",
                           capacity=m.ServerCapacity(cpu=8.0))
    db.register_server("n2", hostname="h2")
    db.heartbeat("n2", version="1.2")
    db.update("servers", s.id, labels=m.ServerLabelsRec(tier="premium",
                                                        clazz="gpu"))
    db.upsert_alert("n1", "web", "unhealthy", "boom")
    db.resolve_alert("n1", "web", "unhealthy")
    db.create("placements", m.PlacementRecord(
        stage_key="p/live", assignment={"web": "n1"},
        demand_by_node={"n1": [0.5, 64.0, 1.0]}))
    db.create("admission_parked", m.ParkedArrival(
        id="adm_7", tenant="acme", name="q0", stage_key="p/live", seq=7,
        reason="quota", spec={"name": "q0", "cpu": 0.05}))
    gone = db.register_server("n3", hostname="h3")
    db.delete("servers", gone.id)


def _tables(db) -> dict:
    doc = db.snapshot_doc()
    return {t: sorted(json.dumps(r, sort_keys=True) for r in rows)
            for t, rows in doc.items() if t != "_meta"}


@pytest.mark.parametrize("writer,reader", [(PORT_HOST, REF),
                                           (REF, PORT_HOST)],
                         ids=["port-to-ref", "ref-to-port"])
@pytest.mark.parametrize("compact", [False, True],
                         ids=["journal", "snapshot"])
def test_store_files_read_by_the_other_package(writer, reader, compact,
                                                tmp_path):
    """The port's store writes the reference's journal lines and snapshot
    document: each package reads what the other wrote to equal records,
    sequence number and epoch."""
    path = str(tmp_path / "cp.json")
    db = writer.Store(path)
    _fill(writer, db)
    db.bump_epoch()
    if compact:
        db.flush()
    want = _tables(db)
    got = reader.Store(path)
    assert _tables(got) == want
    assert (got.seq, got.epoch) == (db.seq, db.epoch) == (db.seq, 2)
    assert got.server_by_slug("n1").labels.clazz == "gpu"


def test_store_families_count_like_the_reference():
    """The store's metric families move on the port's registry as the
    reference's move on its own, for the same mutations."""
    names = ("fleet_store_ops_total", "fleet_heartbeats_total",
             "fleet_store_compactions_total")

    def counts(reg):
        return {k: v for k, v in reg.counter_values().items()
                if k.split("{")[0] in names}

    moved = []
    for pkg in (REF, PORT_HOST):
        before = counts(pkg.registry)
        db = pkg.Store.connect_memory()
        _fill(pkg, db)
        db.flush()
        after = counts(pkg.registry)
        moved.append({k: v - before.get(k, 0.0) for k, v in after.items()
                      if v != before.get(k, 0.0)})
    assert moved[0] == moved[1] and moved[1]


# --------------------------------------------------------------------------
# TestAdmissionDuringChurn, as scenarios run on each package
# --------------------------------------------------------------------------

CAP = {"cpu": 4.0, "memory": 8192.0, "disk": 99999.0}


def _svc_kdl(name, cpu):
    return (f'service "{name}" {{ image "x"; '
            f'resources {{ cpu {cpu}; memory 64; disk 1 }} }}')


def _flow(pkg, project, services, servers=("n0", "n1", "n2")):
    servers_kdl = "\n".join(
        f'server "{s}" {{ capacity {{ cpu 4; memory 8192; '
        f'disk 99999 }} }}' for s in servers)
    svc_kdl = "\n".join(_svc_kdl(n, c) for n, c in services)
    names = "\n".join(f'    service "{n}"' for n, _ in services)
    srv = " ".join(f'"{s}"' for s in servers)
    return pkg.parse(f"""
project "{project}"
{servers_kdl}
{svc_kdl}
stage "live" {{
{names}
    servers {srv}
    placement {{ strategy "spread_across_pool" }}
}}
""")


class Run:
    """One scenario on one package: its store and placement service, and
    the record of every step the parity test compares."""

    def __init__(self, pkg, caps=None):
        self.pkg = pkg
        self.store = pkg.Store()
        m = pkg.models
        for slug, cap in (caps or {s: CAP for s in ("n0", "n1", "n2")}
                          ).items():
            self.store.create("servers", m.Server(
                slug=slug, status="online", tenant="default",
                capacity=m.ServerCapacity(**cap)))
        self.svc = pkg.service(self.store)
        self.steps: list = []
        self.placements: list = []      # (stage, pt, placement) solved

    def flow(self, project, services, servers=("n0", "n1", "n2")):
        return _flow(self.pkg, project, services, servers)

    def note(self, label, placement=None, **extra):
        rec = {"step": label, **extra,
               "reservations": self.svc.reservations_snapshot(),
               "allocated": {s.slug: dataclasses.asdict(s.allocated)
                             for s in self.store.list("servers")}}
        if placement is not None:
            rec["placement"] = {
                "assignment": dict(placement.assignment),
                "feasible": placement.feasible,
                "violations": placement.violations,
                "source": placement.source,
                "levels": placement.levels,
                "raw": [int(x) for x in np.asarray(placement.raw)]}
        self.steps.append(rec)

    def solve(self, flow, reserve=True):
        pl, rid = self.svc.solve_stage(flow, "live", reserve=reserve)
        self.keep(f"{flow.name}/live", pl)
        self.note(f"solve {flow.name}", pl, rid=rid)
        return pl, rid

    def commit(self, rid):
        ok = self.svc.commit(rid)
        self.note(f"commit {rid}", ok=ok)
        return ok

    def events(self, events):
        before = {k: dict(self.svc.retained(k)[1].assignment)
                  for k in self.svc.snapshot()}
        moved = self.svc.node_events(events)
        for key, pl in moved:
            self.keep(key, pl)
            self.note(f"events {key}", pl)
        self.check_moves(before, dict(moved), events)
        return dict(moved)

    def keep(self, key, pl=None):
        """Keep a stage's placement with the problem it was solved on (a
        copy of its node planes: a later churn burst flips the retained
        problem's validity in place)."""
        pt, last = self.svc.retained(key)
        assert pl is None or pl is last
        self.placements.append((key, dataclasses.replace(
            pt, node_valid=pt.node_valid.copy(),
            capacity=pt.capacity.copy()), last))

    # -- the card scheduler's contract ------------------------------------

    def check_moves(self, before, moved, events):
        """On the card scheduler a churn re-solve moves only the services
        the burst displaced (the host greedy re-places from scratch)."""
        if self.pkg is not PORT_GPU:
            return
        dead = {slug for slug, online in events if not online}
        for key, pl in moved.items():
            if not pl.feasible or "relaxed" in pl.source:
                continue
            for name, node in before[key].items():
                if before[key][name] not in dead:
                    assert pl.assignment[name] == node, (key, name)

    def check_contract(self):
        """Every feasible placement verifies at 0 violations by both
        packages' exact checker; the latest feasible placement of every
        stage and the store's booked capacity fit every server."""
        for key, pt, pl in self.placements:
            if not pl.feasible:
                continue
            # a relaxed placement is checked against the problem it was
            # solved on: the retained one relaxed as its source says
            if "+relaxed:" in pl.source:
                for what in pl.source.split("+relaxed:")[1].split(","):
                    pt = relax_problem(pt, what)
            for verify in (port_verify, ref_verify):
                assert verify(pt, np.asarray(pl.raw))["total"] == 0, key
        cap = {s.slug: np.array([s.capacity.cpu, s.capacity.memory,
                                 s.capacity.disk])
               for s in self.store.list("servers")}
        load = {slug: np.zeros(3) for slug in cap}
        for key, (pt, pl) in ((k, self.svc.retained(k))
                              for k in self.svc.snapshot()):
            if not pl.feasible:
                continue
            for i, j in enumerate(np.asarray(pl.raw)):
                load[pt.node_names[int(j)]] += pt.demand[i]
        booked = {s.slug: np.array([s.allocated.cpu, s.allocated.memory,
                                    s.allocated.disk])
                  for s in self.store.list("servers")}
        for r in self.svc.reservations_snapshot()["in_flight"]:
            for slug, d in r["demand_by_node"].items():
                booked[slug] = booked[slug] + np.asarray(d)
        for slug in cap:
            assert (load[slug] <= cap[slug] + 1e-6).all(), (slug, load)
            assert (booked[slug] <= cap[slug] + 1e-3).all(), (slug, booked)


def case_churn_resolve_sees_capacity_committed_after_admission(pkg):
    run = Run(pkg)
    pl_a, rid_a = run.solve(run.flow("a", [("a0", 1.0), ("a1", 1.0)]))
    assert pl_a.feasible and run.commit(rid_a)
    pl_b, rid_b = run.solve(run.flow("b", [("b0", 3.5)]))
    assert pl_b.feasible and run.commit(rid_b)
    b_node = pl_b.assignment["b0"]
    assert b_node not in set(pl_a.assignment.values())
    victim = pl_a.assignment["a1"]
    moved = run.events([(victim, False)])
    new_a = moved["a/live"]
    assert new_a.feasible and new_a.assignment["a1"] != victim
    load = {s: 0.0 for s in ("n0", "n1", "n2")}
    for s, node in new_a.assignment.items():
        load[node] += {"a0": 1.0, "a1": 1.0}[s]
    load[b_node] += 3.5
    assert all(v <= CAP["cpu"] + 1e-9 for v in load.values()), load
    return run


def case_relaxation_preserved_through_churn_with_live_capacity(pkg):
    run = Run(pkg)
    flow = pkg.parse("""
project "c"
server "n0" { capacity { cpu 4; memory 8192; disk 99999 }
              labels { tier "standard" } }
server "n1" { capacity { cpu 4; memory 8192; disk 99999 }
              labels { tier "standard" } }
server "n2" { capacity { cpu 4; memory 8192; disk 99999 }
              labels { tier "standard" } }
service "c0" { image "x"; resources { cpu 1; memory 64; disk 1 } }
service "c1" { image "x"; resources { cpu 1; memory 64; disk 1 } }
stage "live" {
    service "c0"
    service "c1"
    servers "n0" "n1" "n2"
    placement { tier "premium"; fallback "tier" }
}
""")
    pl, rid = run.solve(flow)
    assert pl.feasible and "relaxed:tier" in pl.source
    assert run.commit(rid)
    victim = pl.assignment["c1"]
    new = run.events([(victim, False)])["c/live"]
    assert new.feasible and new.assignment["c1"] != victim
    assert "relaxed:tier" in new.source
    return run


def case_admission_racing_burst_lands_on_final_world(pkg):
    run = Run(pkg)
    svc = run.svc
    flow_a = run.flow("a", [("a0", 1.0), ("a1", 1.0)])
    pl_a, rid_a = run.solve(flow_a)
    assert pl_a.feasible and run.commit(rid_a)
    victim = pl_a.assignment["a1"]
    obj, attr = _churn_entry(svc)
    real = getattr(obj, attr)
    entered = threading.Event()

    def slow(pt, **kw):
        entered.set()
        time.sleep(0.3)
        return real(pt, **kw)

    setattr(obj, attr, slow)
    burst = threading.Thread(
        target=lambda: svc.node_events([(victim, False)]))
    burst.start()
    assert entered.wait(5)
    pl_d, rid_d = run.solve(run.flow("d", [("d0", 1.0)]))
    burst.join(5)
    setattr(obj, attr, real)
    run.keep("a/live")
    assert pl_d.feasible and pl_d.assignment["d0"] != victim
    assert run.commit(rid_d)
    committed: dict = {}
    for r in svc._committed.values():
        for slug, dem in r.demand_by_node.items():
            committed[slug] = committed.get(slug, 0.0) + float(dem[0])
    assert all(c <= CAP["cpu"] + 1e-9 for c in committed.values())
    return run


def _two_nodes(cpu=8.0):
    return {s: dict(cpu=cpu, memory=8192.0, disk=99999.0)
            for s in ("n0", "n1")}


def case_own_inflight_reservation_not_double_counted(pkg):
    run = Run(pkg, _two_nodes(8.0))
    pl, rid = run.solve(run.flow("a", [("a0", 3.0), ("a1", 3.0)],
                                 servers=("n0", "n1")))
    assert pl.feasible and rid is not None
    victim = pl.assignment["a0"]
    survivor = "n1" if victim == "n0" else "n0"
    new = run.events([(victim, False)])["a/live"]
    assert new.feasible, new.source
    assert set(new.assignment.values()) == {survivor}
    return run


def case_burst_displaced_stages_see_each_other(pkg):
    run = Run(pkg, {slug: dict(cpu=cpu, memory=8192.0, disk=99999.0)
                    for slug, cpu in (("n0", 4.0), ("n1", 5.0),
                                      ("n2", 4.0))})
    pl_a, rid_a = run.solve(run.flow("a", [("a0", 3.0)]))
    assert pl_a.feasible and run.commit(rid_a)
    pl_b, rid_b = run.solve(run.flow("b", [("b0", 3.0)]))
    assert pl_b.feasible and run.commit(rid_b)
    na, nb = pl_a.assignment["a0"], pl_b.assignment["b0"]
    assert na != nb
    survivor = ({"n0", "n1", "n2"} - {na, nb}).pop()
    moved = run.events([(na, False), (nb, False)])
    placed = [moved[k].assignment[s] for k, s in (("a/live", "a0"),
                                                  ("b/live", "b0"))
              if moved[k].feasible]
    assert placed.count(survivor) <= 1, moved
    assert sum(moved[k].feasible for k in ("a/live", "b/live")) == 1
    return run


def case_admission_after_burst_respects_churn_reservation(pkg):
    run = Run(pkg, _two_nodes(4.0))
    flow_a = run.flow("a", [("a0", 3.0)], servers=("n0", "n1"))
    pl_a, rid_a = run.solve(flow_a)
    assert pl_a.feasible and run.commit(rid_a)
    victim = pl_a.assignment["a0"]
    survivor = "n1" if victim == "n0" else "n0"
    moved = run.events([(victim, False)])
    assert moved["a/live"].feasible
    assert moved["a/live"].assignment["a0"] == survivor
    pl_d, _ = run.solve(run.flow("d", [("d0", 3.0)], servers=("n0", "n1")))
    assert not pl_d.feasible, pl_d.assignment
    pl_a2, rid_a2 = run.solve(flow_a)
    assert pl_a2.feasible and pl_a2.assignment["a0"] == survivor
    assert run.commit(rid_a2)
    assert not any(r.churn for r in run.svc._reservations.values())
    pl_e, _ = run.solve(run.flow("e", [("e0", 1.0)], servers=("n0", "n1")))
    assert pl_e.feasible and pl_e.assignment["e0"] == survivor
    return run


def case_preview_solve_keeps_churn_hold(pkg):
    run = Run(pkg, _two_nodes(4.0))
    flow_a = run.flow("a", [("a0", 3.0)], servers=("n0", "n1"))
    pl_a, rid_a = run.solve(flow_a)
    assert pl_a.feasible and run.commit(rid_a)
    victim = pl_a.assignment["a0"]
    assert run.events([(victim, False)])["a/live"].feasible
    prev, rid = run.solve(flow_a, reserve=False)
    assert prev.feasible and rid is None
    pl_d, _ = run.solve(run.flow("d", [("d0", 3.0)], servers=("n0", "n1")))
    assert not pl_d.feasible, pl_d.assignment
    return run


def case_churn_delta_subtracts_own_inflight_reservation(pkg):
    run = Run(pkg, _two_nodes(8.0))
    pl_a, rid_a = run.solve(run.flow("a", [("a0", 3.0), ("a1", 3.0)],
                                     servers=("n0", "n1")))
    assert pl_a.feasible and rid_a is not None
    victim = pl_a.assignment["a0"]
    survivor = "n1" if victim == "n0" else "n0"
    moved = run.events([(victim, False)])
    assert moved["a/live"].feasible
    assert set(moved["a/live"].assignment.values()) == {survivor}
    pl_e, _ = run.solve(run.flow("e", [("e0", 2.0)], servers=("n0", "n1")))
    assert pl_e.feasible and pl_e.assignment["e0"] == survivor
    return run


CASES = [case_churn_resolve_sees_capacity_committed_after_admission,
         case_relaxation_preserved_through_churn_with_live_capacity,
         case_admission_racing_burst_lands_on_final_world,
         case_own_inflight_reservation_not_double_counted,
         case_burst_displaced_stages_see_each_other,
         case_admission_after_burst_respects_churn_reservation,
         case_preview_solve_keeps_churn_hold,
         case_churn_delta_subtracts_own_inflight_reservation]
CASE_IDS = [c.__name__[len("case_"):] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_admission_during_churn_host_parity(case):
    """Both packages on their host greedy path: every step's placement,
    reservation snapshot and servers.allocated equal."""
    ref, port = case(REF), case(PORT_HOST)
    assert len(ref.steps) == len(port.steps)
    for a, b in zip(ref.steps, port.steps):
        assert a == b, a["step"]
    port.check_contract()


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_admission_during_churn_card_scheduler(case):
    """The card scheduler's plain versions on the same cases: the
    reference's assertions, 0 violations, no double booking, and only the
    displaced services move."""
    run = case(PORT_GPU)
    run.check_contract()
    assert {pl.source for _k, _pt, pl in run.placements} <= {
        "gpu-anneal", "gpu-anneal+relaxed:tier"}


# --------------------------------------------------------------------------
# explain (test_explain.py::TestPlacementServiceExplain)
# --------------------------------------------------------------------------

def _shop(pkg):
    servers = "\n".join(
        f'server "{s}" {{ capacity {{ cpu 4; memory 8192; '
        f'disk 99999 }} }}' for s in ("n0", "n1", "n2"))
    return pkg.parse(f"""
project "shop"
{servers}
service "db" {{ image "postgres"; resources {{ cpu 1; memory 256; disk 1 }} }}
service "api" {{ image "api"; depends_on "db"; resources {{ cpu 1; memory 128; disk 1 }} }}
stage "live" {{
    service "db"
    service "api"
    servers "n0" "n1" "n2"
    placement {{ strategy "spread_across_pool" }}
}}
""")


@pytest.mark.parametrize("pkg", [PORT_HOST, PORT_GPU], ids=lambda p: p.name)
def test_explain_after_solve(pkg):
    run, ref = Run(pkg), Run(REF)
    pl, _rid = run.svc.solve_stage(_shop(pkg), "live")
    assert pl.feasible
    out = run.svc.explain("shop/live", "api")
    assert out["stage"] == "shop/live"
    assert out["chosen"]["node"] == pl.assignment["api"]
    assert out["chosen"]["feasible"]
    assert out["blocked_counts"]["total_nodes"] == 3
    if pkg is PORT_HOST:
        ref.svc.solve_stage(_shop(REF), "live")
        assert out == ref.svc.explain("shop/live", "api")
    else:
        assert out["source"] == "gpu-anneal"


@pytest.mark.parametrize("pkg", [REF, PORT_HOST], ids=lambda p: p.name)
def test_explain_unknown_stage_and_service(pkg):
    svc = Run(pkg).svc
    with pytest.raises(KeyError):
        svc.explain("nope/live", "api")
    svc.solve_stage(_shop(pkg), "live")
    with pytest.raises(KeyError):
        svc.explain("shop/live", "ghost")


# --------------------------------------------------------------------------
# the degrade path (test_selfheal.py::TestChurnSolverFallback) and the
# device path's own faults
# --------------------------------------------------------------------------

def _fallbacks() -> float:
    return REGISTRY.get("fleet_placement_churn_fallbacks_total").value()


def _web_stage(device="cpu"):
    db = Store()
    for slug in ("n1", "n2"):
        s = db.register_server(slug, hostname=slug)
        db.update("servers", s.id, capacity=type(s.capacity)(
            cpu=8.0, memory=8192.0, disk=40960.0), status="online")
    ps = PlacementService(db, device=device)
    flow = port_model.Flow(name="p")
    flow.services["web"] = port_model.Service(
        name="web", image="i", version="1",
        resources=port_model.ResourceSpec(cpu=0.5, memory=64.0))
    flow.stages["main"] = port_model.Stage(name="main", services=["web"],
                                           servers=["n1", "n2"])
    pl, rid = ps.solve_stage(flow, "main")
    assert pl.feasible and ps.commit(rid)
    return ps, pl


class _Boom:
    """A card scheduler whose every solve raises `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def reschedule(self, pt, **kw):
        raise self.exc

    def place(self, pt, **kw):
        raise self.exc


# the device path's own faults, each of which the degrade handlers
# re-raise uncounted; "wrapped" is the host placer's SolverError raised
# from a KernelError (a failed g++ build)
DEVICE_FAULTS = [KernelError("k2_prerepair: CUDA error 700: an illegal "
                             "memory access was encountered"),
                 DeviceUnavailable("no CUDA"), "wrapped"]
DEVICE_FAULT_IDS = ["kernel-error", "device-unavailable", "wrapped"]
if hasattr(torch, "AcceleratorError"):
    DEVICE_FAULTS.append(torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"))
    DEVICE_FAULT_IDS.append("accelerator-error")
if hasattr(torch, "OutOfMemoryError"):
    DEVICE_FAULTS.append(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    DEVICE_FAULT_IDS.append("out-of-memory")


class TestChurnSolverFallback:
    def test_node_events_falls_back_to_host_greedy(self):
        ps, pl = _web_stage()
        before = _fallbacks()
        victim = pl.assignment["web"]
        ps._sched_gpu = _Boom(RuntimeError("solver exploded"))
        moved = ps.node_event(victim, online=False)
        assert moved
        _key, new = moved[0]
        assert new.feasible and new.assignment["web"] != victim
        assert new.source == "host-greedy"
        assert _fallbacks() == before + 1

    @pytest.mark.parametrize("exc", DEVICE_FAULTS, ids=DEVICE_FAULT_IDS)
    @pytest.mark.parametrize("entry", ["node_events", "admit_batch"])
    def test_device_faults_propagate_uncounted(self, exc, entry):
        ps, pl = _web_stage()
        if exc == "wrapped":
            try:
                try:
                    raise KernelError("build failed")
                except KernelError as e:
                    raise SolverError("the host placer is not "
                                      "available") from e
            except SolverError as e:
                exc = e
        before = _fallbacks()
        ps._sched_gpu = _Boom(exc)
        with pytest.raises(type(exc)):
            if entry == "node_events":
                ps.node_events([(pl.assignment["web"], False)])
            else:
                pt, _ = ps.retained("p/main")
                ps.admit_batch("p/main", pt)
        assert _fallbacks() == before

    def test_admit_batch_degrades_on_a_solver_failure(self):
        ps, _pl = _web_stage()
        before = _fallbacks()
        ps._sched_gpu = _Boom(SolverError("infeasible tensors"))
        pt, _ = ps.retained("p/main")
        new, rid, _pt = ps.admit_batch("p/main", pt)
        assert new.feasible and rid is not None
        assert new.source == "host-greedy"
        assert _fallbacks() == before + 1


class TestDevice:
    def test_default_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceUnavailable):
            PlacementService(Store())
        ps = PlacementService(Store(), use_gpu=False)
        assert ps._sched_gpu is None and ps.solver_slots()["slots"] == []

    def test_resolve_device_raises_device_unavailable(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceUnavailable):
            resolve_device()
        with pytest.raises(SolverError):
            resolve_device("cuda")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_card_scheduler_slots(self):
        ps, _pl = _web_stage()
        slots = ps.solver_slots()
        assert [s["stage"] for s in slots["slots"]] == ["p/main"]


class TestKernelErrors:
    """Every raise site of the build-and-launch layer raises KernelError,
    a RuntimeError."""

    def test_no_nvcc(self, monkeypatch):
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_ext.shutil, "which", lambda name: None)
        with pytest.raises(KernelError, match="nvcc not found"):
            _ext._nvcc()

    def test_no_cxx(self, monkeypatch):
        monkeypatch.setattr(_ext.shutil, "which", lambda name: None)
        with pytest.raises(KernelError, match="g\\+\\+ not found"):
            _ext._cxx()

    def test_failed_build(self, tmp_path):
        with pytest.raises(KernelError, match="build failed"):
            _ext._compile({"libx.so": ["false"]}, tmp_path, verbose=False)

    def test_failed_host_load(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_ext, "_host_dir", lambda: tmp_path)
        monkeypatch.setitem(_ext.HOST_LIBS, "fflost", ("host/placer.cpp",))
        (tmp_path / "libfflost.so").write_text("not a library")
        with pytest.raises(KernelError, match="host library fflost"):
            _ext.host_library("fflost")

    def test_no_python_headers(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_ext.sysconfig, "get_paths",
                            lambda: {"include": str(tmp_path)})
        with pytest.raises(KernelError, match="Python.h not found"):
            _ext._python_include()

    def test_failed_extension_import(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_ext, "_host_dir", lambda: tmp_path)
        monkeypatch.setitem(_ext.HOST_EXTS, "fflostpy",
                            ("host/kdlpy.cpp",))
        suffix = _ext.sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        (tmp_path / f"fflostpy{suffix}").write_text("not a module")
        with pytest.raises(KernelError, match="host extension fflostpy"):
            _ext.host_extension("fflostpy")

    def test_failed_kernel_load(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_ext, "_libs", {})
        monkeypatch.setattr(_ext, "_kernel_dir", lambda: tmp_path)
        monkeypatch.setattr(_ext, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_ext, "_compile", lambda *a, **kw: None)
        for name in _ext.KERNELS:
            (tmp_path / f"lib{name}.so").write_text("not a library")
        with pytest.raises(KernelError, match="kernel library"):
            _ext.build()

    def test_cuda_error_after_launch(self, monkeypatch):
        class Lib:
            @staticmethod
            def ff_error_string(err):
                return b"an illegal memory access was encountered"

        monkeypatch.setattr(_ext, "library", lambda name: Lib)
        with pytest.raises(KernelError, match="CUDA error 700"):
            _ext.raise_on("k1_sweep", 700)
        assert issubclass(KernelError, RuntimeError)
        assert issubclass(DeviceUnavailable, SolverError)
