"""The port's worker-pool autoscaler (fleetflow_tpu_torch.cp.autoscaler)
against the reference's (fleetflow_tpu.cp.autoscaler), on the CPU.

Every FakeProvider case of tests/test_autoscaler.py (scale up to min, the
max cap, idle scale-down newest first after the grace, busy workers never
reaped, a provider failure rolling its record back, the pressure table,
sustained pressure holding the idle surplus, pressure capped by max, an
offline corpse reaped and replaced under the cap, a list failure
deferring scale-down) run on each package's AppState (its store on one
fake clock, the host placement path, a FakeProvider of its own
ServerProvider): equal ScaleActions, plans, pool records and provider
calls sweep for sweep, and the reference's expectations hold on the port.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

_MODS = dict(autoscaler="cp.autoscaler", server="cp.server",
             store="cp.store", models="cp.models", auth="cp.auth",
             reg="cp.agent_registry", router="cp.log_router",
             placement="cp.placement", provider="cloud.provider")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)
T0 = 1_700_000_000.0


def _provider_class(pkg):
    class FakeProvider(pkg.provider.ServerProvider):
        name = "fake"

        def __init__(self, log):
            self.log = log

        def list_servers(self):
            if self.log.get("fail_list"):
                raise RuntimeError("cloud API down")
            return [pkg.provider.ServerInfo(id=f"srv-{n}", name=n,
                                            status="up")
                    for n in self.log["created"]]

        def get_server(self, server_id):
            return None

        def create_server(self, spec):
            if self.log.get("fail_create"):
                raise RuntimeError("quota exceeded")
            self.log["created"].append(spec.name)
            return pkg.provider.ServerInfo(id=f"srv-{spec.name}",
                                           name=spec.name, status="up",
                                           ip="203.0.113.50")

        def delete_server(self, server_id):
            self.log["deleted"].append(server_id)
            return True

        def power_on(self, server_id):
            return True

        def power_off(self, server_id):
            return True
    return FakeProvider


class World:
    """One package's state, provider log and clock."""

    def __init__(self, pkg, **log):
        self.pkg = pkg
        self.now = [T0]
        self.log = {"created": [], "deleted": [], **log}
        store = pkg.store.Store(clock=lambda: self.now[0])
        placement = (pkg.placement.PlacementService(store, use_gpu=False)
                     if pkg is PORT else pkg.placement.PlacementService(store))
        fake = _provider_class(pkg)
        self.state = pkg.server.AppState(
            store=store, auth=pkg.auth.NoAuth(),
            agent_registry=pkg.reg.AgentRegistry(),
            log_router=pkg.router.LogRouter(), placement=placement,
            server_provider_factory=lambda name, **kw: fake(self.log))
        self.db = store

    def pool(self, name="builders", **kw):
        return self.db.create("worker_pools", self.pkg.models.WorkerPool(
            tenant="default", name=name,
            preferred_labels={"provider": "fake"}, **kw))

    def scaler(self, **kw):
        return self.pkg.autoscaler.Autoscaler(
            self.state, clock=lambda: self.now[0], **kw)

    def worker(self, slug, pool="builders", **attrs):
        s = self.db.register_server(slug)
        self.db.update("servers", s.id, pool=pool, status="online",
                       provider="fake", **attrs)
        return s

    def servers(self, pool="builders") -> list:
        return [(s.slug, s.status, s.hostname, s.provider)
                for s in sorted(self.db.list(
                    "servers", lambda s: s.pool == pool),
                    key=lambda s: s.slug)]


def _actions(actions) -> list:
    return [(a.pool, a.kind, a.slug, a.ok, a.error) for a in actions]


def _scales_up(w):
    w.pool(min_servers=2)
    sc = w.scaler()
    return [_actions(sc.run_sweep()), w.servers(), _actions(sc.run_sweep())]


def _max_cap(w):
    w.pool(min_servers=5, max_servers=2)
    return [_actions(w.scaler().run_sweep()), w.servers()]


def _idle_down(w):
    w.pool(min_servers=1)
    sc = w.scaler()
    out = [_actions(sc.run_sweep())]
    for i in range(2):
        w.now[0] += 1
        w.worker(f"builders-extra{i}")
        w.log["created"].append(f"builders-extra{i}")
    out.append(_actions(sc.run_sweep()))
    w.now[0] += 10000
    out += [_actions(sc.run_sweep()), w.servers(), list(w.log["deleted"])]
    return out


def _busy(w):
    w.pool(min_servers=0)
    s = w.worker("builders-busy")
    w.db.update("servers", s.id, allocated=type(s.allocated)(cpu=2.0))
    w.now[0] += 10000
    return [_actions(w.scaler().run_sweep()), w.servers()]


def _rollback(w):
    w.pool(min_servers=1)
    return [_actions(w.scaler().run_sweep()), w.servers()]


PRESSURE_CASES = [
    ({"sustained": True, "oldest_age_s": 30.0}, 1, 4, 1),
    ({"sustained": True, "oldest_age_s": 30.0}, 1, 1, 1),
    ({"sustained": False, "oldest_age_s": 3.0}, 1, 4, 1),
    ({"sustained": False, "drained": True}, 1, 4, 1),
    ({}, 1, 4, 1),
    ({"sustained": True, "oldest_age_s": 30.0}, 1, 0, 1),
]


def _pressure_table(w):
    out = []
    for i, (pressure, mn, mx, alive) in enumerate(PRESSURE_CASES):
        pool = w.pool(name=f"p-{i}", min_servers=mn, max_servers=mx)
        for j in range(alive):
            w.worker(f"{pool.name}-w{j}", pool=pool.name)
        need, victims = w.scaler().plan(pool, pressure)
        out.append((need, [v.slug for v in victims]))
    return out


def _pressure_hold(w):
    pressure = [{"sustained": True, "oldest_age_s": 60.0}]
    w.pool(min_servers=1, max_servers=0)
    for i in range(2):
        w.worker(f"builders-w{i}")
        w.log["created"].append(f"builders-w{i}")
    w.now[0] += 10000
    sc = w.scaler(pressure_source=lambda: pressure[0])
    out = [_actions(sc.run_sweep())]
    pressure[0] = {"sustained": False, "drained": True}
    w.now[0] += 10000
    out += [_actions(sc.run_sweep()), w.servers()]
    return out


def _pressure_cap(w):
    w.pool(name="capped", min_servers=1, max_servers=2)
    sc = w.scaler(pressure_source=lambda: {"sustained": True,
                                           "oldest_age_s": 99.0})
    out = []
    for _ in range(4):
        out.append((_actions(sc.run_sweep()), w.servers("capped")))
    return out


def _corpse(w):
    w.pool(min_servers=2, max_servers=2)
    sc = w.scaler()
    out = [_actions(sc.run_sweep())]
    for s in w.db.list("servers", lambda s: s.pool == "builders"):
        w.db.update("servers", s.id, status="offline")
    out.append(_actions(sc.run_sweep()))
    w.now[0] += 10000
    out += [_actions(sc.run_sweep()), w.servers()]
    return out


def _list_failure(w):
    w.pool(min_servers=0)
    w.worker("builders-old")
    w.now[0] += 10000
    w.log["fail_list"] = True
    return [_actions(w.scaler().run_sweep()), w.servers()]


CASES = {
    "scales_up_to_min": ({}, _scales_up),
    "respects_max_cap": ({}, _max_cap),
    "idle_scale_down_newest_first": ({}, _idle_down),
    "busy_workers_never_reaped": ({}, _busy),
    "provider_failure_rolls_back": ({"fail_create": True}, _rollback),
    "pressure_table": ({}, _pressure_table),
    "sustained_pressure_holds_surplus": ({}, _pressure_hold),
    "pressure_capped_by_max": ({}, _pressure_cap),
    "offline_corpse_replaced": ({}, _corpse),
    "list_failure_defers_scale_down": ({}, _list_failure),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_autoscaler_equal(case):
    log, drive = CASES[case]
    out = []
    for pkg in BOTH:
        w = World(pkg, **log)
        out.append((drive(w), w.log))
    assert out[0] == out[1]


def test_reference_expectations_hold_on_port():
    w = World(PORT)
    up, servers, again = _scales_up(w)
    assert [a[1] for a in up] == ["provision", "provision"]
    assert all(s[2] == "203.0.113.50" for s in servers) and again == []
    w = World(PORT)
    out = _idle_down(w)
    downs = [a for a in out[2] if a[1] == "deprovision"]
    assert [a[2] for a in downs] == ["builders-w1", "builders-extra1"]
    assert [s[0] for s in out[3]] == ["builders-extra0"]
    w = World(PORT, fail_create=True)
    (action,), servers = _rollback(w)
    assert not action[3] and "quota exceeded" in action[4] and servers == []
    w = World(PORT)
    assert [n for n, _ in _pressure_table(w)] == [1, 0, 0, 0, 0, 1]
    w = World(PORT)
    out = _corpse(w)
    assert sorted(a[1] for a in out[2]) == ["deprovision", "deprovision",
                                            "provision", "provision"]
    assert PORT.autoscaler.PROVISION_TIMEOUT_S == \
        REF.autoscaler.PROVISION_TIMEOUT_S
