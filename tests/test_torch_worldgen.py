"""The port's chaos schedules (fleetflow_tpu_torch.chaos: the fault
algebra, the scenario pack and the world simulator) against the
reference's (fleetflow_tpu.chaos), on the CPU.

- `compile_world` of every WorldSpec the world pack declares, and of the
  reference's distribution-check specs (tests/test_worldgen.py), gives
  the same schedule in both packages: expanded events, world topology,
  tenant caps, horizon and `describe()`, at the smoke size, at each
  scenario's docstring sizing and at other seeds;
- `build_schedule` of every scenario of the pack (the eight hand-written
  ones and the four world ones) equal, also on tiny fleets, and
  `scenario_info` (description and sizing) equal;
- `validate_schedule`: the shipped scenarios pass at their sizings in
  the port, and each fabricated mis-sized schedule of the reference's
  tests fails in both packages with the same message;
- the world metric families (`fleet_world_*`) registered in the port.
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest

_MODS = dict(chaos="chaos", faults="chaos.faults", worldgen="chaos.worldgen",
             scenarios="chaos.scenarios", metrics="obs.metrics")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)
SMOKE = dict(services=60, nodes=10)


def _schedule_doc(s) -> str:
    return json.dumps({"scenario": s.scenario, "seed": s.seed,
                       "events": s.events(), "world": s.world,
                       "caps": s.tenant_caps, "horizon": s.horizon,
                       "describe": s.describe()}, sort_keys=True)


def _sizing(pkg, name: str) -> dict:
    info = pkg.chaos.scenario_info(name)
    return {k: int(v) for k, v in (kv.split("=")
                                   for kv in info["sizing"].split())}


def _specs(pkg) -> dict:
    """The WorldSpecs the world pack compiles, by name."""
    return {v.name: v for v in vars(pkg.worldgen).values()
            if isinstance(v, pkg.worldgen.WorldSpec)}


def test_world_pack_names_equal():
    assert sorted(_specs(PORT)) == sorted(_specs(REF))
    assert sorted(PORT.worldgen.WORLD_SCENARIOS) == \
        sorted(REF.worldgen.WORLD_SCENARIOS) == \
        ["diurnal-hotspot", "production-week", "spot-storm", "zone-outage"]
    assert PORT.chaos.scenario_names() == REF.chaos.scenario_names()
    assert len(PORT.chaos.scenario_names()) == 12


@pytest.mark.parametrize("size", ["smoke", "sizing", "acceptance"])
@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("name", sorted(REF.worldgen.WORLD_SCENARIOS))
def test_compile_world_equal(name, seed, size):
    spec_name = None
    docs = []
    for pkg in BOTH:
        builder = pkg.worldgen.WORLD_SCENARIOS[name][0]
        sz = {"smoke": SMOKE, "sizing": None,
              "acceptance": dict(services=1000, nodes=100)}[size]
        sz = sz or {k: _sizing(pkg, name)[k] for k in ("services", "nodes")}
        s = builder(seed, sz["services"], sz["nodes"])
        docs.append(_schedule_doc(s))
        # the same schedule straight from the pack's spec
        specs = _specs(pkg)
        spec_name = spec_name or next(
            n for n, sp in specs.items()
            if _schedule_doc(pkg.worldgen.compile_world(
                sp, seed, sz["services"], sz["nodes"])) == docs[-1])
        assert spec_name in specs
    assert docs[0] == docs[1]
    assert json.loads(docs[1])["events"]


def _custom_specs(pkg) -> list:
    wg = pkg.worldgen
    return [
        wg.WorldSpec(name="sine-check", tenants=(wg.TenantSpec("t0"),),
                     regions=(wg.RegionSpec("r0"),), duration_s=2000.0,
                     settle_s=0.0, arrivals_per_service=6.0,
                     max_arrivals=10 ** 9, diurnal_amp=0.8,
                     diurnal_period_s=400.0, mean_lifetime_s=50.0),
        wg.WorldSpec(name="little-check", tenants=(wg.TenantSpec("t0"),),
                     regions=(wg.RegionSpec("r0"),), duration_s=4000.0,
                     settle_s=0.0, arrivals_per_service=10.0,
                     max_arrivals=10 ** 9, diurnal_amp=0.0,
                     mean_lifetime_s=100.0)]


@pytest.mark.parametrize("which,seed,services", [(0, 3, 400), (1, 5, 300)])
def test_compile_custom_world_equal(which, seed, services):
    docs = [_schedule_doc(pkg.worldgen.compile_world(
        _custom_specs(pkg)[which], seed=seed, services=services, nodes=10))
        for pkg in BOTH]
    assert docs[0] == docs[1]
    assert len(json.loads(docs[1])["events"]) > 100


@pytest.mark.parametrize("nodes", [2, 3, 10, 100])
@pytest.mark.parametrize("name", REF.chaos.scenario_names())
def test_build_schedule_equal(name, nodes):
    services = 1000 if nodes == 100 else (10 if nodes < 10 else 60)
    docs = [_schedule_doc(pkg.chaos.build_schedule(name, 7, services, nodes))
            for pkg in BOTH]
    assert docs[0] == docs[1]
    assert json.loads(docs[1])["events"]


def test_scenario_info_equal():
    for name in REF.chaos.scenario_names():
        assert PORT.chaos.scenario_info(name) == \
            REF.chaos.scenario_info(name), name


def test_shipped_scenarios_validate_in_port():
    for name in PORT.chaos.scenario_names():
        sz = _sizing(PORT, name)
        s = PORT.chaos.build_schedule(name, 7, sz["services"], sz["nodes"])
        PORT.worldgen.validate_schedule(s, services=sz["services"],
                                        nodes=sz["nodes"])
        s = PORT.chaos.build_schedule(name, 7, **SMOKE)
        PORT.worldgen.validate_schedule(s, **SMOKE)


def _missized(pkg) -> list:
    F = pkg.faults
    return [
        (F.FaultSchedule("oversized", 1, [
            F.SilentNodeCrash(at=10.0, node=f"node{i:03d}",
                              revive_after=600.0) for i in range(6)],
            horizon=700.0), dict(services=20, nodes=10)),
        (F.FaultSchedule("toobig", 1, [], horizon=100.0),
         dict(services=2000, nodes=3)),
        (F.FaultSchedule(
            "domain", 1, [F.ZoneOutage(at=10.0, region="big")],
            horizon=200.0,
            world={"regions": {"big": [0, 1, 2, 3, 4],
                               "rest": [5, 6, 7, 8, 9]},
                   "capacity_scale": {}, "spot_pools": {}}),
         dict(services=20, nodes=10)),
    ]


def _validate(pkg, s, kw) -> str:
    try:
        pkg.worldgen.validate_schedule(s, **kw)
    except ValueError as e:
        return str(e)
    return "ok"


def test_validate_schedule_equal():
    out = [[_validate(pkg, s, kw) for s, kw in _missized(pkg)]
           for pkg in BOTH]
    assert out[0] == out[1]
    assert "concurrently dead" in out[1][0]
    assert "headroom" in out[1][1]
    assert out[1][2] == "ok"


def test_tiny_fleet_rejected_equal():
    msgs = []
    for pkg in BOTH:
        with pytest.raises(ValueError, match="at least 2 nodes") as info:
            pkg.chaos.build_schedule("rolling-kill", 7, 10, 1)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_world_families_registered():
    reg = PORT.metrics.REGISTRY
    for name in ("fleet_world_arrivals_total", "fleet_world_reclaims_total",
                 "fleet_world_zone_outages_total"):
        assert reg.get(name) is not None, name
    assert PORT.worldgen.M_WORLD_ARRIVALS is reg.get(
        "fleet_world_arrivals_total")
