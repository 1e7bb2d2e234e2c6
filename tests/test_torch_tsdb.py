"""The port's fleet-horizon store and its collector
(fleetflow_tpu_torch.obs.tsdb, fleetflow_tpu_torch.obs.collector) against
the reference's (fleetflow_tpu.obs), on the CPU.

- the store: the reference's ring, selector, aggregate, capture-digest and
  export cases (tests/test_tsdb.py) and a seeded stream of records, run on
  both packages' TimeSeriesDB on one fake clock: equal `snapshot()`
  (digest included), `aggregate`, `aggregate_range`, `query`, `stats`,
  `match` and both export formats;
- the collector: the reference's sample_once and agent-snapshot cases
  (tests/test_collector.py) on both packages' Collector, each scraping its
  own registry of the same families: equal sample counts, snapshots and
  status; `compact_snapshot` equal;
- device faults: a source that raises a fault of the device path
  (`KernelError`, or an error raised from one) propagates out of the
  port's `sample_once`, where the reference logs it and goes on; any other
  failure is logged and skipped in both;
- the server's deep sources (`cp.server.collector_sources`) over each
  package's AppState on its host placement path: the same entries.
"""

from __future__ import annotations

import importlib
import json
import random
from types import SimpleNamespace

import pytest

_MODS = dict(tsdb="obs.tsdb", collector="obs.collector",
             metrics="obs.metrics", errors="core.errors",
             server="cp.server", store="cp.store", auth="cp.auth",
             reg="cp.agent_registry", router="cp.log_router",
             placement="cp.placement", admission="cp.admission",
             shards="cp.shards")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _db(pkg, **kw):
    clock = FakeClock()
    kw.setdefault("clock", clock)
    return pkg.tsdb.TimeSeriesDB(**kw), clock


def _views(tsdb, clock) -> dict:
    """Everything a reader of the store sees."""
    return dict(
        snapshot=tsdb.snapshot(), names=tsdb.names(), stats=tsdb.stats(),
        aggregate=tsdb.aggregate(), window=tsdb.aggregate(window_s=5.0),
        range=tsdb.aggregate_range(since=2.0, until=clock.t - 1.0),
        query=tsdb.query(limit=3), openmetrics=tsdb.render_openmetrics(),
        jsonl=tsdb.export_jsonl(),
        match=[(s.name, s.labels, s.kind, s.total) for s in tsdb.match()],
        len=len(tsdb))


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

def _ring(tsdb, clock):
    for i in range(10):
        clock.advance(1.0)
        tsdb.record("g", float(i))


def _cap(tsdb, clock):
    for name in ("a", "b", "c"):
        tsdb.record(name, 1.0)
    clock.advance(1.0)
    tsdb.record("a", 2.0)


def _labels(tsdb, clock):
    for agent in ("n2", "n1", "n3"):
        for t in range(4):
            tsdb.record("fleet_y", 10.0 - t, labels={"agent": agent},
                        t=float(t))
    tsdb.record("fleet_y", 1.0, labels={"agent": "n1", "zone": "z"}, t=4.0)
    clock.t = 5.0


def _counters(tsdb, clock):
    tsdb.record("c", 10.0, t=0.0, kind="counter")
    tsdb.record("c", 30.0, t=4.0, kind="counter")
    tsdb.record("single", 10.0, t=0.0, kind="counter")
    tsdb.record("g", 1.0, t=0.0)
    tsdb.record("g", 9.0, t=100.0)
    clock.t = 100.0


def _quantiles(tsdb, clock):
    for i in range(100):
        clock.advance(1.0)
        tsdb.record("g", float(i))
        tsdb.record("h", float((i * 37) % 17), kind="counter")


def _fill(tsdb, clock):
    for t in range(5):
        tsdb.record("fleet_x", t * 1.5, t=float(t), kind="counter")
        tsdb.record("fleet_y", 10.0 - t, labels={"agent": "n1"},
                    t=float(t))
    clock.t = 5.0


def _seeded(tsdb, clock):
    rng = random.Random(5)
    for _ in range(400):
        clock.advance(rng.choice((0.0, 0.25, 1.0, 3.5)))
        name = rng.choice(("fleet_a", "fleet_b", "fleet_c", "fleet_d"))
        labels = ({"agent": f"n{rng.randrange(5)}"} if rng.random() < 0.6
                  else {})
        kind = "counter" if name in ("fleet_a", "fleet_c") else "gauge"
        tsdb.record(name, rng.uniform(-5.0, 50.0), labels=labels,
                    kind=kind, t=clock.t if rng.random() < 0.5 else None)


STORE_CASES = {
    "ring": (dict(capacity_per_series=4), _ring),
    "max_series": (dict(max_series=2), _cap),
    "labels": ({}, _labels),
    "counters": ({}, _counters),
    "quantiles": (dict(capacity_per_series=256), _quantiles),
    "fill": ({}, _fill),
    "seeded": (dict(capacity_per_series=64, max_series=12), _seeded),
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_views_equal(case):
    kw, fill = STORE_CASES[case]
    views = []
    for pkg in BOTH:
        tsdb, clock = _db(pkg, **kw)
        fill(tsdb, clock)
        views.append(_views(tsdb, clock))
    assert views[0] == views[1]
    snap = views[1]["snapshot"]
    assert PORT.tsdb.snapshot_digest(snap) == snap["digest"]
    assert json.loads(json.dumps(snap, sort_keys=True)) == snap


def test_store_selectors_equal():
    out = []
    for pkg in BOTH:
        tsdb, clock = _db(pkg)
        _labels(tsdb, clock)
        out.append([
            [(s.name, s.labels) for s in tsdb.match("fleet_y",
                                                    {"agent": "n1"})],
            tsdb.query("fleet_y", labels={"zone": "z"}),
            tsdb.aggregate("fleet_y", labels={"agent": "n2"},
                           window_s=2.0),
            tsdb.query(window_s=2.0)])
    assert out[0] == out[1]


def test_constants_and_flattening_equal():
    assert PORT.tsdb.SCHEMA_VERSION == REF.tsdb.SCHEMA_VERSION
    assert PORT.tsdb.AGGREGATES == REF.tsdb.AGGREGATES
    snap = {
        "c": {"type": "counter",
              "values": [{"labels": {"k": "v"}, "value": 3}]},
        "g": {"type": "gauge", "values": [{"labels": {}, "value": 7}]},
        "h": {"type": "histogram",
              "values": [{"labels": {}, "sum": 1.5, "count": 4}]},
    }
    got = [sorted(pkg.tsdb.iter_registry_samples(snap)) for pkg in BOTH]
    assert got[0] == got[1] == [("c", {"k": "v"}, 3.0, "counter"),
                                ("g", {}, 7.0, "gauge"),
                                ("h_count", {}, 4.0, "counter"),
                                ("h_sum", {}, 1.5, "counter")]


# --------------------------------------------------------------------------
# the collector
# --------------------------------------------------------------------------

def _registry(pkg):
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("work_total", "c").inc(3)
    reg.gauge("depth", "g").set(7)
    reg.histogram("lat", "h").observe(0.5)
    return reg


def _collector(pkg, **kw):
    clock = FakeClock()
    tsdb = pkg.tsdb.TimeSeriesDB(clock=clock)
    kw.setdefault("registry", None)
    return pkg.collector.Collector(tsdb, clock=clock, **kw), tsdb, clock


def _c_scrape(pkg, coll, clock):
    clock.t = 10.0
    return [coll.sample_once(), coll.sample_once(now=12.5)]


def _c_override(pkg, coll, clock):
    coll.add_source(lambda now: [("depth", {}, 42.0)])
    return [coll.sample_once()]


def _c_tsdb_only(pkg, coll, clock):
    coll.add_source(lambda now: [
        ("backlog", {"subscriber": "s1"}, 5.0),
        ("acks", {}, 9.0, "counter")])
    return [coll.sample_once(now=3.0), coll.sample_once(now=4.0)]


def _c_failing(pkg, coll, clock):
    def bad(now):
        raise RuntimeError("boom")
    coll.add_source(bad)
    coll.add_source(lambda now: [("ok", {}, 1.0)])
    return [coll.sample_once(now=0.0)]


def _c_empty(pkg, coll, clock):
    return [coll.sample_once(now=0.0)]


def _c_agents(pkg, coll, clock):
    snap = pkg.collector.compact_snapshot(_registry(pkg))
    big = [[f"m{i}", {}, float(i), "gauge"]
           for i in range(pkg.collector.MAX_SNAPSHOT_ENTRIES + 8)]
    schema = pkg.collector.SNAPSHOT_SCHEMA
    return [coll.ingest_agent_snapshot("node-1", snap, now=1.0),
            coll.ingest_agent_snapshot("n", {"schema": 99, "m": [
                ["x", {}, 1.0, "gauge"]]}),
            coll.ingest_agent_snapshot("n", "not-a-dict"),
            coll.ingest_agent_snapshot("n", {
                "schema": schema,
                "m": [["good", {}, 1.0, "gauge"], ["short"],
                      ["nan-ish", {}, "not-a-float", "gauge"], None,
                      ["also-good", {"k": "v"}, 2.0]]}, now=2.0),
            coll.ingest_agent_snapshot("big", {"schema": schema, "m": big},
                                       now=3.0)]


COLLECTOR_CASES = {
    "scrape": (True, _c_scrape),
    "override": (True, _c_override),
    "tsdb_only": (False, _c_tsdb_only),
    "failing_source": (False, _c_failing),
    "registry_none": (False, _c_empty),
    "agent_snapshots": (False, _c_agents),
}


@pytest.mark.parametrize("case", sorted(COLLECTOR_CASES))
def test_collector_equal(case):
    scrape, drive = COLLECTOR_CASES[case]
    out = []
    for pkg in BOTH:
        reg = _registry(pkg) if scrape else None
        coll, tsdb, clock = _collector(pkg, registry=reg)
        counts = drive(pkg, coll, clock)
        status = coll.status()
        out.append((counts, tsdb.snapshot(), status))
    assert out[0] == out[1]


def test_compact_snapshot_equal():
    snaps = [pkg.collector.compact_snapshot(_registry(pkg)) for pkg in BOTH]
    assert snaps[0] == snaps[1]
    assert snaps[1]["schema"] == PORT.collector.SNAPSHOT_SCHEMA
    capped = [pkg.collector.compact_snapshot(_registry(pkg), max_entries=2)
              for pkg in BOTH]
    assert capped[0] == capped[1]


def _raise_from_kernel():
    try:
        raise PORT.errors.KernelError("k3_rebuild did not launch")
    except PORT.errors.KernelError as e:
        raise RuntimeError("slots unreadable") from e


@pytest.mark.parametrize("fault", ["kernel", "raised_from_kernel",
                                   "device_unavailable"])
def test_device_fault_in_source_propagates(fault):
    """A source that fails for the device path ends the pass with that
    fault; the reference's collector logs every failure and goes on."""
    def bad(now):
        if fault == "kernel":
            raise PORT.errors.KernelError("k1_sweep did not launch")
        if fault == "device_unavailable":
            raise PORT.errors.DeviceUnavailable("no CUDA")
        _raise_from_kernel()

    coll, tsdb, _ = _collector(PORT)
    coll.add_source(lambda now: [("before", {}, 1.0)])
    coll.add_source(bad)
    with pytest.raises((PORT.errors.KernelError, PORT.errors.DeviceUnavailable,
                        RuntimeError)) as info:
        coll.sample_once(now=0.0)
    assert PORT.placement._device_fault(info.value)
    assert len(tsdb) == 0            # nothing of the failed pass recorded
    ref, ref_tsdb, _ = _collector(REF)
    ref.add_source(lambda now: [("before", {}, 1.0)])
    ref.add_source(bad)
    assert ref.sample_once(now=0.0) == 1


def test_plain_failure_still_skipped_in_port(caplog):
    coll, tsdb, _ = _collector(PORT)

    def bad(now):
        raise ValueError("not a device fault")
    coll.add_source(bad)
    coll.add_source(lambda now: [("ok", {}, 1.0)])
    assert coll.sample_once(now=0.0) == 1
    assert tsdb.names() == ["ok"]


# --------------------------------------------------------------------------
# the server's deep sources
# --------------------------------------------------------------------------

def _state(pkg):
    store = pkg.store.Store(clock=lambda: 1000.0)
    table = pkg.shards.ShardTable(4)
    placement = (pkg.placement.PlacementService(store, use_gpu=False)
                 if pkg is PORT else pkg.placement.PlacementService(store))
    state = pkg.server.AppState(
        store=store, auth=pkg.auth.NoAuth(),
        agent_registry=pkg.reg.AgentRegistry(shard_table=table),
        log_router=pkg.router.LogRouter(shard_table=table),
        placement=placement)
    state.admission = pkg.admission.AdmissionController(
        placement, clock=lambda: 1000.0, store=store)
    return state


def test_collector_sources_equal():
    """Each source's entries, over a state with a subscriber backlog and
    no agents; the port's host path builds no scheduler and reports the
    limits an idle one would hold, as the reference's host path reports
    its idle device scheduler's."""
    out = []
    for pkg in BOTH:
        state = _state(pkg)
        sid, _q = state.log_router.subscribe(prefix="logs/")
        for i in range(3):
            state.log_router.publish_line("node001", "web", f"l{i}")
        rows = []
        for src in pkg.server.collector_sources(state):
            rows.append((src.__name__, list(src(1000.0) or ())))
        out.append(rows)
    assert out[0] == out[1]
    assert [n for n, _ in out[1]] == ["_slo", "_admission", "_log_router",
                                      "_reconverge", "_agents", "_slots",
                                      "_shards"]


def test_port_slots_source_reads_the_host_path():
    state = _state(PORT)
    (slots,) = [s for s in PORT.server.collector_sources(state)
                if s.__name__ == "_slots"]
    assert slots(0.0) == [("fleet_sched_resident_budget_bytes", {},
                           float(256 << 20)),
                          ("fleet_sched_resident_bytes", {}, 0.0),
                          ("fleet_solver_resident_bytes_drift", {}, 0.0)]
    assert state.placement.solver_slots() == {
        "budget_bytes": 256 << 20, "max_slots": 8, "resident_bytes": 0,
        "bytes_drift": 0, "slots": [], "evicted": []}


@pytest.mark.parametrize("env,want", [
    ({}, (8, 256 << 20)),
    ({"FLEET_RESIDENT_STAGES": "3", "FLEET_RESIDENT_BYTES": "4096"},
     (3, 4096))], ids=["defaults", "env"])
def test_host_path_slots_equal_an_idle_scheduler(monkeypatch, env, want):
    """The host path's limits are the ones GpuSolverScheduler() would
    take, the environment's included (its slots_status, on the CPU)."""
    from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler, slot_limits
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert slot_limits() == want
    state = _state(PORT)
    idle = GpuSolverScheduler(device="cpu").slots_status()
    assert state.placement.solver_slots() == idle
    assert (idle["max_slots"], idle["budget_bytes"]) == want


# --------------------------------------------------------------------------
# the chaos capture (tests/test_collector.py's TestChaosCapture) on both of
# the port's paths
# --------------------------------------------------------------------------

_CAPTURE = dict(seed=11, services=20, nodes=4, stages=1, pool_min=0)


class TestChaosCapture:
    def test_host_path_capture_equals_the_reference(self):
        """rolling-kill at 20x4x1 on the host path: the event digest and
        the whole TSDB capture, series for series, equal the
        reference's."""
        from fleetflow_tpu import chaos as ref_chaos
        from fleetflow_tpu_torch import chaos as port_chaos
        ref = ref_chaos.run_scenario("rolling-kill", **_CAPTURE)
        port = port_chaos.run_scenario("rolling-kill", use_gpu=False,
                                       **_CAPTURE)
        assert port.digest() == ref.digest()
        assert port.tsdb == ref.tsdb
        budget = [s for s in port.tsdb["series"]
                  if s["name"] == "fleet_sched_resident_budget_bytes"]
        assert budget and all(v == float(256 << 20)
                              for s in budget for _, v in s["samples"])

    def test_card_path_capture_repeats(self):
        from fleetflow_tpu_torch import chaos as port_chaos
        a = port_chaos.run_scenario("rolling-kill", device="cpu", **_CAPTURE)
        b = port_chaos.run_scenario("rolling-kill", device="cpu", **_CAPTURE)
        assert a.tsdb is not None and a.tsdb["series"]
        assert a.tsdb["digest"] == b.tsdb["digest"] and a.tsdb == b.tsdb
        assert "tsdb" in a.to_dict() and a.digest() == b.digest()
        names = {s["name"] for s in a.tsdb["series"]}
        assert "fleet_agents_connected" in names
        assert all(n.startswith("fleet_") for n in names)
