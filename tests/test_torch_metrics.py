"""The port's metrics registry (fleetflow_tpu_torch/obs/metrics.py) against
the reference's (fleetflow_tpu/obs/metrics.py).

- registry semantics on fresh registries, the reference's TestCounter,
  TestGauge, TestHistogram and TestRegistry cases;
- the same seeded sequence of operations on both registries renders
  byte-equal exposition text and equal snapshots;
- the golden: every family the port registers has the HELP and TYPE lines
  of ``tests/goldens/metrics_exposition.txt``, apart from the listed
  exceptions;
- one cold and one warm resident solve of the same fleet through both
  packages touch the same families with the same counter increments.

Each package has its own REGISTRY; the port's families are read from the
port's, never from the reference's.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import pkgutil

import numpy as np
import pytest

from fleetflow_tpu.lower.tensors import synthetic_problem as ref_synthetic
from fleetflow_tpu.obs import metrics as ref_metrics
from fleetflow_tpu.solver import buckets as ref_buckets
from fleetflow_tpu.solver import solve as ref_solve
from fleetflow_tpu.solver.resident import ProblemDelta as RefDelta
from fleetflow_tpu.solver.resident import ResidentProblem as RefResident
import fleetflow_tpu_torch
from fleetflow_tpu_torch.lower.tensors import synthetic_problem
from fleetflow_tpu_torch.obs import metrics as port_metrics
from fleetflow_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from fleetflow_tpu_torch.solver import buckets as port_buckets
from fleetflow_tpu_torch.solver import solve
from fleetflow_tpu_torch.solver.resident import ProblemDelta, ResidentProblem
from test_torch_problem import CPU

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "metrics_exposition.txt"

# HELP lines that differ from the reference's on purpose, with the reason
HELP_EXCEPTIONS = {
    "fleet_solver_compile_events_total":
        "the reference counts XLA compilations of the refine pipeline; the "
        "port's only compiles are the kernel and host libraries _ext.py "
        "builds or loads at first use",
}
# families of the reference that the port does not register
NOT_REGISTERED = {
    "fleet_solver_compile_cache_enabled": "the JAX persistent compilation "
    "cache has no torch counterpart",
    "fleet_solver_compile_cache_rejects_total": "the JAX persistent "
    "compilation cache has no torch counterpart",
}


# the name prefixes of the reference's families this slice ports
_PORTED = ("fleet_solver_", "fleet_sched_", "fleet_placement", "fleet_slo_",
           "fleet_frontend_", "fleet_store_", "fleet_admission_",
           "fleet_heartbeats_total", "fleet_replication_",
           "fleet_lease_", "fleet_reconverge_", "fleet_cp_shard_",
           "fleet_deploy", "fleet_agents_connected",
           "fleet_agent_registrations_total", "fleet_agent_commands_total",
           "fleet_agent_command_errors_total", "fleet_obs_",
           "fleet_log_", "fleet_autoscaler_", "fleet_cloud_provider_",
           "fleet_cp_request_", "fleet_world_", "fleet_plan_simulate_")


def _import_port() -> None:
    """Import every module of the port, so each has registered its
    families."""
    for m in pkgutil.walk_packages(fleetflow_tpu_torch.__path__,
                                   "fleetflow_tpu_torch."):
        importlib.import_module(m.name)


def _golden() -> dict:
    """{name: {"HELP": line, "TYPE": line}} of the golden exposition."""
    out: dict = {}
    for line in GOLDEN.read_text().splitlines():
        parts = line.split(" ", 3)
        if len(parts) >= 3 and parts[0] == "#" and parts[1] in ("HELP",
                                                                "TYPE"):
            out.setdefault(parts[2], {})[parts[1]] = line
    return out


# --------------------------------------------------------------------------
# registry semantics (fresh registries)
# --------------------------------------------------------------------------

class TestCounter:
    def test_inc_and_value(self):
        r = MetricsRegistry()
        c = r.counter("x_total", "things")
        c.inc()
        c.inc(2.5)
        assert c.value() == 3.5

    def test_never_decreases(self):
        c = MetricsRegistry().counter("x_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            c.inc(-1)

    def test_labels_make_independent_children(self):
        c = MetricsRegistry().counter("ops_total", labels=("table", "op"))
        c.inc(table="servers", op="put")
        c.inc(3, table="servers", op="del")
        assert c.value(table="servers", op="put") == 1
        assert c.value(table="servers", op="del") == 3
        assert c.value(table="alerts", op="put") == 0

    @pytest.mark.parametrize("labels", [{"nope": "x"}, {}])
    def test_wrong_labels_raise(self, labels):
        c = MetricsRegistry().counter("ops_total", labels=("table",))
        with pytest.raises(ValueError, match="takes labels"):
            c.inc(**labels)


class TestGauge:
    def test_set_inc_dec(self):
        g = MetricsRegistry().gauge("temp")
        g.set(10)
        g.inc(5)
        g.dec(2)
        assert g.value() == 13

    def test_gauges_can_go_negative(self):
        g = MetricsRegistry().gauge("delta")
        g.dec(4)
        assert g.value() == -4


class TestHistogram:
    def test_observe_buckets_sum_count(self):
        h = MetricsRegistry().histogram("lat_seconds", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        assert h.count() == 3
        assert h.sum() == pytest.approx(5.55)
        text = h.render()
        assert 'lat_seconds_bucket{le="0.1"} 1' in text
        assert 'lat_seconds_bucket{le="1"} 2' in text
        assert 'lat_seconds_bucket{le="+Inf"} 3' in text
        assert "lat_seconds_count 3" in text

    def test_labeled_histogram(self):
        h = MetricsRegistry().histogram("lat_seconds", labels=("channel",),
                                        buckets=(1.0,))
        h.observe(0.5, channel="deploy")
        assert h.count(channel="deploy") == 1
        assert h.count(channel="health") == 0
        assert 'lat_seconds_bucket{channel="deploy",le="1"} 1' in h.render()

    def test_bucket_ladders_equal_the_reference(self):
        for name in ("DEFAULT_BUCKETS", "MS_BUCKETS",
                     "SOLVE_SECONDS_BUCKETS"):
            assert getattr(port_metrics, name) == getattr(ref_metrics, name)


class TestRegistry:
    def test_get_or_create_returns_same_instance(self):
        r = MetricsRegistry()
        assert r.counter("a_total") is r.counter("a_total")

    @pytest.mark.parametrize("second", ["gauge", "other_labels"])
    def test_redefinition_mismatch_raises(self, second):
        r = MetricsRegistry()
        r.counter("a_total", labels=("x",))
        with pytest.raises(ValueError, match="already registered"):
            if second == "gauge":
                r.gauge("a_total", labels=("x",))
            else:
                r.counter("a_total", labels=("y",))

    def test_render_has_help_type_and_trailing_newline(self):
        r = MetricsRegistry()
        r.counter("a_total", "does things")
        r.gauge("b", "level").set(2)
        text = r.render()
        assert "# HELP a_total does things" in text
        assert "# TYPE a_total counter" in text
        assert "\nb 2\n" in text or text.endswith("b 2\n")
        assert "\na_total 0\n" in text

    def test_label_values_escaped(self):
        r = MetricsRegistry()
        r.counter("a_total", labels=("msg",)).inc(msg='say "hi"\nnow')
        assert 'msg="say \\"hi\\"\\nnow"' in r.render()

    def test_snapshot_is_json_able(self):
        r = MetricsRegistry()
        r.counter("a_total", "help!", labels=("k",)).inc(k="v")
        r.histogram("h_seconds").observe(0.2)
        snap = json.loads(json.dumps(r.snapshot()))
        assert snap["a_total"]["type"] == "counter"
        assert snap["a_total"]["values"] == [
            {"labels": {"k": "v"}, "value": 1.0}]
        assert snap["h_seconds"]["values"][0]["count"] == 1

    def test_counter_values_flat_map(self):
        r = MetricsRegistry()
        r.counter("a_total", labels=("k",)).inc(2, k="v")
        r.gauge("g").set(9)
        assert r.counter_values() == {'a_total{k="v"}': 2.0}

    def test_port_registry_is_not_the_reference_registry(self):
        assert REGISTRY is not ref_metrics.REGISTRY
        assert MetricsRegistry is not ref_metrics.MetricsRegistry


# --------------------------------------------------------------------------
# parity: the same operations render the same text
# --------------------------------------------------------------------------

def _apply_ops(reg, seed: int) -> None:
    """A seeded sequence of definitions and updates: labelled and bare
    families of every type, awkward label values, integer and fractional
    amounts, samples on and off bucket edges."""
    rng = np.random.default_rng(seed)
    c = reg.counter("ops_total", "Ops by kind\nand table \\ escaped",
                    labels=("kind", "table"))
    bare = reg.counter("bare_total", "A bare counter")
    g = reg.gauge("level", "A gauge", labels=("slot",))
    h = reg.histogram("lat_seconds", "Latency", labels=("path",))
    hm = reg.histogram("lat_ms", "Latency ms",
                       buckets=port_metrics.MS_BUCKETS)
    kinds = ["put", "del", 'q"uote', "new\nline", "back\\slash", ""]
    for _ in range(200):
        op = int(rng.integers(0, 5))
        if op == 0:
            c.inc(float(rng.integers(0, 4)) if rng.random() < 0.5
                  else float(rng.random()),
                  kind=kinds[int(rng.integers(0, len(kinds)))],
                  table=str(int(rng.integers(0, 3))))
        elif op == 1:
            bare.inc()
        elif op == 2:
            g.set(float(rng.normal()) if rng.random() < 0.5
                  else int(rng.integers(-5, 5)), slot=int(rng.integers(3)))
        elif op == 3:
            h.observe(float(rng.choice([0.001, 0.05, 1.0, 7.3, 100.0])
                            if rng.random() < 0.3 else rng.exponential()),
                      path=("full", "sub")[int(rng.integers(2))])
        else:
            hm.observe(float(rng.exponential(12.0)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_render_byte_equal(seed):
    port, ref = MetricsRegistry(), ref_metrics.MetricsRegistry()
    _apply_ops(port, seed)
    _apply_ops(ref, seed)
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()
    assert port.counter_values() == ref.counter_values()


# --------------------------------------------------------------------------
# the golden surface
# --------------------------------------------------------------------------

def test_registered_families_match_the_golden():
    """Every family the port registers is in the golden with the same TYPE
    line and, apart from HELP_EXCEPTIONS, the same HELP line."""
    _import_port()
    golden = _golden()
    names = REGISTRY.names()
    # the whole solver, scheduler, SLO, front-end-stage, store, placement
    # and admission surface of the reference, but for the families listed
    # in NOT_REGISTERED
    assert set(names) == {n for n in golden if n.startswith(_PORTED)} - \
        set(NOT_REGISTERED)
    for name in names:
        assert name in golden, name
        m = REGISTRY.get(name)
        assert f"# TYPE {name} {m.kind}" == golden[name]["TYPE"], name
        help_line = m.render().splitlines()[0]
        if name in HELP_EXCEPTIONS:
            assert help_line != golden[name]["HELP"], name
        else:
            assert help_line == golden[name]["HELP"], name


def test_families_left_to_later_slices_are_not_registered():
    _import_port()
    golden = _golden()
    for name in NOT_REGISTERED:
        assert name in golden and REGISTRY.get(name) is None, name


# the control plane's families: the store's, the placement service's and
# the admission controller's
CP_FAMILIES = (
    "fleet_store_ops_total", "fleet_heartbeats_total",
    "fleet_store_compactions_total",
    "fleet_replication_fencing_rejections_total",
    "fleet_placement_churn_fallbacks_total",
    "fleet_admission_queue_depth", "fleet_admission_oldest_age_seconds",
    "fleet_admission_batch_size", "fleet_admission_batch_age_seconds",
    "fleet_admission_wait_seconds", "fleet_admission_admitted_total",
    "fleet_admission_departed_total", "fleet_admission_sheds_total",
    "fleet_admission_parked_total", "fleet_admission_unparked_total",
    "fleet_admission_quota_parked_total", "fleet_admission_solves_total",
    "fleet_admission_placements_per_s", "fleet_admission_fairness_debt",
    "fleet_admission_solve_phase_ms")


@pytest.mark.parametrize("name", CP_FAMILIES)
def test_control_plane_families_equal_the_reference(name):
    """Each family of the port's cp/ modules has the reference's kind,
    HELP line, TYPE line, labels and buckets, and renders the same
    exposition head."""
    importlib.import_module("fleetflow_tpu.cp.admission")
    importlib.import_module("fleetflow_tpu.cp.placement")
    importlib.import_module("fleetflow_tpu_torch.cp")
    ref, port = ref_metrics.REGISTRY.get(name), REGISTRY.get(name)
    assert ref is not None and port is not None
    assert (port.kind, port.help, port.labelnames) == \
        (ref.kind, ref.help, ref.labelnames)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)
    golden = _golden()[name]
    head = port.render().splitlines()[:2]
    assert head == [golden["HELP"], golden["TYPE"]]


# the self-healing path's families: the failure detector's, the
# reconverger's, the agent registry's, the shard table's and the deploy
# engine's
HEAL_FAMILIES = (
    "fleet_lease_transitions_total", "fleet_lease_agents",
    "fleet_lease_flap_damped_total", "fleet_reconverge_duration_seconds",
    "fleet_reconverge_redeliveries_total", "fleet_reconverge_parked",
    "fleet_agents_connected", "fleet_agent_registrations_total",
    "fleet_agent_commands_total", "fleet_agent_command_errors_total",
    "fleet_cp_shard_agents", "fleet_cp_shard_fanout_ms",
    "fleet_cp_shard_rebalances_total", "fleet_cp_shard_log_dropped_total",
    "fleet_deploys_total", "fleet_deploy_duration_seconds",
    "fleet_deploy_events_total", "fleet_deploy_services_total")


@pytest.mark.parametrize("name", HEAL_FAMILIES)
def test_self_healing_families_equal_the_reference(name):
    """Each family of the port's failure detector, reconverger, agent
    registry, shard table and deploy engine has the reference's kind,
    HELP line, TYPE line, labels and buckets, and renders the same
    exposition head."""
    for mod in ("cp.failure_detector", "cp.reconverge", "cp.agent_registry",
                "cp.shards", "runtime.engine"):
        importlib.import_module(f"fleetflow_tpu.{mod}")
        importlib.import_module(f"fleetflow_tpu_torch.{mod}")
    ref, port = ref_metrics.REGISTRY.get(name), REGISTRY.get(name)
    assert ref is not None and port is not None
    assert (port.kind, port.help, port.labelnames) == \
        (ref.kind, ref.help, ref.labelnames)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)
    golden = _golden()[name]
    head = port.render().splitlines()[:2]
    assert head == [golden["HELP"], golden["TYPE"]]


# the chaos world's families: the collector's and the deep gauges its
# sources set, the log router's, the autoscaler's, the cloud provider's,
# journal replication's, the channel handlers' and the world simulator's
WORLD_FAMILIES = (
    "fleet_obs_samples_total", "fleet_obs_series",
    "fleet_obs_series_dropped_total", "fleet_obs_agent_snapshots_total",
    "fleet_admission_tenant_queue_depth",
    "fleet_admission_tenant_oldest_age_seconds",
    "fleet_log_router_backlog_lines", "fleet_reconverge_redelivery_debt",
    "fleet_sched_resident_budget_bytes", "fleet_log_lines_published_total",
    "fleet_log_lines_delivered_total", "fleet_log_lines_dropped_total",
    "fleet_autoscaler_pressure", "fleet_cloud_provider_degraded_total",
    "fleet_replication_role", "fleet_replication_epoch",
    "fleet_replication_standby_lag",
    "fleet_replication_entries_shipped_total",
    "fleet_replication_entries_acked_total",
    "fleet_replication_snapshot_catchups_total",
    "fleet_replication_failovers_total",
    "fleet_cp_request_duration_seconds", "fleet_cp_request_errors_total",
    "fleet_world_arrivals_total", "fleet_world_reclaims_total",
    "fleet_world_zone_outages_total")


@pytest.mark.parametrize("name", WORLD_FAMILIES)
def test_world_families_equal_the_reference(name):
    """Each family of the port's collector, log router, autoscaler, cloud
    provider, replication, deploy handler and world simulator has the
    reference's kind, HELP line, TYPE line, labels and buckets, and
    renders the same exposition head."""
    for mod in ("obs.collector", "cp.log_router", "cp.autoscaler",
                "cloud.provider", "cp.replication", "cp.handlers",
                "chaos.worldgen"):
        importlib.import_module(f"fleetflow_tpu.{mod}")
        importlib.import_module(f"fleetflow_tpu_torch.{mod}")
    ref, port = ref_metrics.REGISTRY.get(name), REGISTRY.get(name)
    assert ref is not None and port is not None
    assert (port.kind, port.help, port.labelnames) == \
        (ref.kind, ref.help, ref.labelnames)
    assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)
    golden = _golden()[name]
    head = port.render().splitlines()[:2]
    assert head == [golden["HELP"], golden["TYPE"]]


def test_frontend_phase_family_is_get_or_create():
    """The front end's core/parsecache registers fleet_frontend_phase_ms
    with the reference's HELP and labels and gets the solver's family
    back."""
    from fleetflow_tpu.core.parsecache import M_FRONTEND_PHASE_MS as ref_m
    from fleetflow_tpu_torch.solver import api
    again = REGISTRY.gauge(ref_m.name, ref_m.help, labels=ref_m.labelnames)
    assert again is api._M_FRONTEND_MS


# --------------------------------------------------------------------------
# parity: a cold and a warm solve touch the same families
# --------------------------------------------------------------------------

# counters whose increments depend on each package's random draws (each is
# held to its own results instead), or count a different event
_OWN_VALUES = {"fleet_solver_sweeps_total",
               "fleet_solver_proposals_accepted_total"}
# HELP_EXCEPTIONS and the reference's compile-cache gauge (NOT_REGISTERED)
_SKIP = {"fleet_solver_compile_events_total",
         "fleet_solver_compile_cache_enabled"}


def _touch_spy(registry, monkeypatch) -> set:
    """Record the names of the families `registry`'s metrics update."""
    touched: set = set()
    for name in registry.names():
        m = registry.get(name)
        for meth in ("inc", "set", "observe"):
            if hasattr(m, meth):
                orig = getattr(m, meth)

                def spy(*a, _orig=orig, _name=name, **kw):
                    touched.add(_name)
                    return _orig(*a, **kw)
                monkeypatch.setattr(m, meth, spy)
    return touched


def _hist_counts(registry) -> dict:
    out = {}
    for name, fam in registry.snapshot().items():
        if fam["type"] == "histogram":
            for v in fam["values"]:
                key = (name, tuple(sorted(v["labels"].items())))
                out[key] = v["count"]
    return out


def _run(pkg: str, monkeypatch):
    """One cold and one warm (busiest node down) resident, bucketed solve
    of synthetic_problem(320, 40, seed=4). Returns (touched families,
    counter deltas, histogram count deltas, results)."""
    port = pkg == "port"
    registry = REGISTRY if port else ref_metrics.REGISTRY
    pt = (synthetic_problem if port else ref_synthetic)(320, 40, seed=4)
    before = registry.counter_values()
    hist0 = _hist_counts(registry)
    touched = _touch_spy(registry, monkeypatch)
    rp = ResidentProblem(pt, CPU) if port else RefResident(pt)
    run = solve if port else ref_solve
    kw = dict(resident=rp, bucket=True, steps=64, chains=1)
    cold = run(pt, prob=rp.prob, seed=4, **kw)
    valid = pt.node_valid.copy()
    valid[int(np.bincount(cold.assignment, minlength=pt.N).argmax())] = False
    cur = dataclasses.replace(pt, node_valid=valid)
    rp.apply_delta(cur, (ProblemDelta if port else RefDelta)(
        node_valid=valid.copy()))
    warm = run(cur, prob=rp.prob, seed=5, resident_warm=True, **kw)
    after = registry.counter_values()
    deltas = {k: v - before.get(k, 0.0) for k, v in after.items()
              if v != before.get(k, 0.0)}
    hist = {k: v - hist0.get(k, 0) for k, v in _hist_counts(
        registry).items() if v != hist0.get(k, 0)}
    return touched, deltas, hist, (cold, warm)


def test_cold_and_warm_solve_touch_the_same_families(monkeypatch):
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
    monkeypatch.setenv("FLEET_SUBSOLVE_FRAC", "0.6")
    # a fresh census of dispatch shapes in both packages, so bucket hits
    # do not depend on what ran before in this process
    monkeypatch.setattr(ref_buckets, "_seen_buckets", set())
    monkeypatch.setattr(port_buckets, "_seen_buckets", set())
    ref_t, ref_d, ref_h, ref_res = _run("ref", monkeypatch)
    port_t, port_d, port_h, port_res = _run("port", monkeypatch)
    assert port_t - _SKIP == ref_t - _SKIP
    assert "fleet_solver_subsolve_total" in port_t
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k.split("{")[0] not in _OWN_VALUES | _SKIP}
    assert strip(port_d) == strip(ref_d)
    assert port_h == ref_h
    for deltas, results in ((port_d, port_res), (ref_d, ref_res)):
        assert deltas["fleet_solver_sweeps_total"] == sum(
            r.steps for r in results)
        assert deltas.get("fleet_solver_proposals_accepted_total", 0) == \
            sum(r.accepted_moves for r in results)
    assert port_res[1].subsolve["outcome"] == ref_res[1].subsolve["outcome"]
    assert port_d['fleet_solver_subsolve_total{outcome="%s"}'
                  % port_res[1].subsolve["outcome"]] == 1
    assert port_d['fleet_solver_solves_total{backend="cpu",warm="true"}'] \
        == 1


def test_concurrent_increments_lose_nothing():
    """More threads than cores incrementing one family's children, with a
    short switch interval: every increment lands."""
    import os
    import sys
    import threading
    reg = MetricsRegistry()
    c = reg.counter("hits_total", labels=("k",))
    g = reg.gauge("level")
    workers, rounds = 2 * (os.cpu_count() or 4), 2000
    barrier = threading.Barrier(workers)

    def hammer(i: int) -> None:
        barrier.wait()
        for _ in range(rounds):
            c.inc(k=str(i % 3))
            g.inc()
            g.dec(0.5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sum(c.value(k=str(k)) for k in range(3)) == workers * rounds
    assert g.value() == workers * rounds * 0.5
