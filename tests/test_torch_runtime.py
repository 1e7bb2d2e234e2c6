"""The port's runtime layer (fleetflow_tpu_torch.runtime) against the
reference's (fleetflow_tpu.runtime), on the CPU.

Every case of the reference's TestConverter, TestWaiter, TestEngine and
TestSerialization (tests/test_runtime.py) runs through each package in
turn on the same inputs, and the two must agree exactly (host code: no
floats are compared):

- the converter: equal ContainerConfig fields;
- the waiter: the same attempt counts, sleeps and timeouts;
- the engine: the same DeployEvent step sequence and DeployResult, and the
  same MockBackend state (containers, networks, images, the call log)
  after `execute` and `down`; the lint gate's FlowError raised by both;
- the wire contract: `DeployRequest.to_dict()` equal, and each package's
  dict decodes in the other to the same request.

A DeployEvent's timing fields (the placement's solve ms, the run's
seconds) are masked before the comparison; every other field must match.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from types import SimpleNamespace

import pytest

_MODS = dict(model="core.model", loader="core.loader",
             serialize="core.serialize", errors="core.errors",
             parser="core.parser", rt="runtime", converter="runtime.converter",
             backend="runtime.backend", waiter="runtime.waiter",
             engine="runtime.engine", fleetgen="lower.fleetgen",
             base="sched.base")


def _pkg(root: str) -> SimpleNamespace:
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = _pkg("fleetflow_tpu")
PORT = _pkg("fleetflow_tpu_torch")
BOTH = (REF, PORT)


def load(P, project):
    root, _ = project
    return P.loader.load_project_from_root_with_stage(str(root), "local")


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------

def _full_service(P):
    m = P.model
    return m.Service(
        name="db", image="postgres", version="16",
        ports=[m.Port(host=5432, container=5432)],
        volumes=[m.Volume(host="./data",
                          container="/var/lib/postgresql/data"),
                 m.Volume(host="named", container="/cache", read_only=True)],
        environment={"POSTGRES_USER": "u"},
        restart=m.RestartPolicy.UNLESS_STOPPED,
        healthcheck=m.HealthCheck(test=["CMD", "pg_isready"], interval=5.0),
    )


def _restart_service(P, policy: str):
    m = P.model
    return m.Service(name="w", image="app", restart=m.RestartPolicy(policy),
                     command="serve --port 8080",
                     ports=[m.Port(host=80, container=8080,
                                   host_ip="127.0.0.1")],
                     labels={"team": "core"},
                     volumes=[m.Volume(host="~/cache", container="/c"),
                              m.Volume(host="/abs", container="/a")],
                     healthcheck=m.HealthCheck(test=["curl", "-f", "x"],
                                               interval=2.0, timeout=1.5,
                                               retries=7, start_period=3.0))


CONVERTER_CASES = {
    "full": _full_service,
    "image_tag_already_present": lambda P: P.model.Service(
        name="x", image="repo/app:v2", version="9"),
    "bare": lambda P: P.model.Service(name="bare"),
    **{f"restart_{p}": (lambda P, p=p: _restart_service(P, p))
       for p in ("no", "always", "on-failure", "unless-stopped")},
}


class TestConverter:
    def test_naming_contract(self):
        for P in BOTH:
            assert P.converter.container_name("proj", "live", "db") == \
                "proj-live-db"
            assert P.converter.network_name("proj", "live") == "proj-live"

    @pytest.mark.parametrize("case", sorted(CONVERTER_CASES))
    def test_same_container_config(self, case):
        cfgs = [P.converter.service_to_container_config(
            CONVERTER_CASES[case](P), "p", "s", project_root="/proj")
            for P in BOTH]
        ref, port = cfgs
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.to_dict() == ref.to_dict()
        if case == "full":
            # the reference test's own expectations, on the port
            assert port.image == "postgres:16"
            assert port.binds == ["/proj/data:/var/lib/postgresql/data",
                                  "named:/cache:ro"]
            assert port.restart_policy == "unless-stopped"
            assert port.healthcheck["interval"] == 5_000_000_000
        if case == "image_tag_already_present":
            assert port.image == "repo/app:v2"

    def test_stage_services_filter_and_unknown(self, project):
        for P in BOTH:
            flow = load(P, project)
            stage = flow.stage("local")
            names = [s.name for s in P.converter.stage_services(
                flow, stage, ["app", "redis"])]
            assert names == ["redis", "app"]
            with pytest.raises(KeyError, match="ghost"):
                P.converter.stage_services(flow, stage, ["ghost"])


# --------------------------------------------------------------------------
# waiter
# --------------------------------------------------------------------------

def _waiter_transition(P):
    b = P.backend.MockBackend()
    b.images.add("app:latest")
    svc = P.model.Service(name="app", image="app")
    b.create(P.converter.ContainerConfig(name="c", image="app:latest"))
    attempts = []

    def sleeper(d):
        attempts.append(d)
        if len(attempts) == 3:
            b.start("c")

    n = P.waiter.wait_for_service(b, "c", svc, sleep=sleeper)
    return n, attempts


def _waiter_timeout(P):
    b = P.backend.MockBackend()
    svc = P.model.Service(name="app", wait=P.model.WaitConfig(max_retries=4))
    sleeps, seen = [], []
    with pytest.raises(P.waiter.WaitTimeout) as e:
        P.waiter.wait_for_service(b, "missing", svc, sleep=sleeps.append,
                                  on_attempt=lambda a, d: seen.append((a, d)))
    assert isinstance(e.value, P.errors.FlowError)
    return str(e.value), sleeps, seen


def _waiter_health(P):
    b = P.backend.MockBackend()
    b.images.add("app:latest")
    b.create(P.converter.ContainerConfig(name="c", image="app:latest",
                                         healthcheck={"test": ["CMD", "ok"]}))
    b.start("c")
    b.set_health("c", "unhealthy")
    svc = P.model.Service(name="app",
                          healthcheck=P.model.HealthCheck(test=["CMD", "ok"]),
                          wait=P.model.WaitConfig(max_retries=2))
    with pytest.raises(P.waiter.WaitTimeout) as e:
        P.waiter.wait_for_service(b, "c", svc, sleep=lambda d: None)
    b.set_health("c", "healthy")
    return str(e.value), P.waiter.wait_for_service(b, "c", svc,
                                                   sleep=lambda d: None)


WAITER_CASES = {"transition": _waiter_transition, "timeout": _waiter_timeout,
                "healthcheck_gates": _waiter_health}


class TestWaiter:
    def test_backoff_schedule(self):
        ref, port = ([P.model.WaitConfig().delay_for_attempt(i)
                      for i in range(24)] for P in BOTH)
        assert port == ref
        assert port[:6] == [1.0, 2.0, 4.0, 8.0, 16.0, 30.0]

    @pytest.mark.parametrize("case", sorted(WAITER_CASES))
    def test_same_outcome(self, case):
        ref, port = (WAITER_CASES[case](P) for P in BOTH)
        assert port == ref
        if case == "transition":
            assert port[0] == 3
        if case == "healthcheck_gates":
            assert port[1] == 0

    def test_check_container_health(self):
        for P in BOTH:
            b = P.backend.MockBackend()
            assert not P.waiter.check_container_health(b, "nope", False)


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

_MS = re.compile(r"\d+\.\dms")
_SECONDS = re.compile(r"in \d+\.\d\ds$")


def _event(e) -> tuple:
    msg = _SECONDS.sub("in <s>", _MS.sub("<ms>", e.message))
    return (e.step, e.service, msg, e.level)


def _backend_state(b) -> dict:
    return {"containers": {k: dataclasses.asdict(v)
                           for k, v in sorted(b.containers.items())},
            "networks": sorted(b.networks), "images": sorted(b.images),
            "calls": list(b.calls), "pruned": b.pruned}


def _result(res) -> dict:
    pl = res.placement
    return {"deployed": list(res.deployed), "removed": list(res.removed),
            "failed": dict(res.failed), "ok": res.ok,
            "placement": None if pl is None else (
                dict(pl.assignment), pl.levels, pl.feasible, pl.violations,
                pl.source)}


def _engine(P):
    b = P.backend.MockBackend()
    return P.engine.DeployEngine(b, sleep=lambda d: None), b


IMAGES = {"postgres:16", "redis:7", "myapp:latest"}


def _run(P, flow, b, engine, runs, events):
    out = []
    for kw in runs:
        out.append(_result(engine.execute(
            P.engine.DeployRequest(flow=flow, stage_name="local", **kw),
            on_event=events.append)))
    return out


def _case_full_deploy(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    return _run(P, flow, b, engine, [{}], events), events, b


def _case_remote_servers(P, project):
    m = P.model
    flow = load(P, project)
    for name in ("node-1", "node-2"):
        flow.servers[name] = m.ServerResource(
            name=name, capacity=m.ResourceSpec(cpu=8, memory=16384,
                                               disk=102400))
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    return _run(P, flow, b, engine, [{}], events), events, b


def _case_node_targeting(P, project):
    flow = load(P, project)
    flow.stage("local").placement = P.model.PlacementPolicy(
        required_labels={"role": "db"})
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    return _run(P, flow, b, engine, [{}], events), events, b


def _case_redeploy(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    return _run(P, flow, b, engine, [{}, {}], events), events, b


def _case_target_filter(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update({"redis:7"})
    events = []
    return (_run(P, flow, b, engine, [{"target_services": ["redis"]}],
                 events), events, b)


def _case_pull_retry(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    events = []
    return _run(P, flow, b, engine, [{"no_pull": True}], events), events, b


def _case_no_prune(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    return _run(P, flow, b, engine, [{"no_prune": True}], events), events, b


def _case_down(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    out = _run(P, flow, b, engine, [{}], events)
    out.append(_result(engine.down(flow, "local", on_event=events.append)))
    return out, events, b


def _case_down_targeted(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    events = []
    out = _run(P, flow, b, engine, [{}], events)
    out.append(_result(engine.down(flow, "local", ["redis"],
                                   on_event=events.append)))
    return out, events, b


def _case_failure_recorded(P, project):
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    b.fail_on["start:testproj-local-redis"] = 99
    events = []
    return _run(P, flow, b, engine, [{}], events), events, b


def _case_agent_slice(P, project):
    """An agent executing a control plane's placement: only its node's
    rows, in level order, with no re-solve (the self-healing path)."""
    flow = load(P, project)
    engine, b = _engine(P)
    b.images.update(IMAGES)
    placement = P.base.Placement(
        assignment={"postgres": "n1", "redis": "n2", "app": "n1"},
        levels=[["postgres", "redis"], ["app"]], feasible=True,
        source="cp-solved")
    events = []
    res = engine.execute(P.engine.DeployRequest(flow=flow, stage_name="local",
                                                node="n1"),
                         on_event=events.append, placement=placement)
    return [_result(res)], events, b


def _case_replica_rows(P, project):
    flow = load(P, project)
    flow.services["redis"].replicas = 2
    engine, b = _engine(P)
    b.images.update(IMAGES)
    placement = P.base.Placement(
        assignment={"postgres": "n1", "redis#0": "n1", "redis#1": "n2",
                    "app": "n1"},
        levels=[["postgres", "redis#0", "redis#1"], ["app"]], feasible=True,
        source="cp-solved")
    events = []
    res = engine.execute(P.engine.DeployRequest(flow=flow, stage_name="local",
                                                node="n1"),
                         on_event=events.append, placement=placement)
    return [_result(res)], events, b


ENGINE_CASES = {
    "full_deploy": _case_full_deploy,
    "local_execute_ignores_declared_remote_servers": _case_remote_servers,
    "local_execute_ignores_node_targeting_policies": _case_node_targeting,
    "redeploy_removes_existing": _case_redeploy,
    "target_filter": _case_target_filter,
    "missing_image_pull_retry": _case_pull_retry,
    "no_prune": _case_no_prune,
    "down": _case_down,
    "down_targeted": _case_down_targeted,
    "failure_recorded_not_raised": _case_failure_recorded,
    "agent_slice": _case_agent_slice,
    "replica_rows": _case_replica_rows,
}


class TestEngine:
    @pytest.mark.parametrize("case", sorted(ENGINE_CASES))
    def test_same_events_result_and_backend(self, case, project):
        (ref_out, ref_ev, ref_b), (out, ev, b) = (
            ENGINE_CASES[case](P, project) for P in BOTH)
        assert out == ref_out
        assert [_event(e) for e in ev] == [_event(e) for e in ref_ev]
        assert _backend_state(b) == _backend_state(ref_b)
        # every event of an execute carries the deploy's trace id
        if not case.startswith("down"):
            assert all(e.trace_id for e in ev)
        # the reference test's own expectations, on the port
        if case == "full_deploy":
            assert sorted(out[0]["deployed"]) == [
                "testproj-local-app", "testproj-local-postgres",
                "testproj-local-redis"]
            starts = [c[1] for c in b.calls if c[0] == "start"]
            assert starts.index("testproj-local-app") > \
                starts.index("testproj-local-postgres")
        if case.startswith("local_execute"):
            assert out[0]["ok"] and len(out[0]["deployed"]) == 3
        if case == "redeploy_removes_existing":
            assert len(out[1]["removed"]) == 3
        if case == "down":
            assert b.containers == {} and "testproj-local" not in b.networks
        if case == "failure_recorded_not_raised":
            assert "redis" in out[0]["failed"]
        if case == "agent_slice":
            assert sorted(out[0]["deployed"]) == [
                "testproj-local-app", "testproj-local-postgres"]

    def test_lint_gate_rejects_before_backend(self):
        msgs = []
        for P in BOTH:
            m = P.model
            flow = m.Flow(name="t")
            flow.services["a"] = m.Service(name="a", image="x",
                                           depends_on=["b"])
            flow.services["b"] = m.Service(name="b", image="x",
                                           depends_on=["a"])
            flow.stages["live"] = m.Stage(name="live", services=["a", "b"])
            backend = P.backend.MockBackend(auto_pull=True)
            engine = P.engine.DeployEngine(backend, sleep=lambda s: None)
            events = []
            with pytest.raises(P.errors.FlowError) as e:
                engine.execute(P.engine.DeployRequest(flow=flow,
                                                      stage_name="live"),
                               on_event=events.append)
            assert "FF001" in str(e.value) and not backend.list()
            msgs.append((str(e.value), [_event(x) for x in events]))
        assert msgs[1] == msgs[0]

    def test_default_scheduler_is_the_host_greedy(self):
        """The engine's own placement keeps the reference's default: a
        local deploy lands on the one implicit local node, where the card
        has nothing to solve."""
        from fleetflow_tpu_torch.sched import HostGreedyScheduler
        engine = PORT.engine.DeployEngine(PORT.backend.MockBackend())
        assert type(engine.scheduler) is HostGreedyScheduler

    def test_metrics_move_alike(self, project):
        """A deploy bumps the same engine families in each package's own
        registry, by the same amounts."""
        from fleetflow_tpu.obs.metrics import REGISTRY as REF_REGISTRY
        from fleetflow_tpu_torch.obs.metrics import REGISTRY
        names = ("fleet_deploys_total", "fleet_deploy_events_total",
                 "fleet_deploy_services_total")
        moved = []
        for P, reg in zip(BOTH, (REF_REGISTRY, REGISTRY)):
            before = reg.counter_values()
            _case_redeploy(P, project)
            moved.append({k: v - before.get(k, 0.0)
                          for k, v in reg.counter_values().items()
                          if k.startswith(names)
                          and v != before.get(k, 0.0)})
        assert moved[1] == moved[0]
        assert moved[1]['fleet_deploys_total{outcome="ok"}'] == 2


# --------------------------------------------------------------------------
# DeployRequest serialization (the cross-machine contract)
# --------------------------------------------------------------------------

def _fleet_flow(P):
    text = P.fleetgen.generate_fleet_kdl("t0", 200, seed=3, n_nodes_hint=20,
                                         port_base=20000)
    return P.parser.parse_kdl_string(text, cache=False)


class TestSerialization:
    def test_flow_roundtrip(self, project):
        dicts = []
        for P in BOTH:
            flow = load(P, project)
            d = P.serialize.flow_to_dict(flow)
            assert P.serialize.flow_from_dict(d) == flow
            dicts.append(d)
        assert dicts[1] == dicts[0]

    @pytest.mark.parametrize("flow_of", ["project", "fleetgen"])
    def test_deploy_request_roundtrip_across_packages(self, flow_of, project):
        wires = []
        for P in BOTH:
            flow = (load(P, project) if flow_of == "project"
                    else _fleet_flow(P))
            stage = "local" if flow_of == "project" else "prod"
            target = ["app"] if flow_of == "project" else []
            req = P.engine.DeployRequest(flow=flow, stage_name=stage,
                                         target_services=target,
                                         no_pull=True, node="worker-1",
                                         trace_id="abc")
            wires.append(json.dumps(req.to_dict()))
        assert wires[1] == wires[0]
        # each package's dict decodes in the other to the same request
        for src, dst in ((REF, PORT), (PORT, REF)):
            d = json.loads(wires[0])
            back = dst.engine.DeployRequest.from_dict(d)
            assert back.to_dict() == d
            assert back.node == "worker-1" and back.no_pull
            assert not back.no_prune and back.trace_id == "abc"
        back = PORT.engine.DeployRequest.from_dict(json.loads(wires[0]))
        assert back.flow == (load(PORT, project) if flow_of == "project"
                             else _fleet_flow(PORT))

    def test_minimal_request_keeps_optional_keys_out(self, project):
        for P in BOTH:
            d = P.engine.DeployRequest(flow=load(P, project),
                                       stage_name="local").to_dict()
            assert sorted(d) == ["flow", "stage_name"]
