"""The port's unit generators and host runtimes
(fleetflow_tpu_torch.runtime: quadlet, compose, readiness, ports,
static_site) against the reference's, on the CPU.

- byte-equal output: the Quadlet units of every stage and the Compose YAML
  of the same flows (the reference generators' demo flow, the conftest
  project, every stage of examples/, a chaos-world flow with replicas and
  anti-affinity, escaping corners) equal the reference's byte for byte,
  each flow built by the reference and carried to the port through the
  serialized flow dict;
- the same effects: ``sync_units``/``apply_stage``/``down_stage`` write,
  keep and remove the same files and call the same systemctl argv;
  ``compose_up``/``compose_down`` write the same file and run the same
  docker argv; readiness probes make the same attempts and reports;
  ``pids_bound_to_port`` finds the same pids; the static-site runner
  calls are the same;
- the reference's own tests (tests/test_generators.py, test_readiness.py,
  test_static.py's runtime classes) on the port.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

import pytest

from fleetflow_tpu.core import loader as ref_loader
from fleetflow_tpu.core import model as ref_model
from fleetflow_tpu.core import serialize as ref_ser
from fleetflow_tpu.runtime import compose as ref_compose
from fleetflow_tpu.runtime import ports as ref_ports
from fleetflow_tpu.runtime import quadlet as ref_quadlet
from fleetflow_tpu.runtime import readiness as ref_readiness
from fleetflow_tpu.runtime import static_site as ref_static
from fleetflow_tpu_torch.core import serialize as port_ser
from fleetflow_tpu_torch.core.errors import FlowError
from fleetflow_tpu_torch.core.model import (DeployConfig, Flow, HealthCheck,
                                            Port, ReadinessCheck,
                                            RestartPolicy, Service,
                                            ServiceType, Stage)
from fleetflow_tpu_torch.runtime import compose, ports, quadlet, readiness
from fleetflow_tpu_torch.runtime import static_site
from fleetflow_tpu_torch.runtime.compose import (compose_up,
                                                 generate_compose_yaml,
                                                 write_compose_file)
from fleetflow_tpu_torch.runtime.quadlet import (OWNERSHIP_MARKER,
                                                 apply_stage,
                                                 build_stage_units,
                                                 generate_container_unit,
                                                 sync_units)
from torch_frontend_cases import EXAMPLES


def to_port(ref_flow):
    return port_ser.flow_from_dict(ref_ser.flow_to_dict(ref_flow))


def ref_demo_flow():
    M = ref_model
    db = M.Service(name="db", image="postgres", version="16",
                   ports=[M.Port(host=5432, container=5432)],
                   environment={"POSTGRES_USER": "u"},
                   restart=M.RestartPolicy.ALWAYS,
                   healthcheck=M.HealthCheck(test=["CMD", "pg_isready"]))
    app = M.Service(name="app", image="app", depends_on=["db"],
                    restart=M.RestartPolicy.UNLESS_STOPPED)
    flow = M.Flow(name="proj")
    flow.services = {"db": db, "app": app}
    flow.stages = {"live": M.Stage(name="live", services=["db", "app"])}
    return flow


def ref_tricky_flow():
    M = ref_model
    svc = M.Service(
        name="tricky", image="img", command="run --flag: yes",
        environment={"A": "true", "B": "3.14", "C": "a: b",
                     "D": 'say "hi"', "E": "", "F": "-lead", "G": "~",
                     "H": " pad "},
        ports=[M.Port(host=53, container=53, host_ip="127.0.0.1",
                      protocol=M.Protocol.UDP)],
        volumes=[M.Volume(host="/srv/data", container="/data",
                          read_only=True)],
        labels={"team": "a: b"},
        healthcheck=M.HealthCheck(test=["curl", "-f", "http://x/"]),
        restart=M.RestartPolicy.ON_FAILURE)
    site = M.Service(name="site", service_type=M.ServiceType.STATIC)
    flow = M.Flow(name="p")
    flow.services = {"tricky": svc, "site": site}
    flow.stages = {"s": M.Stage(name="s", services=["tricky", "site"])}
    return flow


def ref_chaos_flow():
    from fleetflow_tpu.chaos.runner import make_flow
    return make_flow(60, 2, [f"node{i:03d}" for i in range(6)], 7)


def ref_flows(project_root):
    """(name, reference flow) of every case of the byte-equality tests."""
    out = [("demo", ref_demo_flow()), ("tricky", ref_tricky_flow()),
           ("chaos", ref_chaos_flow()),
           ("project", ref_loader.load_project_from_root_with_stage(
               str(project_root), "local"))]
    for ex in sorted(p for p in EXAMPLES.iterdir()
                     if (p / ".fleetflow" / "fleet.kdl").is_file()):
        from fleetflow_tpu.core.kdl import parse_document
        text = (ex / ".fleetflow" / "fleet.kdl").read_text()
        for node in parse_document(text):
            if node.name == "stage":
                st = node.args[0]
                try:
                    flow = ref_loader.load_project_from_root_with_stage(
                        str(ex), st)
                except Exception:      # noqa: BLE001 - an unloadable stage
                    continue           # is the loader tests' concern
                out.append((f"{ex.name}/{st}", flow))
    return out


# --------------------------------------------------------------------------
# byte-equal generators
# --------------------------------------------------------------------------

def test_units_and_yaml_byte_equal(project):
    root, _ = project
    n = 0
    for name, ref_flow in ref_flows(root):
        flow = to_port(ref_flow)
        for st in ref_flow.stages:
            ref_stage, stage = ref_flow.stage(st), flow.stage(st)
            assert build_stage_units(flow, stage) == \
                ref_quadlet.build_stage_units(ref_flow, ref_stage), name
            assert generate_compose_yaml(flow, stage) == \
                ref_compose.generate_compose_yaml(ref_flow, ref_stage), name
            n += 1
    assert n >= 8


@pytest.mark.parametrize("project_name,stage", [("proj", "live"),
                                                ("proj", "live-blue")])
def test_network_unit_and_scope_equal(project_name, stage):
    assert quadlet.generate_network_unit(project_name, stage) == \
        ref_quadlet.generate_network_unit(project_name, stage)
    assert quadlet._scope_line(project_name, stage) == \
        ref_quadlet._scope_line(project_name, stage)


def test_yaml_escape_equal():
    for s in ["", "plain", " pad", "a:b", "#x", "yes", "Off", "~", "-x",
              "?q", "1e3", "0x1f", "nan", 'q"t', "back\\slash", "multi\nline",
              "ok_value-1.2.3"]:
        assert compose._yaml_escape(s) == ref_compose._yaml_escape(s), s


def test_sync_apply_down_same_effects(tmp_path):
    ref_flow = ref_demo_flow()
    flow = to_port(ref_flow)
    seen = {}
    for tag, mod, fl in (("ref", ref_quadlet, ref_flow),
                         ("port", quadlet, flow)):
        d = tmp_path / tag
        calls = []

        def systemctl(args, calls=calls):
            calls.append(list(args))
            return (1, "Job failed") if args == ["stop", "x"] else (0, "")
        d.mkdir()
        (d / "proj-live-old.container").write_text(
            mod.OWNERSHIP_MARKER + "\n")
        (d / "proj-live-user.container").write_text("# hand-written\n")
        out = mod.apply_stage(fl, "live", unit_dir=str(d),
                              systemctl=systemctl)
        files = {p.name: p.read_text() for p in sorted(d.iterdir())}
        down = mod.down_stage(fl, "live", remove=True, unit_dir=str(d),
                              systemctl=systemctl)
        left = sorted(p.name for p in d.iterdir())
        seen[tag] = (out.written, out.removed, out.started, out.errors,
                     files, down.stopped, sorted(down.removed), down.errors,
                     left, calls)
    assert seen["port"] == seen["ref"]


def test_compose_up_down_same_effects(tmp_path):
    ref_flow = ref_demo_flow()
    flow = to_port(ref_flow)
    seen = {}
    for tag, mod, fl in (("ref", ref_compose, ref_flow),
                         ("port", compose, flow)):
        cmds = []

        def runner(argv, cmds=cmds):
            cmds.append([a.replace(str(tmp_path / tag), "<root>")
                         for a in argv])
            return 0, "ok"
        up = mod.compose_up(fl, "live", str(tmp_path / tag), runner=runner)
        down = mod.compose_down(fl, "live", str(tmp_path / tag),
                                runner=runner)
        text = (tmp_path / tag / ".fleetflow" /
                "compose.live.yaml").read_text()
        seen[tag] = (up, down, cmds, text)
    assert seen["port"] == seen["ref"]


# --------------------------------------------------------------------------
# the reference's generator tests on the port (tests/test_generators.py)
# --------------------------------------------------------------------------

def demo_flow() -> Flow:
    db = Service(name="db", image="postgres", version="16",
                 ports=[Port(host=5432, container=5432)],
                 environment={"POSTGRES_USER": "u"},
                 restart=RestartPolicy.ALWAYS,
                 healthcheck=HealthCheck(test=["CMD", "pg_isready"]))
    app = Service(name="app", image="app", depends_on=["db"],
                  restart=RestartPolicy.UNLESS_STOPPED)
    flow = Flow(name="proj")
    flow.services = {"db": db, "app": app}
    flow.stages = {"live": Stage(name="live", services=["db", "app"])}
    return flow


class TestQuadlet:
    def test_container_unit(self):
        flow = demo_flow()
        unit = generate_container_unit(flow.services["app"], "proj", "live")
        assert unit.startswith(OWNERSHIP_MARKER)
        assert "After=proj-live-db.service" in unit
        assert "Requires=proj-live-db.service" in unit
        assert "ContainerName=proj-live-app" in unit
        assert "Restart=always" in unit

    def test_healthcheck_lines(self):
        flow = demo_flow()
        unit = generate_container_unit(flow.services["db"], "proj", "live")
        assert "HealthCmd=pg_isready" in unit
        assert "PublishPort=5432:5432" in unit
        assert "Environment=POSTGRES_USER=u" in unit

    def test_stage_units_and_sync(self, tmp_path):
        flow = demo_flow()
        scope = quadlet._stage_scope("proj", "live")
        units = build_stage_units(flow, flow.stages["live"])
        assert set(units) == {"proj-live.network", "proj-live-db.container",
                              "proj-live-app.container"}
        d = tmp_path / "systemd"
        written, removed = sync_units(units, str(d), scope=scope)
        assert sorted(written) == sorted(units)
        written2, _ = sync_units(units, str(d), scope=scope)
        assert written2 == []
        (d / "proj-live-old.container").write_text(OWNERSHIP_MARKER + "\n")
        (d / "proj-live-user.container").write_text("# hand-written\n")
        _, removed = sync_units(units, str(d), scope=scope)
        assert removed == ["proj-live-old.container"]
        assert (d / "proj-live-user.container").exists()

    def test_sync_never_touches_sibling_stage(self, tmp_path):
        flow = demo_flow()
        units = build_stage_units(flow, flow.stages["live"])
        d = tmp_path / "systemd"
        d.mkdir()
        (d / "proj-live2-db.container").write_text(
            OWNERSHIP_MARKER + "\n[Container]\n")
        (d / "proj-live2.network").write_text(
            OWNERSHIP_MARKER + "\n[Network]\n")
        _, removed = sync_units(units, str(d),
                                scope=quadlet._stage_scope("proj", "live"))
        assert removed == []
        assert (d / "proj-live2-db.container").exists()
        assert (d / "proj-live2.network").exists()

    def test_sync_never_touches_hyphenated_sibling(self, tmp_path):
        flow = demo_flow()
        units = build_stage_units(flow, flow.stages["live"])
        assert quadlet._scope_line("proj", "live") in \
            units["proj-live.network"]
        d = tmp_path / "systemd"
        d.mkdir()
        (d / "proj-live-blue-db.container").write_text(
            OWNERSHIP_MARKER + "\n" + quadlet._scope_line("proj", "live-blue")
            + "\n[Container]\n")
        (d / "proj-live-blue.network").write_text(
            quadlet.generate_network_unit("proj", "live-blue"))
        _, removed = sync_units(units, str(d),
                                scope=quadlet._stage_scope("proj", "live"))
        assert removed == []
        assert (d / "proj-live-blue-db.container").exists()

    def test_apply_stage_with_fake_systemctl(self, tmp_path):
        flow = demo_flow()
        calls = []

        def fake_systemctl(args):
            calls.append(args)
            return 0, ""

        outcome = apply_stage(flow, "live", unit_dir=str(tmp_path),
                              systemctl=fake_systemctl)
        assert outcome.ok
        assert calls[0] == ["daemon-reload"]
        assert sorted(outcome.started) == ["proj-live-app.service",
                                           "proj-live-db.service"]

    def test_apply_stage_reload_failure(self, tmp_path):
        outcome = apply_stage(demo_flow(), "live", unit_dir=str(tmp_path),
                              systemctl=lambda a: (1, "no bus"))
        assert not outcome.ok and outcome.errors == {"daemon-reload":
                                                     "no bus"}
        assert outcome.started == []

    def test_down_stage_stops_and_removes(self, tmp_path):
        flow = demo_flow()
        units = build_stage_units(flow, flow.stages["live"])
        sync_units(units, str(tmp_path),
                   scope=quadlet._stage_scope("proj", "live"))
        (tmp_path / "proj-live2-db.container").write_text(
            OWNERSHIP_MARKER + "\n[Container]\n")
        (tmp_path / "proj-live-user.container").write_text("# hand-written\n")
        calls = []

        def fake_systemctl(args):
            calls.append(args)
            return 0, ""

        outcome = quadlet.down_stage(flow, "live", remove=True,
                                     unit_dir=str(tmp_path),
                                     systemctl=fake_systemctl)
        assert outcome.ok
        assert sorted(outcome.stopped) == ["proj-live-app.service",
                                           "proj-live-db.service",
                                           "proj-live-network.service"]
        assert sorted(outcome.removed) == ["proj-live-app.container",
                                           "proj-live-db.container",
                                           "proj-live.network"]
        assert calls[-1] == ["daemon-reload"]
        assert (tmp_path / "proj-live2-db.container").exists()
        assert (tmp_path / "proj-live-user.container").exists()

    def test_down_stage_without_remove_keeps_units(self, tmp_path):
        flow = demo_flow()
        sync_units(build_stage_units(flow, flow.stages["live"]),
                   str(tmp_path), scope=quadlet._stage_scope("proj", "live"))
        outcome = quadlet.down_stage(flow, "live", unit_dir=str(tmp_path),
                                     systemctl=lambda a: (0, ""))
        assert outcome.ok and outcome.removed == []
        assert (tmp_path / "proj-live-db.container").exists()

    def test_down_is_idempotent_on_stopped_stage(self, tmp_path):
        outcome = quadlet.down_stage(
            demo_flow(), "live", unit_dir=str(tmp_path),
            systemctl=lambda a: (5, f"Unit {a[-1]} not loaded."))
        assert outcome.ok
        assert len(outcome.stopped) == 3

    def test_remove_skipped_when_stop_fails(self, tmp_path):
        flow = demo_flow()
        sync_units(build_stage_units(flow, flow.stages["live"]),
                   str(tmp_path), scope=quadlet._stage_scope("proj", "live"))

        def wedged(args):
            if args == ["stop", "proj-live-app.service"]:
                return 1, "Job failed"
            return 0, ""

        outcome = quadlet.down_stage(flow, "live", remove=True,
                                     unit_dir=str(tmp_path), systemctl=wedged)
        assert not outcome.ok
        assert "skipped" in outcome.errors["remove"]
        assert (tmp_path / "proj-live-app.container").exists()

    def test_default_unit_dir(self, monkeypatch, tmp_path):
        monkeypatch.setenv("HOME", str(tmp_path))
        assert quadlet.default_unit_dir() == \
            str(tmp_path / ".config" / "containers" / "systemd") == \
            ref_quadlet.default_unit_dir()


class TestCompose:
    def test_yaml_structure(self):
        flow = demo_flow()
        text = generate_compose_yaml(flow, flow.stages["live"])
        import yaml
        doc = yaml.safe_load(text)
        assert doc["name"] == "proj-live"
        assert doc["services"]["db"]["image"] == "postgres:16"
        assert doc["services"]["db"]["ports"] == ["5432:5432"]
        assert doc["services"]["app"]["depends_on"]["db"]["condition"] == \
            "service_healthy"
        assert doc["networks"]["default"]["name"] == "proj-live"

    def test_escaping(self):
        svc = Service(name="tricky", image="img",
                      environment={"A": "true", "B": "3.14", "C": "a: b",
                                   "D": 'say "hi"', "E": ""})
        flow = Flow(name="p")
        flow.services = {"tricky": svc}
        flow.stages = {"s": Stage(name="s", services=["tricky"])}
        import yaml
        doc = yaml.safe_load(generate_compose_yaml(flow, flow.stages["s"]))
        env = doc["services"]["tricky"]["environment"]
        assert env == {"A": "true", "B": "3.14", "C": "a: b",
                       "D": 'say "hi"', "E": ""}

    def test_write_and_up(self, tmp_path):
        flow = demo_flow()
        path = write_compose_file(flow, "live", str(tmp_path))
        assert path == tmp_path / ".fleetflow" / "compose.live.yaml"
        assert path.exists()
        cmds = []

        def runner(cmd):
            cmds.append(cmd)
            return 0, "ok"

        rc, _ = compose_up(flow, "live", str(tmp_path), runner=runner)
        assert rc == 0
        assert cmds[0][:2] == ["docker", "compose"]
        assert "up" in cmds[0]

    def test_project_fixture_compose(self, project):
        from fleetflow_tpu_torch.core.loader import \
            load_project_from_root_with_stage
        root, _ = project
        flow = load_project_from_root_with_stage(str(root), "local")
        import yaml
        doc = yaml.safe_load(generate_compose_yaml(flow, flow.stage("local")))
        assert set(doc["services"]) == {"postgres", "redis", "app"}


# --------------------------------------------------------------------------
# readiness (tests/test_readiness.py on the port, and the same reports)
# --------------------------------------------------------------------------

def _svc(name="api", port=18080, rc_port=None, timeout=6.0, interval=2.0,
         kind="http"):
    return Service(name=name, image="x",
                   ports=[Port(host=port, container=80)],
                   readiness=ReadinessCheck(type=kind, path="/health",
                                            port=rc_port, timeout=timeout,
                                            interval=interval))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class TestCheckReadiness:
    def test_ready_on_first_probe(self):
        clock = FakeClock()
        res = readiness.check_readiness(_svc(), fetch=lambda u, t: 200,
                                        sleep=clock.sleep, clock=clock)
        assert res.ready and res.attempts == 1
        assert res.url == "http://127.0.0.1:18080/health"

    def test_retries_until_success(self):
        clock = FakeClock()
        codes = iter([500, 503, 204])
        res = readiness.check_readiness(_svc(), fetch=lambda u, t: next(codes),
                                        sleep=clock.sleep, clock=clock)
        assert res.ready and res.attempts == 3

    def test_deadline_exceeded_reports_detail(self):
        clock = FakeClock()
        res = readiness.check_readiness(_svc(timeout=4.0),
                                        fetch=lambda u, t: 503,
                                        sleep=clock.sleep, clock=clock)
        assert not res.ready
        assert res.detail == "HTTP 503"
        assert res.attempts >= 2

    def test_transport_errors_are_retried(self):
        clock = FakeClock()
        calls = []

        def fetch(u, t):
            calls.append(u)
            if len(calls) < 2:
                raise ConnectionRefusedError("refused")
            return 200

        res = readiness.check_readiness(_svc(), fetch=fetch,
                                        sleep=clock.sleep, clock=clock)
        assert res.ready and len(calls) == 2

    def test_explicit_readiness_port_wins(self):
        clock = FakeClock()
        res = readiness.check_readiness(_svc(rc_port=9999),
                                        fetch=lambda u, t: 200,
                                        sleep=clock.sleep, clock=clock)
        assert ":9999/" in res.url

    def test_no_readiness_declared_is_none(self):
        svc = Service(name="db", image="x")
        assert readiness.check_readiness(svc, fetch=lambda u, t: 200) is None

    def test_no_port_is_not_ready(self):
        svc = Service(name="db", image="x", readiness=ReadinessCheck())
        res = readiness.check_readiness(svc, fetch=lambda u, t: 200)
        assert not res.ready and "no port" in res.detail

    def test_tcp_probe_success(self):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]

        def accept_once():
            try:
                conn, _ = srv.accept()
                conn.close()
            except OSError:
                pass

        t = threading.Thread(target=accept_once, daemon=True)
        t.start()
        clock = FakeClock()
        svc = Service(name="db", image="x",
                      readiness=ReadinessCheck(type="tcp", port=port,
                                               timeout=4.0, interval=1.0))
        res = readiness.check_readiness(svc, sleep=clock.sleep, clock=clock)
        srv.close()
        t.join(timeout=5)
        assert res.ready and res.url == f"tcp://127.0.0.1:{port}"

    def test_tcp_probe_refused_times_out(self):
        clock = FakeClock()
        svc = Service(name="db", image="x",
                      readiness=ReadinessCheck(type="tcp", port=1,
                                               timeout=2.0, interval=1.0))
        res = readiness.check_readiness(svc, sleep=clock.sleep, clock=clock)
        assert not res.ready

    def test_unknown_type_reports_unsupported(self):
        res = readiness.check_readiness(_svc(kind="grpc"),
                                        fetch=lambda u, t: 200)
        assert not res.ready and "unsupported" in res.detail


@pytest.mark.parametrize("codes", [[200], [500, 302], [503] * 6,
                                   [404, 404, 204]])
def test_readiness_reports_equal(codes):
    """Both packages probe the same urls the same number of times and
    print the same report lines."""
    out = {}
    for tag, mod, M in (("ref", ref_readiness, ref_model),
                        ("port", readiness, None)):
        clock, it, lines = FakeClock(), iter(codes), []
        if M is None:
            svcs = [_svc(), _svc("web", 8080, timeout=3.0),
                    Service(name="db", image="x")]
        else:
            svcs = [M.Service(name=n, image="x",
                              ports=[M.Port(host=p, container=80)],
                              readiness=M.ReadinessCheck(
                                  path="/health", timeout=to, interval=2.0))
                    for n, p, to in (("api", 18080, 6.0),
                                     ("web", 8080, 3.0))]
            svcs.append(M.Service(name="db", image="x"))
        res = mod.run_readiness_checks(
            svcs, on_line=lines.append,
            fetch=lambda u, t: next(it, codes[-1]),
            sleep=clock.sleep, clock=clock)
        out[tag] = ([(r.service, r.ready, r.url, r.attempts, r.detail)
                     for r in res], lines)
    assert out["port"] == out["ref"]


# --------------------------------------------------------------------------
# ports: the listening pids from /proc
# --------------------------------------------------------------------------

def test_pids_bound_to_port_equal():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    try:
        got = ports.pids_bound_to_port(port)
        assert os.getpid() in got
        assert got == ref_ports.pids_bound_to_port(port)
        assert not ports.ensure_port_available(port)
    finally:
        srv.close()
    assert ports.pids_bound_to_port(port) == []
    assert ports.ensure_port_available(port)


def test_ensure_port_available_kills_the_holder():
    code = ("import socket, sys, time\n"
            "s = socket.socket(); s.bind(('127.0.0.1', 0)); s.listen(1)\n"
            "print(s.getsockname()[1], flush=True); time.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline())
        assert ports.pids_bound_to_port(port) == [proc.pid]
        assert ports.ensure_port_available(port, kill=True)
        assert proc.wait(timeout=10) != 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_kill_pids_skips_the_gone():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    ports.kill_pids([proc.pid], grace_s=0.1)   # already gone: no error
    assert not ports._alive(proc.pid)


# --------------------------------------------------------------------------
# static sites (tests/test_static.py's runtime classes on the port)
# --------------------------------------------------------------------------

def make_runner(log, rc=0, out="ok"):
    def runner(argv, cwd):
        log.append((argv, cwd))
        return rc, out
    return runner


def static_svc(name="site", command="npm run build", output="public",
               project="my-pages"):
    return Service(name=name, service_type=ServiceType.STATIC,
                   command=command,
                   deploy=DeployConfig(type="cloudflare-pages",
                                       output=output, project=project))


@pytest.fixture(autouse=False)
def fresh_pages(monkeypatch):
    monkeypatch.setattr(static_site, "_ENSURED_PAGES_PROJECTS", set())
    monkeypatch.setattr(ref_static, "_ENSURED_PAGES_PROJECTS", set())


class TestStatic:
    def test_partition(self):
        svcs = [Service(name="db"), static_svc(), Service(name="app")]
        static, container = static_site.split_static_services(svcs)
        assert [s.name for s in static] == ["site"]
        assert [s.name for s in container] == ["db", "app"]

    def test_runs_command_via_sh(self, tmp_path):
        log = []
        static_site.build_static(static_svc(), str(tmp_path),
                                 runner=make_runner(log))
        assert log == [(["sh", "-c", "npm run build"], str(tmp_path))]

    def test_real_shell_build(self, tmp_path):
        svc = static_svc(command="mkdir -p public && echo hi > "
                                 "public/index.html")
        static_site.build_static(svc, str(tmp_path))
        assert (tmp_path / "public" / "index.html").read_text() == "hi\n"

    def test_no_command_is_noop(self, tmp_path):
        log = []
        svc = static_svc(command=None)
        svc.deploy.command = None
        static_site.build_static(svc, str(tmp_path), runner=make_runner(log))
        assert log == []

    def test_build_failure_raises(self, tmp_path):
        with pytest.raises(FlowError, match="build command failed"):
            static_site.build_static(static_svc(), str(tmp_path),
                                     runner=make_runner([], rc=1, out="boom"))

    def test_build_then_dev_server(self, tmp_path):
        log = []
        assert static_site.up_static(static_svc(), str(tmp_path),
                                     runner=make_runner(log)) is None
        assert log[0][0] == ["sh", "-c", "npm run build"]
        assert log[1][0][:3] == ["wrangler", "pages", "dev"]
        assert log[1][0][3].endswith("public")

    def test_default_output_dir_dist(self, tmp_path):
        log = []
        svc = static_svc()
        svc.deploy.output = None
        static_site.up_static(svc, str(tmp_path), runner=make_runner(log))
        assert log[1][0][3].endswith("dist")

    def test_dev_server_failure_raises(self, tmp_path):
        calls = []

        def runner(argv, cwd):
            calls.append(argv)
            return (1, "no wrangler") if argv[0] == "wrangler" else (0, "")
        with pytest.raises(FlowError, match="wrangler pages dev failed"):
            static_site.up_static(static_svc(), str(tmp_path), runner=runner)

    def test_build_then_pages_deploy(self, tmp_path, fresh_pages):
        log = []
        res = static_site.deploy_static(
            static_svc(), str(tmp_path),
            runner=make_runner(log, out="done https://my.pages.dev deployed"))
        argvs = [a for a, _cwd in log]
        assert argvs[0] == ["sh", "-c", "npm run build"]
        assert argvs[1][:4] == ["wrangler", "pages", "project", "list"]
        assert argvs[2][:4] == ["wrangler", "pages", "project", "create"]
        assert "my-pages" in argvs[2]
        deploy = next(a for a in argvs if a[:3] == ["wrangler", "pages",
                                                   "deploy"])
        assert "--project-name" in deploy and "my-pages" in deploy
        assert res.url == "https://my.pages.dev"

    def test_requires_deploy_config(self, tmp_path):
        svc = Service(name="s", service_type=ServiceType.STATIC)
        with pytest.raises(FlowError, match="no deploy"):
            static_site.deploy_static(svc, str(tmp_path))

    def test_unknown_provider_rejected(self, tmp_path):
        svc = static_svc()
        svc.deploy.type = "netlify"
        with pytest.raises(FlowError, match="unsupported"):
            static_site.deploy_static(svc, str(tmp_path),
                                      runner=make_runner([]))

    def test_requires_project(self, tmp_path):
        svc = static_svc(project=None)
        with pytest.raises(FlowError, match="deploy.project"):
            static_site.deploy_static(svc, str(tmp_path),
                                      runner=make_runner([]))


def test_static_deploy_calls_equal(tmp_path, fresh_pages):
    """Both packages run the same commands for a first and a second
    deploy of a Pages project, and report the same url."""
    out = {}
    for tag, mod, M in (("ref", ref_static, ref_model),
                        ("port", static_site, None)):
        if M is None:
            svc = static_svc()
        else:
            svc = M.Service(name="site", service_type=M.ServiceType.STATIC,
                            command="npm run build",
                            deploy=M.DeployConfig(type="cloudflare-pages",
                                                  output="public",
                                                  project="my-pages"))
        log = []
        runner = make_runner(log, out="ok https://a.my.pages.dev, done")
        urls = [mod.deploy_static(svc, str(tmp_path), runner=runner).url
                for _ in range(2)]
        out[tag] = (urls, log)
    assert out["port"] == out["ref"]
