"""The port's node agent (fleetflow_tpu_torch.agent: the session, the
monitor and the guards) against the reference's, on the CPU.

- the pure tables: ``detect_anomalies``, the cooldown detector, the
  inventory report and the guards give the reference's answers on the same
  inputs (tests/test_agent.py's TestDetectAnomalies,
  TestAnomalyDetectorCooldown and TestGuards on the port, plus seeded
  random snapshot pairs through both packages);
- a real port ``Agent`` against the port's control plane on a socket,
  ``cp.start(ServerConfig(device="cpu"))`` (the card scheduler's plain
  versions): tests/test_agent.py's TestAgentSession, TestAgentBuild,
  TestCpRoutedDown, TestRemoteLogs and TestRemoteRestart on the port;
- the reference tests that waited for an agent: the epoch fence
  (test_replication.py's TestAgentFencing and
  ``test_zombie_cp_welcome_is_refused``), the CP failover end to end
  (``TestCpFailoverE2E``), the self-heal end to end with two real agents
  (test_selfheal.py's ``TestSelfHealE2E``) and the heartbeat's
  agent-labeled series (test_collector.py's
  ``test_heartbeat_ships_agent_labeled_series``);
- across packages: a port Agent registers with the reference's server and
  executes its deploy, and a reference Agent does the same with the
  port's server;
- chip_smoke's [agent] phase rehearsed at a small size.

Every socket test runs under its own timeout.
"""

from __future__ import annotations

import asyncio
import random
import time

import numpy as np
import pytest

import chip_smoke
from fleetflow_tpu.agent import monitor as ref_monitor
from fleetflow_tpu.agent import guard as ref_guard
from fleetflow_tpu_torch.agent import Agent, AgentConfig
from fleetflow_tpu_torch.agent import monitor as port_monitor
from fleetflow_tpu_torch.agent.guard import (GuardError, confine_path,
                                             validate_compose_command,
                                             validate_container_name)
from fleetflow_tpu_torch.agent.monitor import (AnomalyDetector,
                                               ContainerSnapshot,
                                               detect_anomalies,
                                               inventory_report)
from fleetflow_tpu_torch.core.errors import ControlPlaneError
from fleetflow_tpu_torch.core.loader import load_project_from_root_with_stage
from fleetflow_tpu_torch.core.model import (Backend, Flow, ResourceSpec,
                                            Service, Stage)
from fleetflow_tpu_torch.cp import ServerConfig, start
from fleetflow_tpu_torch.cp.protocol import ProtocolClient, RpcError
from fleetflow_tpu_torch.obs.metrics import REGISTRY
from fleetflow_tpu_torch.runtime import DeployRequest, MockBackend
from fleetflow_tpu_torch.runtime.converter import (ContainerConfig,
                                                   container_name)

CPU = dict(device="cpu")     # the card scheduler's plain versions


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def snap(name, state="running", health=None, restarts=0):
    return ContainerSnapshot(name=name, state=state, health=health,
                             restart_count=restarts)


def local_flow(project, servers=("node-1",), backend=None):
    root, _ = project
    flow = load_project_from_root_with_stage(str(root), "local")
    flow.stages["local"].servers = list(servers)
    if backend is not None:
        flow.stages["local"].backend = backend
    return flow


async def wait_connected(handle, *slugs):
    while not all(handle.state.agent_registry.is_connected(s)
                  for s in slugs):
        await asyncio.sleep(0.02)


# --------------------------------------------------------------------------
# anomaly tables, cooldown, inventory, guards
# --------------------------------------------------------------------------

class TestDetectAnomalies:
    def test_restart_loop_raised_at_threshold(self):
        prev = {"web": snap("web", restarts=1)}
        curr = {"web": snap("web", restarts=4)}
        out = detect_anomalies(prev, curr, restart_threshold=3)
        assert [(a.kind, a.resolved) for a in out] == [("restart_loop", False)]

    def test_restart_below_threshold_ignored(self):
        prev = {"web": snap("web", restarts=1)}
        curr = {"web": snap("web", restarts=3)}
        assert detect_anomalies(prev, curr, restart_threshold=3) == []

    def test_unexpected_stop_and_recovery(self):
        prev = {"db": snap("db", state="running")}
        curr = {"db": snap("db", state="exited")}
        out = detect_anomalies(prev, curr)
        assert [(a.kind, a.resolved) for a in out] == \
            [("unexpected_stop", False)]
        out2 = detect_anomalies(curr, prev)
        assert [(a.kind, a.resolved) for a in out2] == \
            [("unexpected_stop", True)]

    def test_unhealthy_and_recovery(self):
        prev = {"api": snap("api", health="healthy")}
        curr = {"api": snap("api", health="unhealthy")}
        out = detect_anomalies(prev, curr)
        assert [(a.kind, a.resolved) for a in out] == [("unhealthy", False)]
        out2 = detect_anomalies(curr, prev)
        assert [(a.kind, a.resolved) for a in out2] == [("unhealthy", True)]

    def test_first_observation_no_false_positives(self):
        assert detect_anomalies({}, {"x": snap("x", state="exited")}) == []

    def test_unhealthy_on_first_sight_still_fires(self):
        out = detect_anomalies({}, {"x": snap("x", health="unhealthy")})
        assert [a.kind for a in out] == ["unhealthy"]


def _random_snaps(rng, names, mod):
    return {n: mod.ContainerSnapshot(
        name=n, state=rng.choice(["running", "exited", "dead", "created"]),
        health=rng.choice([None, "healthy", "unhealthy"]),
        restart_count=rng.choice([0, 0, 1, 2, 4, 9]))
        for n in names if rng.random() < 0.8}


@pytest.mark.parametrize("seed", range(4))
def test_anomaly_detection_equal(seed):
    """Seeded random snapshot sequences through both packages' detectors
    (with a clock that crosses the cooldown): the same reports."""
    rng_r, rng_p = random.Random(seed), random.Random(seed)
    names = [f"c{i}" for i in range(12)]
    clock = [0.0]
    ref = ref_monitor.AnomalyDetector(cooldown_s=50, clock=lambda: clock[0])
    port = AnomalyDetector(cooldown_s=50, clock=lambda: clock[0])
    for _ in range(30):
        a = _random_snaps(rng_r, names, ref_monitor)
        b = _random_snaps(rng_p, names, port_monitor)
        got = [(x.container, x.kind, x.message, x.resolved)
               for x in port.observe(b)]
        want = [(x.container, x.kind, x.message, x.resolved)
                for x in ref.observe(a)]
        assert got == want
        clock[0] += 20
    assert inventory_report(b) == ref_monitor.inventory_report(a)


class TestAnomalyDetectorCooldown:
    def test_cooldown_suppresses_repeat_alerts(self):
        clock = [0.0]
        det = AnomalyDetector(cooldown_s=300, clock=lambda: clock[0])
        det.observe({"w": snap("w", health="healthy")})
        assert [a.kind for a in det.observe(
            {"w": snap("w", health="unhealthy")})] == ["unhealthy"]
        clock[0] += 30
        assert det.observe({"w": snap("w", health="unhealthy")}) == []
        clock[0] += 300
        assert [a.kind for a in det.observe(
            {"w": snap("w", health="unhealthy")})] == ["unhealthy"]

    def test_autoresolve_on_recovery_and_removal(self):
        det = AnomalyDetector()
        det.observe({"w": snap("w", health="healthy")})
        det.observe({"w": snap("w", health="unhealthy")})
        out = det.observe({"w": snap("w", health="healthy")})
        assert [(a.kind, a.resolved) for a in out] == [("unhealthy", True)]
        det.observe({"w": snap("w", health="unhealthy")})
        det._active.add(("w", "unhealthy"))
        out = det.observe({})
        assert ("unhealthy", True) in [(a.kind, a.resolved) for a in out]

    def test_inventory_attribution(self):
        s = ContainerSnapshot(
            name="p-s-web", state="running", image="web:1",
            labels=(("fleetflow.project", "p"), ("fleetflow.service", "web"),
                    ("fleetflow.stage", "s")))
        rows = inventory_report({"p-s-web": s})
        assert rows[0]["project"] == "p" and rows[0]["service"] == "web"

    def test_reports_are_counted(self):
        kinds = REGISTRY.get("fleet_agent_anomalies_total")
        resolved = REGISTRY.get("fleet_agent_anomalies_resolved_total")
        b0, r0 = kinds.value(kind="unhealthy"), resolved.value(
            kind="unhealthy")
        det = AnomalyDetector()
        det.observe({"w": snap("w", health="unhealthy")})
        det.observe({"w": snap("w", health="healthy")})
        assert kinds.value(kind="unhealthy") == b0 + 1
        assert resolved.value(kind="unhealthy") == r0 + 1


class TestGuards:
    def test_compose_allowlist(self):
        assert validate_compose_command(["up", "-d"]) == ["up", "-d"]
        for bad in (["exec", "sh"], ["up", "-f", "/etc/evil.yaml"],
                    ["up", "--file=/etc/evil.yaml"],
                    ["up", "-H", "tcp://evil:2375"], [], ["up", "-x;y"]):
            with pytest.raises(GuardError):
                validate_compose_command(bad)

    def test_path_confinement(self, tmp_path):
        base = tmp_path / "deploys"
        base.mkdir()
        assert confine_path("proj/a", str(base)) == \
            (base / "proj/a").resolve()
        with pytest.raises(GuardError):
            confine_path("../../etc/passwd", str(base))
        with pytest.raises(GuardError):
            confine_path("/etc/passwd", str(base))
        (base / "link").symlink_to("/etc")
        with pytest.raises(GuardError):
            confine_path("link/passwd", str(base))

    def test_container_name(self):
        assert validate_container_name("proj-live-db") == "proj-live-db"
        for bad in ("a; rm -rf /", "", "-lead", "x" * 200, "has space"):
            with pytest.raises(GuardError):
                validate_container_name(bad)

    @pytest.mark.parametrize("fn,cases", [
        ("validate_compose_command",
         [["up", "-d"], ["down", "--remove-orphans"], ["ps"], ["exec"],
          ["up", "--project-directory=/"], ["logs", "-f"], ["up", "--x=1"],
          ["restart", "--context", "c"], ["pull", "---a"]]),
        ("validate_container_name",
         ["a", "A.b_c-d", "9x", "_x", "x" * 128, "x" * 129, "a/b", "é"]),
    ])
    def test_guards_equal(self, fn, cases):
        port_fn = globals()[fn]
        ref_fn = getattr(ref_guard, fn)
        for c in cases:
            def outcome(f):
                try:
                    return ("ok", f(c))
                except Exception as e:   # noqa: BLE001 - compared
                    return ("error", str(e))
            assert outcome(port_fn) == outcome(ref_fn), c


# --------------------------------------------------------------------------
# a real port agent against the port's control plane on a socket
# --------------------------------------------------------------------------

def make_agent(handle, slug="node-1", agent_kw=None, backend=None, **kw):
    backend = backend if backend is not None else MockBackend(auto_pull=True)
    cfg = AgentConfig(cp_host=handle.host, cp_port=handle.port, slug=slug,
                      heartbeat_interval_s=0.05, monitor_interval_s=0.05,
                      capacity={"cpu": 8, "memory": 16384, "disk": 100000},
                      **kw)
    return Agent(cfg, backend=backend, sleep=lambda d: None,
                 **(agent_kw or {})), backend


async def execute(handle, flow, stage="local", timeout=20, **extra):
    cli, task = await ProtocolClient.connect(handle.host, handle.port,
                                             identity="cli")
    try:
        req = DeployRequest(flow=flow, stage_name=stage)
        return await cli.request("deploy", "execute",
                                 {"request": req.to_dict(), **extra},
                                 timeout=timeout)
    finally:
        await cli.close()
        task.cancel()


class TestAgentSession:
    def test_register_heartbeat_inventory(self, project):
        async def go():
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            s = handle.state.store.server_by_slug("node-1")
            assert s is not None and s.status == "online"
            assert s.capacity.cpu == 8
            backend.images.add("x:1")
            backend.create(ContainerConfig(
                name="c1", image="x:1",
                labels={"fleetflow.project": "p", "fleetflow.stage": "s",
                        "fleetflow.service": "c"}))
            backend.start("c1")
            for _ in range(100):
                await asyncio.sleep(0.02)
                if handle.state.store.observed_on("node-1"):
                    break
            obs = handle.state.store.observed_on("node-1")
            assert [o.name for o in obs] == ["c1"]
            assert obs[0].project == "p"
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_cp_routed_deploy_executes_on_agent(self, project):
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            out = await execute(handle, flow)
            assert out["deployment"]["status"] == "succeeded"
            assert sorted(backend.containers) == [
                "testproj-local-app", "testproj-local-postgres",
                "testproj-local-redis"]
            assert "logs/node-1/deploy/local" in \
                handle.state.log_router.topics()
            assert handle.state.store.server_by_slug(
                "node-1").allocated.cpu > 0
            pl = handle.state.placement.snapshot()["testproj/local"]
            assert pl["source"] == "gpu-anneal"
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_cp_routed_quadlet_deploy(self, project, tmp_path):
        async def go():
            flow = local_flow(project, backend=Backend.QUADLET)
            handle = await start(ServerConfig(**CPU))
            calls = []

            def systemctl(args):
                calls.append(tuple(args))
                return 0, ""

            agent, backend = make_agent(
                handle, quadlet_unit_dir=str(tmp_path / "units"),
                agent_kw={"systemctl": systemctl})
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            out = await execute(handle, flow)
            assert out["deployment"]["status"] == "succeeded"
            units = sorted(p.name for p in (tmp_path / "units").iterdir())
            assert "testproj-local-app.container" in units
            assert any(u.endswith(".network") for u in units)
            assert backend.containers == {}
            assert ("daemon-reload",) in calls
            assert len([c for c in calls if c[0] == "start"]) == 3
            lines = [e.line for e in handle.state.log_router.retained(
                "logs/node-1/deploy/local")]
            assert any(ln.startswith("started ") for ln in lines)
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_cp_routed_compose_deploy(self, project, tmp_path):
        async def go():
            flow = local_flow(project, backend=Backend.COMPOSE)
            handle = await start(ServerConfig(**CPU))
            cmds = []

            def runner(argv):
                cmds.append(argv)
                return 0, "Container app  Started"

            agent, backend = make_agent(
                handle, deploy_base=str(tmp_path / "deploys"),
                agent_kw={"compose_runner": runner})
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            out = await execute(handle, flow)
            assert out["deployment"]["status"] == "succeeded"
            assert cmds and cmds[0][:2] == ["docker", "compose"]
            assert cmds[0][-3:] == ["up", "-d", "--remove-orphans"]
            written = list((tmp_path / "deploys").rglob("compose.*.yaml"))
            assert len(written) == 1
            assert "postgres" in written[0].read_text()
            assert backend.containers == {}
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_quadlet_failure_marks_deployment_failed(self, project,
                                                     tmp_path):
        async def go():
            flow = local_flow(project, backend=Backend.QUADLET)
            handle = await start(ServerConfig(**CPU))

            def systemctl(args):
                if args[0] == "start" and "app" in args[1]:
                    return 1, "unit entered failed state"
                return 0, ""

            agent, _ = make_agent(
                handle, quadlet_unit_dir=str(tmp_path / "units"),
                agent_kw={"systemctl": systemctl})
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            with pytest.raises(Exception, match="quadlet apply failed"):
                await execute(handle, flow)
            deps = handle.state.store.deployment_history()
            assert deps and deps[0].status == "failed"
            assert "quadlet" in deps[0].error
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_deploy_logs_stream_live(self, project):
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))

            class SlowBackend(MockBackend):
                def start(self, name):
                    time.sleep(0.15)
                    return super().start(name)

            agent, backend = make_agent(handle,
                                        backend=SlowBackend(auto_pull=True))
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            deploy = asyncio.ensure_future(execute(handle, flow))
            topic = "logs/node-1/deploy/local"
            for _ in range(200):
                if handle.state.log_router.retained(topic):
                    break
                await asyncio.sleep(0.01)
            assert handle.state.log_router.retained(topic)
            deps = handle.state.store.deployment_history()
            assert deps and deps[0].status == "running"
            out = await deploy
            assert out["deployment"]["status"] == "succeeded"
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_restart_command_and_anomaly_alert(self, project):
        async def go():
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            backend.images.add("x:1")
            backend.create(ContainerConfig(name="c1", image="x:1"))
            backend.start("c1")
            out = await handle.state.agent_registry.send_command(
                "node-1", "restart", {"container": "c1"}, timeout=5)
            assert out["restarted"] == "c1"
            assert backend.containers["c1"].restart_count == 1
            for cmd, key in (("stop", "stopped"), ("start", "started")):
                out = await handle.state.agent_registry.send_command(
                    "node-1", cmd, {"container": "c1"}, timeout=5)
                assert out[key] == "c1"
            status = await handle.state.agent_registry.send_command(
                "node-1", "status", {}, timeout=5)
            assert [c["name"] for c in status["containers"]] == ["c1"]
            await agent.monitor_once()
            backend.set_state("c1", "dead")
            await agent.monitor_once()
            await asyncio.sleep(0.1)
            kinds = [a.kind for a in handle.state.store.active_alerts()]
            assert "unexpected_stop" in kinds
            with pytest.raises(Exception, match="unknown agent command"):
                await handle.state.agent_registry.send_command(
                    "node-1", "teleport", {}, timeout=5)
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())

    def test_reconnect_after_cp_restart(self, project, monkeypatch):
        import fleetflow_tpu_torch.agent.agent as agent_mod
        monkeypatch.setattr(agent_mod, "RECONNECT_BACKOFF_S", 0.05)

        async def go():
            handle = await start(ServerConfig(**CPU))
            port = handle.port
            agent, _ = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            await handle.stop()
            await asyncio.sleep(0.1)
            handle2 = await start(ServerConfig(port=port, **CPU))
            for _ in range(200):
                await asyncio.sleep(0.02)
                if handle2.state.agent_registry.is_connected("node-1"):
                    break
            assert handle2.state.agent_registry.is_connected("node-1")
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle2.stop()
        run(go())

    def test_idempotent_redelivery_runs_once(self, project):
        """A redelivered keyed command is answered from the agent's window;
        a failed one is not cached and runs again."""
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            reg = handle.state.agent_registry
            replays = REGISTRY.get("fleet_agent_idempotent_replays_total")
            before = replays.value()
            payload = {"request": DeployRequest(
                flow=flow, stage_name="local").to_dict(),
                "assignment": {s: "node-1"
                               for s in flow.stages["local"].services},
                "idempotency_key": "k-1"}
            first = await reg.send_command("node-1", "deploy.execute",
                                           payload, timeout=10)
            calls = len(backend.calls)
            again = await reg.send_command("node-1", "deploy.execute",
                                           payload, timeout=10)
            assert again == first and len(backend.calls) == calls
            assert replays.value() == before + 1
            bad = {"container": "evil; rm", "idempotency_key": "k-2"}
            for _ in range(2):
                with pytest.raises(Exception, match="invalid container"):
                    await reg.send_command("node-1", "restart", bad,
                                           timeout=10)
            assert replays.value() == before + 1
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()
        run(go())


class TestAgentBuild:
    """_run_build: git clone -> docker build -> optional push, with paths
    confined to the fresh clone. Docker is faked with a PATH shim; git is
    real."""

    def _agent(self, tmp_path):
        cfg = AgentConfig(slug="builder",
                          deploy_base=str(tmp_path / "deploys"))
        return Agent(cfg, backend=MockBackend(auto_pull=True))

    def _repo(self, tmp_path):
        import subprocess
        repo = tmp_path / "src"
        repo.mkdir()
        (repo / "Dockerfile").write_text("FROM scratch\n")
        (repo / "app.txt").write_text("hello\n")
        for cmd in (["git", "init", "-q", "-b", "main"],
                    ["git", "add", "."],
                    ["git", "-c", "user.email=t@t", "-c", "user.name=t",
                     "commit", "-q", "-m", "init"]):
            subprocess.run(cmd, cwd=repo, check=True, capture_output=True)
        return str(repo)

    def _fake_docker(self, tmp_path, monkeypatch, rc=0):
        import os
        bindir = tmp_path / "bin"
        bindir.mkdir(exist_ok=True)
        log = tmp_path / "docker.log"
        sh = bindir / "docker"
        sh.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n"
                      f"echo built-layer-ok\nexit {rc}\n")
        sh.chmod(0o755)
        monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
        return log

    def test_build_clone_and_docker_invocation(self, tmp_path, monkeypatch):
        log = self._fake_docker(tmp_path, monkeypatch)
        agent = self._agent(tmp_path)
        out = run(agent.execute_command("build", {
            "repo": self._repo(tmp_path), "image_tag": "acme/app:1",
            "push": True, "dockerfile": "Dockerfile"}))
        assert out["image"] == "acme/app:1"
        assert "built-layer-ok" in out["log"]
        calls = log.read_text().splitlines()
        assert calls[0].startswith("build -t acme/app:1 -f ")
        assert calls[1] == "push acme/app:1"
        base = tmp_path / "deploys"
        assert base.is_dir() and list(base.iterdir()) == []

    def test_build_confines_context_to_clone(self, tmp_path, monkeypatch):
        self._fake_docker(tmp_path, monkeypatch)
        agent = self._agent(tmp_path)
        with pytest.raises(Exception, match="escapes|confine|outside"):
            run(agent.execute_command("build", {
                "repo": self._repo(tmp_path), "image_tag": "x:1",
                "context": "../../etc"}))

    def test_build_failure_surfaces_stderr(self, tmp_path, monkeypatch):
        self._fake_docker(tmp_path, monkeypatch, rc=1)
        agent = self._agent(tmp_path)
        with pytest.raises(RuntimeError, match="docker build failed"):
            run(agent.execute_command("build", {
                "repo": self._repo(tmp_path), "image_tag": "x:1"}))

    def test_clone_failure_surfaces(self, tmp_path, monkeypatch):
        self._fake_docker(tmp_path, monkeypatch)
        agent = self._agent(tmp_path)
        with pytest.raises(RuntimeError, match="git clone failed"):
            run(agent.execute_command("build", {
                "repo": str(tmp_path / "no-such-repo"), "image_tag": "x:1"}))


class TestCpRoutedDown:
    def test_down_removes_containers_and_releases_capacity(self, project):
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["deployment"]["status"] == "succeeded"
            assert backend.containers
            assert handle.state.store.server_by_slug(
                "node-1").allocated.cpu > 0
            out = await cli.request("deploy", "down",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["ok"], out
            assert out["nodes"]["node-1"]["backend"] == "docker"
            assert len(out["nodes"]["node-1"]["removed"]) == 3
            assert backend.containers == {}
            assert handle.state.store.server_by_slug(
                "node-1").allocated.cpu == 0
            stage = handle.state.store.list("stages")[0]
            for svc in handle.state.store.services_of(stage.id):
                assert svc.status == "removed"
            lines = [e.line for e in handle.state.log_router.retained(
                "logs/node-1/deploy/local")]
            assert any("remove" in ln for ln in lines)
            agent.stop()
            await asyncio.wait_for(task, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())

    @pytest.mark.parametrize("kind", [Backend.QUADLET, Backend.COMPOSE])
    def test_backend_down_via_cp(self, project, tmp_path, kind):
        async def go():
            flow = local_flow(project, backend=kind)
            handle = await start(ServerConfig(**CPU))
            calls = []

            def shell(args):
                calls.append(tuple(args))
                return 0, ""

            agent, backend = make_agent(
                handle, quadlet_unit_dir=str(tmp_path / "units"),
                deploy_base=str(tmp_path / "deploys"),
                agent_kw={"systemctl": shell, "compose_runner": shell})
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["deployment"]["status"] == "succeeded"
            calls.clear()
            out = await cli.request("deploy", "down",
                                    {"request": req.to_dict(),
                                     "remove": True}, timeout=20)
            assert out["ok"], out
            assert out["nodes"]["node-1"]["backend"] == kind.value
            if kind is Backend.QUADLET:
                assert len([c for c in calls if c[0] == "stop"]) >= 3
                assert [p.name for p in (tmp_path / "units").iterdir()] == []
            else:
                assert calls[0][-2:] == ("down", "--remove-orphans")
            agent.stop()
            await asyncio.wait_for(task, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())

    def test_down_with_disconnected_placed_server_refuses_release(
            self, project):
        async def go():
            flow = local_flow(project, servers=("node-1", "node-2",
                                                "node-3"))
            handle = await start(ServerConfig(**CPU))
            agent1, b1 = make_agent(handle)
            agent2, b2 = make_agent(handle, slug="node-2")
            t1 = asyncio.ensure_future(agent1.run())
            t2 = asyncio.ensure_future(agent2.run())
            await wait_connected(handle, "node-1", "node-2")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["deployment"]["status"] == "succeeded"
            placed_nodes = set(
                handle.state.store.deployment_history(limit=1)[0]
                .placement.values())
            assert placed_nodes <= {"node-1", "node-2"}
            agent2.stop()
            await asyncio.wait_for(t2, 5)
            while handle.state.agent_registry.is_connected("node-2"):
                await asyncio.sleep(0.02)
            out = await cli.request("deploy", "down",
                                    {"request": req.to_dict()}, timeout=20)
            if "node-2" in placed_nodes:
                assert not out["ok"]
                assert out["failed_nodes"] == ["node-2"]
                assert "not connected" in out["nodes"]["node-2"]
                assert "node-3" not in out["nodes"]
            else:
                assert out["ok"], out
            agent1.stop()
            await asyncio.wait_for(t1, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())

    def test_down_records_history_and_tenant(self, project):
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            await cli.request("deploy", "execute",
                              {"request": req.to_dict(),
                               "tenant": "acme"}, timeout=20)
            out = await cli.request("deploy", "down",
                                    {"request": req.to_dict(),
                                     "tenant": "acme"}, timeout=20)
            assert out["ok"]
            assert out["deployment"]["status"] == "succeeded"
            assert out["deployment"]["tenant"] == "acme"
            assert len(handle.state.store.list("projects")) == 1
            assert len(handle.state.store.list("stages")) == 1
            agent.stop()
            await asyncio.wait_for(task, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())

    def test_cp_local_deployed_stage_tears_down_cp_locally(self, project):
        async def go():
            flow = local_flow(project)
            cp_backend = MockBackend(auto_pull=True)
            handle = await start(ServerConfig(**CPU),
                                 backend_factory=lambda: cp_backend,
                                 deploy_sleep=lambda d: None)
            out = await execute(handle, flow)
            assert out["deployment"]["status"] == "succeeded"
            assert cp_backend.containers
            agent, agent_backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            out = await cli.request("deploy", "down",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["ok"], out
            assert "(cp-local)" in out["nodes"]
            assert cp_backend.containers == {}
            assert agent_backend.containers == {}
            agent.stop()
            await asyncio.wait_for(task, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())

    def test_down_after_redeploy_resets_placement_story(self, project):
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            for _ in range(2):
                out = await cli.request("deploy", "execute",
                                        {"request": req.to_dict()},
                                        timeout=20)
                assert out["deployment"]["status"] == "succeeded"
                out = await cli.request("deploy", "down",
                                        {"request": req.to_dict()},
                                        timeout=20)
                assert out["ok"], out
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["deployment"]["status"] == "succeeded"
            alloc = handle.state.store.server_by_slug("node-1").allocated.cpu
            assert alloc > 0
            treq = DeployRequest(flow=flow, stage_name="local",
                                 target_services=["app"])
            out = await cli.request("deploy", "down",
                                    {"request": treq.to_dict()}, timeout=20)
            assert out["ok"], out
            assert (handle.state.store.server_by_slug("node-1")
                    .allocated.cpu == alloc)
            stage = handle.state.store.list("stages")[0]
            statuses = {s.name: s.status
                        for s in handle.state.store.services_of(stage.id)}
            assert statuses["app"] == "removed"
            assert statuses["postgres"] == "deployed"
            agent.stop()
            await asyncio.wait_for(task, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())


class TestRemoteContainers:
    def test_logs_live_and_restart_routed_to_owning_node(self, project):
        async def go():
            flow = local_flow(project)
            handle = await start(ServerConfig(**CPU))
            agent, backend = make_agent(handle)
            backend.logs = lambda name, tail=100, since=None: \
                f"hello from {name} (tail={tail})\n"
            task = asyncio.ensure_future(agent.run())
            await wait_connected(handle, "node-1")
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="local")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=20)
            assert out["deployment"]["status"] == "succeeded"
            out = await cli.request("container", "logs.live",
                                    {"server": "node-1",
                                     "container": "testproj-local-app",
                                     "tail": 7}, timeout=10)
            assert out["logs"] == "hello from testproj-local-app (tail=7)\n"
            with pytest.raises(RpcError):
                await cli.request("container", "logs.live",
                                  {"server": "node-1",
                                   "container": "evil; rm -rf /"},
                                  timeout=10)
            before = len(backend.calls)
            out = await cli.request("container", "restart",
                                    {"server": "node-1",
                                     "container": "testproj-local-app"},
                                    timeout=10)
            assert out["result"]["restarted"] == "testproj-local-app"
            assert ("restart", "testproj-local-app") in \
                backend.calls[before:]
            pong = await cli.request("server", "ping", {"slug": "node-1"})
            assert pong["ok"] and pong["result"]["pong"]
            agent.stop()
            await asyncio.wait_for(task, 5)
            await cli.close()
            ctask.cancel()
            await handle.stop()
        run(go())


# --------------------------------------------------------------------------
# the reference tests that waited for an agent
# --------------------------------------------------------------------------

class _CaptureConn:
    def __init__(self):
        self.replies = []

    async def send_event(self, channel, method, payload):
        self.replies.append((method, payload))


class TestAgentFencing:
    def test_stale_epoch_command_is_refused(self):
        async def go():
            agent = Agent(AgentConfig(slug="n1"),
                          backend=MockBackend(auto_pull=True),
                          sleep=lambda d: None)
            conn = _CaptureConn()
            await agent._on_command(conn, "ping",
                                    {"request_id": "r1", "epoch": 3,
                                     "payload": {}})
            assert conn.replies[0][1]["result"]["pong"] is True
            fenced = REGISTRY.get("fleet_replication_fencing_rejections_total")
            before = fenced.value(side="agent")
            await agent._on_command(conn, "ping",
                                    {"request_id": "r2", "epoch": 2,
                                     "payload": {}})
            assert "fenced" in conn.replies[1][1]["error"]
            assert fenced.value(side="agent") == before + 1
            await agent._on_command(conn, "ping",
                                    {"request_id": "r3", "epoch": 3,
                                     "payload": {}})
            assert conn.replies[2][1]["result"]["pong"] is True
        run(go())

    def test_zombie_cp_welcome_is_refused(self):
        async def go():
            handle = await start(ServerConfig(self_heal=False, **CPU))
            agent = Agent(AgentConfig(cp_host=handle.host,
                                      cp_port=handle.port, slug="n1"),
                          backend=MockBackend(auto_pull=True),
                          sleep=lambda d: None)
            agent._max_epoch = 5
            with pytest.raises(RuntimeError, match="zombie"):
                await agent.run_session()
            assert not handle.state.agent_registry.is_connected("n1")
            await handle.stop()
        run(go())


def _heal_flow(name: str) -> Flow:
    flow = Flow(name=name)
    flow.services["web"] = Service(
        name="web", image="app", version="1",
        resources=ResourceSpec(cpu=0.5, memory=128.0))
    flow.stages["main"] = Stage(name="main", services=["web"],
                                servers=["node-1", "node-2"])
    return flow


async def _poll(cond, what: str, timeout: float = 20.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if cond():
            return
        await asyncio.sleep(0.02)
    pytest.fail(what)


class TestCpFailoverE2E:
    def test_primary_killed_mid_redelivery_heals_via_standby(self):
        flow = _heal_flow("repldemo")

        async def go():
            fast = dict(self_heal=True, lease_s=0.4, suspect_grace_s=0.15,
                        heal_interval_s=0.05, heal_backoff_base_s=0.2,
                        heal_backoff_max_s=0.4, heal_max_attempts=50,
                        standby_ping_interval_s=0.05, standby_lease_s=0.4,
                        standby_grace_s=0.15, **CPU)
            primary = await start(
                ServerConfig(**fast),
                backend_factory=lambda: MockBackend(auto_pull=True))
            standby = await start(
                ServerConfig(name="cp-b",
                             standby_of=f"{primary.host}:{primary.port}",
                             **fast),
                backend_factory=lambda: MockBackend(auto_pull=True))
            backends, agents, tasks, executed = {}, {}, {}, []
            for slug in ("node-1", "node-2"):
                backends[slug] = MockBackend(auto_pull=True)
                cfg = AgentConfig(
                    cp_endpoints=[(primary.host, primary.port),
                                  (standby.host, standby.port)],
                    slug=slug, heartbeat_interval_s=0.05,
                    monitor_interval_s=30.0, reconnect_backoff_s=0.05,
                    capacity={"cpu": 4, "memory": 8192, "disk": 100000})
                agent = Agent(cfg, backend=backends[slug],
                              sleep=lambda d: None)
                orig_exec = agent.execute_command

                async def spy_exec(method, payload, _slug=slug,
                                   _orig=orig_exec):
                    if (method == "deploy.execute"
                            and payload.get("idempotency_key")):
                        executed.append((_slug, dict(payload)))
                    return await _orig(method, payload)
                agent.execute_command = spy_exec
                agents[slug] = agent
                tasks[slug] = asyncio.ensure_future(agent.run())
            await wait_connected(primary, *agents)

            cli, ctask = await ProtocolClient.connect(
                primary.host, primary.port, identity="cli")
            assert cli.welcome["epoch"] == 1
            req = DeployRequest(flow=flow, stage_name="main")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=30)
            assert out["deployment"]["status"] == "succeeded"
            victim = out["deployment"]["placement"]["web"]
            survivor = "node-2" if victim == "node-1" else "node-1"
            cname = container_name("repldemo", "main", "web")
            assert backends[victim].inspect(cname).running

            def refuse(slug, command):
                if command == "deploy.execute":
                    raise ControlPlaneError("wire cut (chaos)")
            primary.state.agent_registry.delivery_hook = refuse
            agents[victim].stop()
            rc = primary.state.reconverger
            await _poll(lambda: any(w["attempt"] >= 1
                                    for w in rc.status()["work"]),
                        f"no in-flight redelivery: {rc.status()}")
            await cli.close()
            ctask.cancel()
            await primary.stop()
            await _poll(lambda: standby.state.replication_role == "primary",
                        "standby never promoted")
            assert standby.state.store.epoch == 2

            def healed():
                info = backends[survivor].inspect(cname)
                return info is not None and info.running
            await _poll(healed, f"service never healed onto {survivor}")
            survivor_execs = [p for s, p in executed if s == survivor]
            assert len(survivor_execs) == 1, survivor_execs
            replays = REGISTRY.get("fleet_agent_idempotent_replays_total")
            before = replays.value()
            await standby.state.agent_registry.send_command(
                survivor, "deploy.execute", survivor_execs[0], timeout=30)
            assert replays.value() == before + 1
            assert len([p for s, p in executed if s == survivor]) == 1

            fenced = REGISTRY.get(
                "fleet_replication_fencing_rejections_total")
            before_cp = fenced.value(side="cp")
            zombie, ztask = await ProtocolClient.connect(
                standby.host, standby.port, identity="old-primary")
            with pytest.raises(RpcError, match="fenced"):
                await zombie.request("replication", "append", {
                    "epoch": 1, "entries": [[standby.state.store.seq + 1,
                                             '{"op": "del", "t": '
                                             '"tenants", "id": "x", '
                                             '"q": 1, "e": 1}']]})
            assert fenced.value(side="cp") == before_cp + 1
            await zombie.close()
            ztask.cancel()
            cli2, ctask2 = await ProtocolClient.connect(
                standby.host, standby.port, identity="cli2")
            assert cli2.welcome["role"] == "primary"
            assert cli2.welcome["epoch"] == 2
            status = await cli2.request("health", "heal.status")
            assert status["replication"]["role"] == "primary"
            assert status["work"] == []
            await cli2.close()
            ctask2.cancel()
            for agent in agents.values():
                agent.stop()
            for t in tasks.values():
                try:
                    await asyncio.wait_for(t, 5)
                except asyncio.TimeoutError:
                    t.cancel()
            await standby.stop()
        run(go(), timeout=60)


class TestSelfHealE2E:
    def test_kill_one_agent_heals_on_survivor(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLEET_TRACE_FILE", str(tmp_path / "flight.jsonl"))
        flow = _heal_flow("healdemo")

        async def go():
            handle = await start(ServerConfig(
                self_heal=True, lease_s=0.4, suspect_grace_s=0.15,
                heal_interval_s=0.05, heal_backoff_base_s=0.05,
                heal_backoff_max_s=0.2, **CPU),
                backend_factory=lambda: MockBackend(auto_pull=True))
            backends, agents, tasks = {}, {}, {}
            for slug in ("node-1", "node-2"):
                backends[slug] = MockBackend(auto_pull=True)
                cfg = AgentConfig(
                    cp_host=handle.host, cp_port=handle.port, slug=slug,
                    heartbeat_interval_s=0.05, monitor_interval_s=30.0,
                    capacity={"cpu": 4, "memory": 8192, "disk": 100000})
                agents[slug] = Agent(cfg, backend=backends[slug],
                                     sleep=lambda d: None)
                tasks[slug] = asyncio.ensure_future(agents[slug].run())
            await wait_connected(handle, *agents)
            sent = []
            orig_send = handle.state.agent_registry.send_command
            orig_batch = handle.state.agent_registry.send_batch

            async def spy(slug, command, payload=None, timeout=60.0):
                sent.append((slug, command, dict(payload or {})))
                return await orig_send(slug, command, payload,
                                       timeout=timeout)

            async def spy_batch(items, timeout=60.0):
                for slug, command, payload in items:
                    sent.append((slug, command, dict(payload or {})))
                return await orig_batch(items, timeout=timeout)
            handle.state.agent_registry.send_command = spy
            handle.state.agent_registry.send_batch = spy_batch

            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            req = DeployRequest(flow=flow, stage_name="main")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=30)
            assert out["deployment"]["status"] == "succeeded"
            victim = out["deployment"]["placement"]["web"]
            survivor = "node-2" if victim == "node-1" else "node-1"
            cname = container_name("healdemo", "main", "web")
            assert backends[victim].inspect(cname).running
            agents[victim].stop()

            def heal_records():
                return [d for d in handle.state.store.list("deployments")
                        if d.log.startswith("self-heal")]

            def healed():
                # the container runs before the CP records the heal: wait
                # for both
                info = backends[survivor].inspect(cname)
                return (info is not None and info.running
                        and bool(heal_records()))
            await _poll(healed, f"service never healed onto {survivor}")
            heals = [(s, p) for s, c, p in sent
                     if c == "deploy.execute" and p.get("idempotency_key")]
            assert heals and all(s == survivor for s, _ in heals)
            assert heals[0][1]["idempotency_key"].startswith(
                "heal-healdemo/main-")
            heal_deps = heal_records()
            assert heal_deps and heal_deps[-1].placement == {
                "web": survivor}
            replays = REGISTRY.get("fleet_agent_idempotent_replays_total")
            before = replays.value()
            r1 = await orig_send(survivor, "deploy.execute",
                                 dict(heals[0][1]), timeout=30)
            assert replays.value() == before + 1
            assert r1.get("deployed") == ["healdemo-main-web"]
            status = await cli.request("health", "heal.status")
            assert status["enabled"] is True and status["work"] == []
            src = handle.state.placement.snapshot()["healdemo/main"]
            assert src["source"] == "gpu-anneal"
            await cli.close()
            ctask.cancel()
            for slug, agent in agents.items():
                agent.stop()
                await asyncio.wait_for(tasks[slug], 5)
            await handle.stop()
        run(go(), timeout=60)


def test_heartbeat_ships_agent_labeled_series():
    async def go():
        handle = await start(
            ServerConfig(collector_interval_s=0.05, **CPU),
            backend_factory=lambda: MockBackend(auto_pull=True))
        agent = Agent(
            AgentConfig(cp_host=handle.host, cp_port=handle.port,
                        slug="node-1", heartbeat_interval_s=0.05,
                        monitor_interval_s=0.05,
                        capacity={"cpu": 8, "memory": 16384,
                                  "disk": 100000}),
            backend=MockBackend(auto_pull=True), sleep=lambda d: None)
        task = asyncio.ensure_future(agent.run())
        try:
            coll = handle.state.collector
            for _ in range(200):
                if coll.tsdb.match(labels={"agent": "node-1"}):
                    break
                await asyncio.sleep(0.02)
            cli, ctask = await ProtocolClient.connect(
                handle.host, handle.port, identity="cli")
            out = await cli.request(
                "health", "obs.query",
                {"window_s": 60.0, "labels": {"agent": "node-1"}})
            await cli.close()
            ctask.cancel()
            return out, coll.status()
        finally:
            agent.stop()
            await asyncio.wait_for(task, 5)
            await handle.stop()

    out, status = run(go())
    assert out["enabled"]
    rows = [r for r in out["series"] if r["labels"].get("agent") == "node-1"]
    assert rows, "no agent-labeled series reached the CP TSDB"
    assert all(r["labels"]["agent"] == "node-1" for r in out["series"])
    assert status["agents"] == ["node-1"]


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def test_port_agent_with_the_reference_server(project):
    """A port Agent registers with the reference's server (its default
    host solver) and executes the deploy the reference places."""
    from fleetflow_tpu.cp import ServerConfig as RefConfig
    from fleetflow_tpu.cp import start as ref_start
    from fleetflow_tpu.core.loader import \
        load_project_from_root_with_stage as ref_load
    from fleetflow_tpu.cp.protocol import ProtocolClient as RefClient
    from fleetflow_tpu.runtime import DeployRequest as RefRequest

    async def go():
        root, _ = project
        flow = ref_load(str(root), "local")
        flow.stages["local"].servers = ["node-1"]
        handle = await ref_start(RefConfig())
        agent, backend = make_agent(handle)
        task = asyncio.ensure_future(agent.run())
        await wait_connected(handle, "node-1")
        assert handle.state.store.server_by_slug("node-1").capacity.cpu == 8
        cli, ctask = await RefClient.connect(handle.host, handle.port,
                                             identity="cli")
        out = await cli.request("deploy", "execute", {
            "request": RefRequest(flow=flow, stage_name="local").to_dict()},
            timeout=20)
        assert out["deployment"]["status"] == "succeeded"
        assert sorted(backend.containers) == [
            "testproj-local-app", "testproj-local-postgres",
            "testproj-local-redis"]
        out = await cli.request("container", "restart",
                                {"server": "node-1",
                                 "container": "testproj-local-app"},
                                timeout=10)
        assert out["result"]["restarted"] == "testproj-local-app"
        await cli.close()
        ctask.cancel()
        agent.stop()
        await asyncio.wait_for(task, 5)
        await handle.stop()
    run(go())


def test_reference_agent_with_the_port_server(project):
    """A reference Agent registers with the port's server (the card
    scheduler on the CPU) and executes the deploy the port places."""
    from fleetflow_tpu.agent import Agent as RefAgent
    from fleetflow_tpu.agent import AgentConfig as RefAgentConfig
    from fleetflow_tpu.runtime import MockBackend as RefBackend

    async def go():
        flow = local_flow(project)
        handle = await start(ServerConfig(**CPU))
        backend = RefBackend(auto_pull=True)
        agent = RefAgent(RefAgentConfig(
            cp_host=handle.host, cp_port=handle.port, slug="node-1",
            heartbeat_interval_s=0.05, monitor_interval_s=0.05,
            capacity={"cpu": 8, "memory": 16384, "disk": 100000}),
            backend=backend, sleep=lambda d: None)
        task = asyncio.ensure_future(agent.run())
        await wait_connected(handle, "node-1")
        out = await execute(handle, flow)
        assert out["deployment"]["status"] == "succeeded"
        assert sorted(backend.containers) == [
            "testproj-local-app", "testproj-local-postgres",
            "testproj-local-redis"]
        assert handle.state.placement.snapshot()["testproj/local"][
            "source"] == "gpu-anneal"
        for _ in range(100):
            if handle.state.store.observed_on("node-1"):
                break
            await asyncio.sleep(0.02)
        assert len(handle.state.store.observed_on("node-1")) == 3
        agent.stop()
        await asyncio.wait_for(task, 5)
        await handle.stop()
    run(go())


# --------------------------------------------------------------------------
# chip_smoke's [agent] phase at a small size
# --------------------------------------------------------------------------

def test_agent_phase_rehearsal(tmp_path, monkeypatch, capsys):
    """[agent] with the card scheduler's plain versions: 6 agents, a
    40-service deploy, the heal, the quadlet and compose stages, restart,
    ping and status, with every check of the phase held."""
    import json

    import torch

    from fleetflow_tpu_torch import _ext
    from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
    from fleetflow_tpu_torch.solver.repair import verify
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda torch, _ext, tag, path, off=(), size=None:
                        dict(_ext.LAUNCHES))
    place = GpuSolverScheduler.place
    out = chip_smoke.run_agent_phase(
        torch, np, _ext, REGISTRY, verify, "cpu", "CARD", device="cpu",
        agents=6, services=40, root=str(tmp_path / "agent"), expect=())
    assert GpuSolverScheduler.place is place
    assert out["budget_s"] == chip_smoke.AGENT_BUDGET_S
    assert out["heal_s"] > 0 and out["deploy_s"] > 0
    rows = [json.loads(ln.split(" ", 1)[1])
            for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[agent] {")]
    rpcs = [r.get("rpc", "") for r in rows]
    for want in ("agent.register x6", "deploy.execute chaosfleet/app0",
                 "deploy.execute quadletfleet/app0",
                 "deploy.execute composefleet/app0"):
        assert want in rpcs, (want, rpcs)
    assert any(r.startswith("heal ") for r in rpcs)
    assert [r["equal"] for r in rows if "backend" in r] == [True, True]
    assert any(r.get("errors") == {} and r.get("command_errors") == 0
               for r in rows)
