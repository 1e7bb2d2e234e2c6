"""The port's control-plane server on its socket
(fleetflow_tpu_torch.cp.start and the channel handlers) against the
reference's (fleetflow_tpu.cp.start), on the CPU.

- the same wire: one event loop runs the reference's server and the
  port's on the host path (``use_gpu_solver=False``); the same RPC
  sequence (tenant, project, stage, server register and list,
  placement.solve, node_events, commit, deploy.execute to fake agents,
  deploy.down, the volume, build, cost, dns, health and replication
  channels) answers with equal replies after ids and timestamps are
  normalised by field; each package's client talks to the other's
  server;
- the reference's server tests (tests/test_cp.py's TestProtocol,
  TestChannels, TestAgentProtocol, TestDeployExecute, TestPlacementChannel,
  TestProvision, TestServerRegisterLabels, TestDeployRunSsh,
  TestHealthAlerts, TestAgentChannelSecurity, TestTenantSecretHygiene,
  TestProtocolRobustness, TestVolumeChannel, TestBuildChannel,
  TestReservationVisibility, TestAgentDeathMidDeploy,
  TestStreamingAdmission; tests/test_collector.py's TestObsChannel; the
  server paths of test_autoscaler.py, test_replication.py and
  test_slo.py) on the reference, the port's host path and the port's card
  scheduler on the CPU (``device="cpu"``);
- the card scheduler under ``start``: every placement RPC solves through
  ``GpuSolverScheduler``, from executor threads; the self-heal end to end
  over the wire (tests/test_selfheal.py's TestSelfHealE2E with the wire
  agents of chip_smoke's [wire]); chip_smoke's [wire] phase rehearsed at a
  small size;
- device faults: a ``KernelError`` from ``solve_stage`` reaches the client
  of placement.solve and deploy.execute as an RpcError naming it, the
  error counter moves, a background loop ended by one is logged and
  ``stop`` returns; ``start(ServerConfig())`` without CUDA raises
  DeviceUnavailable before it listens;
- the host path's TSDB capture equal to the reference's (the chaos
  world's rolling-kill), and the solver package's exports.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import time

import numpy as np
import pytest
import torch

import chip_smoke
from torch_wire_kit import (ALL, HOSTS, PORT, PORT_CARD, REF, FakeAgent,
                            config, connect, ids, load_flow, run, start_cp)


@pytest.fixture(params=ALL, ids=ids(ALL))
def P(request):
    return request.param


@pytest.fixture(params=HOSTS, ids=ids(HOSTS))
def H(request):
    return request.param


# --------------------------------------------------------------------------
# the same wire: one RPC sequence against both packages' servers
# --------------------------------------------------------------------------

_ID = re.compile(r"^[a-z_]+_[0-9a-f]{12}$")
_TIME_KEYS = {"ts", "created_at", "updated_at", "started_at", "finished_at",
              "last_heartbeat", "uptime_s", "exp", "iat", "last_seen",
              "observed_at", "at", "time"}


def normalise(doc, ids_seen=None):
    """Ids (``<prefix>_<12 hex>``) by order of first appearance, times and
    durations by field name, trace ids dropped."""
    ids_seen = {} if ids_seen is None else ids_seen

    def walk(v, key=None):
        if isinstance(v, dict):
            return {k: walk(x, k) for k, x in v.items()
                    if k not in ("trace_id", "trace")}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if key is not None and (key in _TIME_KEYS or key.endswith("_ms")
                                or key.endswith("_s")):
            return "<t>" if v is not None else None
        if isinstance(v, str) and _ID.match(v):
            return ids_seen.setdefault(
                v, f"{v.rsplit('_', 1)[0]}#{len(ids_seen)}")
        if isinstance(v, str):
            return _ID_IN_TEXT.sub(
                lambda m: ids_seen.setdefault(
                    m.group(0), f"{m.group(1)}#{len(ids_seen)}"), v)
        return v
    return walk(doc)


_ID_IN_TEXT = re.compile(r"\b([a-z_]+)_[0-9a-f]{12}\b")


async def _sequence(P, handle, root) -> list:
    """The parity sequence over one server; its replies in order."""
    flow = load_flow(P, root)
    flow.stages["local"].servers = ["node-0", "node-1"]
    agents = [await FakeAgent(P, f"node-{i}").connect(handle)
              for i in range(2)]
    for a in agents:
        a.respond = lambda cmd, p: {"deployed": 3, "cmd": cmd}
    conn, task = await connect(P, handle)
    fd = P.serialize.flow_to_dict(flow)
    req = P.runtime.DeployRequest(flow=flow, stage_name="local").to_dict()
    out = []

    async def call(channel, method, payload=None):
        try:
            reply = await conn.request(channel, method, payload or {},
                                       timeout=30)
            out.append([channel, method, reply])
        except P.protocol.RpcError as e:
            out.append([channel, method, {"error": str(e)}])
        return out[-1][2]

    await call("tenant", "create", {"name": "acme"})
    await call("tenant", "list")
    await call("tenant", "get", {"name": "acme"})
    await call("tenant", "user.add", {"name": "acme", "email": "a@b.c",
                                      "role": "admin"})
    await call("tenant", "user.list", {"name": "acme"})
    p = await call("project", "create", {"tenant": "acme", "name": "web"})
    await call("project", "list", {"tenant": "acme"})
    s = await call("stage", "ensure", {"project": p["project"]["id"],
                                       "name": "live"})
    await call("stage", "adopt", {"stage": s["stage"]["id"]})
    await call("stage", "list", {"project": p["project"]["id"]})
    await call("server", "register", {
        "slug": "web-1", "capacity": {"cpu": 4, "memory": 8192,
                                      "disk": 50000},
        "labels": {"tier": "premium", "region": "tk1", "class": "general"}})
    await call("server", "get", {"slug": "web-1"})
    await call("server", "cordon", {"slug": "web-1"})
    await call("server", "uncordon", {"slug": "web-1"})
    await call("server", "list")
    await call("server", "check_all")
    sol = await call("placement", "solve", {"flow": fd, "stage": "local",
                                            "reserve": True})
    await call("placement", "reservations")
    await call("placement", "commit", {"reservation": sol["reservation"]})
    await call("placement", "explain", {"stage": f"{flow.name}/local",
                                        "service": "app"})
    used = sorted(set(sol["assignment"].values()))
    await call("placement", "node_events", {
        "events": [{"slug": used[0], "online": False}]})
    await call("placement", "node_event", {"slug": used[0],
                                           "online": True})
    await call("placement", "release", {"reservation": "rsv_none"})
    await call("deploy", "execute", {"request": req})
    await call("deploy", "history", {})
    await call("deploy", "down", {"request": req})
    await call("deploy", "admit_status")
    v = await call("volume", "adopt", {"server": "n1", "name": "pgdata",
                                       "tenant": "acme"})
    await call("volume", "snapshot", {"volume": v["volume"]["id"],
                                      "label": "pre"})
    await call("volume", "snapshots", {"volume": v["volume"]["id"]})
    await call("volume", "list", {"server": "n1"})
    b = await call("build", "submit", {"repo": "https://x/y.git",
                                       "image_tag": "y:1"})
    await call("build", "list")
    await call("build", "cancel", {"job": b["job"]["id"]})
    await call("cost", "add", {"tenant": "acme", "month": "2026-07",
                               "amount": 12.5})
    await call("cost", "summary", {"tenant": "acme", "month": "2026-07"})
    await call("cost", "list", {"tenant": "acme"})
    await call("dns", "create", {"zone": "example.com", "name": "app",
                                 "content": "1.2.3.4"})
    await call("dns", "list")
    await call("dns", "sync")
    await call("health", "ping")
    await call("health", "alerts")
    await call("health", "solver.slots")
    await call("health", "slo.status")
    await call("health", "heal.status")
    await call("replication", "status")
    await call("service", "list", {"stage": s["stage"]["id"]})
    await call("container", "ps", {"server": "node-0"})
    await call("nope", "x")
    await call("tenant", "nope")
    for a in agents:
        await a.conn.close()
    await conn.close()
    task.cancel()
    return out


_VOLATILE = {
    # the overview of the heal table carries lease clocks; the slots'
    # idle seconds; a solve's own timings ride the reply's solve_ms
    ("health", "heal.status"), ("health", "slo.status"),
}


class TestSameWire:
    def test_replies_equal_after_normalising(self, project):
        root, _ = project

        async def go():
            handles = [await start_cp(P) for P in HOSTS]
            try:
                return [await _sequence(P, h, root)
                        for P, h in zip(HOSTS, handles)]
            finally:
                for h in handles:
                    await h.stop()
        ref, port = run(go())
        assert [r[:2] for r in ref] == [r[:2] for r in port]
        rid, pid = {}, {}
        for (channel, method, a), (_c, _m, b) in zip(ref, port):
            if (channel, method) in _VOLATILE:
                assert sorted(a) == sorted(b), (channel, method)
                continue
            assert normalise(a, rid) == normalise(b, pid), (channel, method)

    def test_solver_fields_by_name(self, project):
        """placement.solve's reply: the same fields, and the port's host
        path names the reference's host greedy source."""
        root, _ = project

        async def go(P):
            h = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(h)
            conn, task = await connect(P, h)
            out = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(load_flow(P, root)),
                "stage": "local"})
            await agent.conn.close()
            await conn.close()
            task.cancel()
            await h.stop()
            return out
        ref, port = (run(go(P)) for P in HOSTS)
        assert sorted(ref) == sorted(port)
        assert ref["assignment"] == port["assignment"]
        assert ref["source"] == port["source"]

    @pytest.mark.parametrize("server,client", [(REF, PORT), (PORT, REF)],
                             ids=["ref-server", "port-server"])
    def test_cross_clients(self, project, server, client):
        """Either package's client (and fake agent) against the other's
        server: the frames are one protocol."""
        root, _ = project

        async def go():
            h = await start_cp(server, auth_kind="token", auth_secret="s3")
            tok = h.state.auth.issue("op@x", ["admin:all"])
            agent_tok = h.state.auth.issue("agent@node-1", ["write:agent"])
            agent = await FakeAgent(client, "node-1").connect(
                h, token=agent_tok)
            conn, task = await connect(client, h, token=tok)
            assert conn.welcome["role"] == "primary"
            pong = await conn.request("health", "ping")
            flow = load_flow(client, root)
            flow.stages["local"].servers = ["node-1"]
            sol = await conn.request("placement", "solve", {
                "flow": client.serialize.flow_to_dict(flow),
                "stage": "local"})
            dep = await conn.request("deploy", "execute", {
                "request": client.runtime.DeployRequest(
                    flow=flow, stage_name="local").to_dict()})
            with pytest.raises(client.protocol.RpcError,
                               match="unknown method"):
                await conn.request("health", "nope")
            ping = await h.state.agent_registry.send_command(
                "node-1", "ping", {"x": 1}, timeout=5)
            await agent.conn.close()
            await conn.close()
            task.cancel()
            await h.stop()
            return pong, sol, dep, ping, agent.commands
        pong, sol, dep, ping, commands = run(go())
        assert pong["pong"] is True and sol["feasible"]
        assert set(sol["assignment"].values()) == {"node-1"}
        assert dep["deployment"]["status"] == "succeeded"
        assert ping == {"ok": True, "cmd": "ping"}
        assert [c for c, _ in commands] == ["deploy.execute", "ping"]
        back = server.runtime.DeployRequest.from_dict(
            commands[0][1]["request"])
        assert back.node == "node-1"


# --------------------------------------------------------------------------
# the reference's server tests (tests/test_cp.py), on every package
# --------------------------------------------------------------------------

class TestProtocol:
    def test_request_response_roundtrip(self, P):
        async def go():
            handle = await start_cp(P)
            conn, _ = await connect(P, handle)
            pong = await conn.request("health", "ping")
            assert pong["pong"] is True
            with pytest.raises(P.protocol.RpcError):
                await conn.request("nope", "x")
            with pytest.raises(P.protocol.RpcError):
                await conn.request("health", "nope")
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            await handle.stop()
        run(go())

    def test_auth_rejects_bad_token(self, H):
        async def go():
            handle = await start_cp(H, auth_kind="token",
                                    auth_secret="s3cret")
            token = handle.state.auth.issue("op@example.com", ["admin:all"])
            conn, _ = await connect(H, handle, token=token)
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            with pytest.raises(H.protocol.RpcError):
                await connect(H, handle, token="garbage")
            with pytest.raises(H.protocol.RpcError):
                await connect(H, handle, token=None)
            await handle.stop()
        run(go())

    def test_tls_with_pinned_ca(self, H, tmp_path):
        pytest.importorskip("cryptography")
        cert = __import__(f"{H.root}.cp.cert", fromlist=["cert"])

        async def go():
            handle = await start_cp(H, tls_dir=str(tmp_path / "ca"))
            ctx = cert.client_ssl_context(handle.ca_pem)
            conn, _ = await H.protocol.ProtocolClient.connect(
                handle.host, handle.port, identity="cli", ssl_context=ctx)
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            await handle.stop()
        run(go())

    def test_tls_ca_pinned_across_packages(self, tmp_path):
        """A CA either package generates pins the other's server: the
        mesh CA's files and its common name are one format."""
        pytest.importorskip("cryptography")
        from fleetflow_tpu.cp import cert as ref_cert
        from fleetflow_tpu_torch.cp import cert as port_cert
        ca_dir = tmp_path / "ca"
        ref_ca = ref_cert.ensure_mesh_ca(str(ca_dir))
        port_ca = port_cert.ensure_mesh_ca(str(ca_dir))
        assert port_ca.ca_pem == ref_ca.ca_pem   # loaded, not regenerated

        async def go():
            handle = await start_cp(PORT, tls_dir=str(ca_dir))
            ctx = ref_cert.client_ssl_context(handle.ca_pem)
            conn, _ = await REF.protocol.ProtocolClient.connect(
                handle.host, handle.port, identity="cli", ssl_context=ctx)
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            await handle.stop()
        run(go())


class TestChannels:
    def test_tenant_project_stage(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            t = await conn.request("tenant", "create", {"name": "acme"})
            assert t["tenant"]["name"] == "acme"
            p = await conn.request("project", "create",
                                   {"tenant": "acme", "name": "web"})
            pid = p["project"]["id"]
            s = await conn.request("stage", "ensure",
                                   {"project": pid, "name": "live"})
            sid = s["stage"]["id"]
            adopted = await conn.request("stage", "adopt", {"stage": sid})
            assert adopted["stage"]["adopted"] is True
            listing = await conn.request("project", "list",
                                         {"tenant": "acme"})
            assert len(listing["projects"]) == 1
            await conn.close()
            await handle.stop()
        run(go())

    def test_server_lifecycle_and_cordon(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            await conn.request("server", "register", {
                "slug": "node-1", "capacity": {"cpu": 4, "memory": 8192,
                                               "disk": 50000},
                "labels": {"tier": "premium", "region": "tk1"}})
            got = await conn.request("server", "get", {"slug": "node-1"})
            assert got["server"]["capacity"]["cpu"] == 4
            assert got["server"]["labels"]["tier"] == "premium"
            r = await conn.request("server", "cordon", {"slug": "node-1"})
            assert r["scheduling_state"] == "cordoned"
            r = await conn.request("server", "uncordon", {"slug": "node-1"})
            assert r["scheduling_state"] == "schedulable"
            await conn.close()
            await handle.stop()
        run(go())

    def test_secrets_cost_dns(self, H, monkeypatch):
        pytest.importorskip("cryptography")
        crypto = __import__(f"{H.root}.cp.crypto", fromlist=["crypto"])
        monkeypatch.setenv("FLEETFLOW_MASTER_KEY",
                           crypto.generate_master_key())

        async def go():
            handle = await start_cp(H, master_key_env=True)
            conn, _ = await connect(H, handle)
            await conn.request("tenant", "secret.set",
                               {"name": "acme", "key": "DB_PASS",
                                "value": "hunter2"})
            t = handle.state.store.tenant_by_name("acme")
            assert t.secrets["DB_PASS"] != "hunter2"
            got = await conn.request("tenant", "secret.get",
                                     {"name": "acme", "key": "DB_PASS"})
            assert got["value"] == "hunter2"
            for amount in (12.5, 7.5):
                await conn.request("cost", "add", {
                    "tenant": "acme", "month": "2026-07", "amount": amount})
            summary = await conn.request("cost", "summary", {
                "tenant": "acme", "month": "2026-07"})
            assert summary["total"] == 20.0
            await conn.request("dns", "create",
                               {"zone": "example.com", "name": "app",
                                "content": "1.2.3.4"})
            synced = await conn.request("dns", "sync", {})
            assert synced["synced"] == 0 and synced["pending"] == 1

            class FakeDns:
                calls = []

                def ensure_record(self, zone, name, rtype, content, **kw):
                    self.calls.append((zone, name, rtype, content))
            handle.state.dns_backend = FakeDns()
            synced = await conn.request("dns", "sync", {})
            assert synced["synced"] == 1
            assert handle.state.dns_backend.calls == [
                ("example.com", "app", "A", "1.2.3.4")]
            await conn.close()
            await handle.stop()
        run(go())

    def test_secret_sealed_by_one_package_opens_in_the_other(self,
                                                             monkeypatch):
        pytest.importorskip("cryptography")
        from fleetflow_tpu.cp import crypto as ref_crypto
        from fleetflow_tpu_torch.cp import crypto as port_crypto
        monkeypatch.setenv("FLEETFLOW_MASTER_KEY",
                           ref_crypto.generate_master_key())
        a, b = ref_crypto.SecretBox.from_env(), \
            port_crypto.SecretBox.from_env()
        assert b.decrypt(a.encrypt("hunter2")) == "hunter2"
        assert a.decrypt(b.encrypt("s3cr3t")) == "s3cr3t"
        with pytest.raises(port_crypto.CryptoError):
            b.decrypt(a.encrypt("x")[:-4] + "AAAA")


class TestAgentProtocol:
    def test_register_heartbeat_and_command(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "node-1").connect(handle)
            assert handle.state.agent_registry.is_connected("node-1")
            s = handle.state.store.server_by_slug("node-1")
            assert s.status == "online" and s.capacity.cpu == 8
            result = await handle.state.agent_registry.send_command(
                "node-1", "ping", {"x": 1}, timeout=5)
            assert result == {"ok": True, "cmd": "ping"}
            assert agent.commands[-1] == ("ping", {"x": 1})
            await agent.conn.close()
            await asyncio.sleep(0.05)
            assert not handle.state.agent_registry.is_connected("node-1")
            assert handle.state.store.server_by_slug(
                "node-1").status == "offline"
            await handle.stop()
        run(go())

    def test_register_first_enforced(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle, identity="rogue")
            with pytest.raises(H.protocol.RpcError, match="register"):
                await conn.request("agent", "heartbeat", {})
            await conn.close()
            await handle.stop()
        run(go())

    def test_alert_upsert_and_autoresolve(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "node-1").connect(handle)
            for msg in ("5 restarts", "6 restarts"):
                await agent.conn.send_event("agent", "alert", {
                    "container": "web", "kind": "restart_loop",
                    "message": msg})
                await asyncio.sleep(0.05)
                alerts = handle.state.store.active_alerts()
                assert len(alerts) == 1
                assert alerts[0].kind == "restart_loop"
            await agent.conn.send_event("agent", "alert", {
                "container": "web", "kind": "restart_loop",
                "resolved": True})
            await asyncio.sleep(0.05)
            assert handle.state.store.active_alerts() == []
            await agent.conn.close()
            await handle.stop()
        run(go())

    def test_log_routing_with_retention(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "node-1").connect(handle)
            cli, _ = await connect(H, handle)
            for i in range(250):
                await agent.conn.send_event("agent", "log", {
                    "container": "web", "line": f"line{i}"})
            await asyncio.sleep(0.1)
            got = await cli.request("container", "logs",
                                    {"server": "node-1", "container": "web"})
            lines = [e["line"] for e in got["lines"]]
            assert len(lines) == 200 and lines[0] == "line50"
            await agent.conn.close()
            await cli.close()
            await handle.stop()
        run(go())

    def test_command_timeout_and_late_result(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "slow").connect(handle)

            async def no_reply(conn, method, payload):
                agent.commands.append((method, payload.get("payload", {})))
            agent.conn.event_handlers["agent"] = no_reply
            with pytest.raises(H.errors.ControlPlaneError,
                               match="timed out"):
                await handle.state.agent_registry.send_command(
                    "slow", "ping", {}, timeout=0.2)
            assert handle.state.agent_registry.resolve_result(
                "req_1", {"result": {}}) is False
            await agent.conn.close()
            await handle.stop()
        run(go())


class TestDeployExecute:
    def test_local_execution(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            conn, _ = await connect(P, handle)
            req = P.runtime.DeployRequest(flow=flow, stage_name="local")
            out = await conn.request("deploy", "execute",
                                     {"request": req.to_dict(),
                                      "tenant": "acme"})
            dep = out["deployment"]
            assert dep["status"] == "succeeded"
            assert "3 containers" in dep["log"]
            hist = await conn.request("deploy", "history", {})
            assert len(hist["deployments"]) == 1
            await conn.close()
            await handle.stop()
        run(go())

    def test_routed_to_agent(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            flow.stages["local"].servers = ["node-1"]
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)
            agent.respond = lambda cmd, p: {"deployed": 3, "cmd": cmd}
            conn, _ = await connect(P, handle)
            req = P.runtime.DeployRequest(flow=flow, stage_name="local")
            out = await conn.request("deploy", "execute",
                                     {"request": req.to_dict()}, timeout=10)
            assert out["deployment"]["status"] == "succeeded"
            cmd, payload = agent.commands[-1]
            assert cmd == "deploy.execute"
            back = P.runtime.DeployRequest.from_dict(payload["request"])
            assert back.node == "node-1"
            assert set(payload["assignment"].values()) == {"node-1"}
            await agent.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    def test_agent_failure_marks_deployment_failed(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            flow.stages["local"].servers = ["node-1"]
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)

            async def fail_event(conn, method, payload):
                rid = payload.get("request_id")
                if rid:
                    await conn.send_event("agent", "command_result", {
                        "request_id": rid, "error": "dockerd exploded"})
            agent.conn.event_handlers["agent"] = fail_event
            conn, _ = await connect(P, handle)
            req = P.runtime.DeployRequest(flow=flow, stage_name="local")
            with pytest.raises(P.protocol.RpcError,
                               match="dockerd exploded"):
                await conn.request("deploy", "execute",
                                   {"request": req.to_dict()}, timeout=10)
            deps = handle.state.store.deployment_history()
            assert deps[0].status == "failed"
            await agent.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    def test_down_routed_to_agent(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            flow.stages["local"].servers = ["node-1"]
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)
            agent.respond = lambda cmd, p: {"removed": ["x"], "cmd": cmd}
            conn, _ = await connect(P, handle)
            req = P.runtime.DeployRequest(flow=flow, stage_name="local")
            await conn.request("deploy", "execute",
                               {"request": req.to_dict()}, timeout=10)
            out = await conn.request("deploy", "down",
                                     {"request": req.to_dict()}, timeout=10)
            assert agent.commands[-1][0] == "deploy.down"
            await agent.conn.close()
            await conn.close()
            await handle.stop()
            return out
        out = run(go())
        assert out


class TestPlacementChannel:
    def test_solve_with_live_inventory(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            agents = [await FakeAgent(P, f"node-{i}").connect(handle)
                      for i in range(2)]
            conn, _ = await connect(P, handle)
            out = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "local"})
            assert out["feasible"]
            assert set(out["assignment"]) == {"postgres", "redis", "app"}
            assert set(out["assignment"].values()) <= {"node-0", "node-1"}
            for a in agents:
                await a.conn.close()
            await conn.close()
            await handle.stop()
            return out
        out = run(go())
        if P is PORT_CARD:
            assert out["source"] == "gpu-anneal"

    def test_explain_over_the_wire(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)
            conn, _ = await connect(P, handle)
            out = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "local"})
            assert out["feasible"]
            exp = await conn.request("placement", "explain",
                                     {"stage": f"{flow.name}/local",
                                      "service": "app"})
            assert exp["chosen"]["node"] == out["assignment"]["app"]
            assert exp["chosen"]["feasible"]
            with pytest.raises(Exception):
                await conn.request("placement", "explain",
                                   {"stage": "ghost/live",
                                    "service": "app"})
            await agent.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    def test_reservation_two_phase(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)
            conn, _ = await connect(P, handle)
            out = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "local",
                "reserve": True})
            rid = out["reservation"]
            assert rid
            ok = await conn.request("placement", "commit",
                                    {"reservation": rid})
            assert ok["ok"]
            s = handle.state.store.server_by_slug("node-1")
            assert s.allocated.cpu > 0
            await agent.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    def test_redeploy_supersedes_previous_commit(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)
            conn, _ = await connect(P, handle)
            allocs = []
            for _ in range(3):
                out = await conn.request("placement", "solve", {
                    "flow": P.serialize.flow_to_dict(flow),
                    "stage": "local", "reserve": True})
                await conn.request("placement", "commit",
                                   {"reservation": out["reservation"]})
                s = handle.state.store.server_by_slug("node-1")
                allocs.append(s.allocated.cpu)
            assert allocs[0] > 0
            assert allocs[0] == pytest.approx(allocs[1]) \
                == pytest.approx(allocs[2])
            await agent.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    @pytest.mark.parametrize("use_tpu", [False, True])
    def test_node_churn_reschedules(self, H, project, use_tpu):
        root, _ = project

        async def go():
            flow = load_flow(H, root)
            handle = await start_cp(H, use_tpu_solver=use_tpu)
            agents = [await FakeAgent(H, f"node-{i}").connect(handle)
                      for i in range(2)]
            conn, _ = await connect(H, handle)
            first = await conn.request("placement", "solve", {
                "flow": H.serialize.flow_to_dict(flow), "stage": "local"})
            kill = sorted(set(first["assignment"].values()))[0]
            out = await conn.request("placement", "node_event",
                                     {"slug": kill, "online": False})
            moved = out["rescheduled"]
            assert len(moved) == 1
            assert kill not in set(moved[0]["assignment"].values())
            assert moved[0]["feasible"]
            for a in agents:
                await a.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    def test_revive_triggers_resolve(self, P, project):
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            agents = [await FakeAgent(P, f"node-{i}").connect(handle)
                      for i in range(2)]
            conn, _ = await connect(P, handle)
            first = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "local"})
            kill = sorted(set(first["assignment"].values()))[0]
            await conn.request("placement", "node_event",
                               {"slug": kill, "online": False})
            out = await conn.request("placement", "node_event",
                                     {"slug": kill, "online": True})
            assert len(out["rescheduled"]) == 1
            assert out["rescheduled"][0]["feasible"]
            for a in agents:
                await a.conn.close()
            await conn.close()
            await handle.stop()
        run(go())

    def test_burst_coalesces_into_one_resolve(self, P, project):
        """A churn burst costs ONE re-solve of the affected stage against
        the final mask (the reference counts its host scheduler's place,
        the port's card scheduler its place)."""
        root, _ = project

        async def go():
            flow = load_flow(P, root)
            handle = await start_cp(P)
            agents = [await FakeAgent(P, f"node-{i}").connect(handle)
                      for i in range(4)]
            conn, _ = await connect(P, handle)
            first = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "local"})
            used = sorted(set(first["assignment"].values()))
            svc = handle.state.placement
            sched = (svc._sched_gpu if P is PORT_CARD
                     else svc._sched_host)
            calls = []
            orig = sched.place
            sched.place = lambda pt, **kw: (calls.append(1),
                                            orig(pt, **kw))[1]
            spare = next(s for s in ("node-0", "node-1", "node-2", "node-3")
                         if s not in used[:2])
            out = await conn.request("placement", "node_events", {
                "events": [{"slug": used[0], "online": False},
                           {"slug": used[1] if len(used) > 1 else used[0],
                            "online": False},
                           {"slug": spare, "online": True}]})
            assert len(calls) == 1, f"burst ran {len(calls)} re-solves"
            for entry in out["rescheduled"]:
                assert entry["feasible"]
                assert used[0] not in set(entry["assignment"].values())
            for a in agents:
                await a.conn.close()
            await conn.close()
            await handle.stop()
        run(go())


class TestProvision:
    def _fake_factory(self, P, created, deleted):
        class FakeProvider(P.provider.ServerProvider):
            name = "fake"

            def list_servers(self):
                return [P.provider.ServerInfo(id=f"srv-{n}", name=n,
                                              status="up") for n in created]

            def get_server(self, server_id):
                return None

            def create_server(self, spec):
                created.append(spec.name)
                return P.provider.ServerInfo(
                    id=f"srv-{spec.name}", name=spec.name, status="up",
                    ip="198.51.100.7")

            def delete_server(self, server_id):
                deleted.append(server_id)
                return True

            def power_on(self, server_id):
                return True

            def power_off(self, server_id):
                return True

        return lambda name, **kw: FakeProvider()

    def test_provision_and_deprovision(self, H):
        created, deleted = [], []

        async def go():
            handle = await start_cp(H, start_kw=dict(
                server_provider_factory=self._fake_factory(H, created,
                                                           deleted)))
            conn, _ = await connect(H, handle)
            out = await conn.request("server", "provision", {
                "slug": "auto-1", "provider": "fake",
                "capacity": {"cpu": 4, "memory": 8192, "disk": 50000}})
            assert out["server"]["status"] == "provisioning"
            assert out["server"]["hostname"] == "198.51.100.7"
            assert out["instance"]["id"] == "srv-auto-1"
            assert created == ["auto-1"]
            assert handle.state.store.server_by_slug("auto-1").capacity.cpu \
                == 4
            with pytest.raises(H.protocol.RpcError):
                await conn.request("server", "provision",
                                   {"slug": "auto-1", "provider": "fake"})
            out = await conn.request("server", "boot", {"slug": "auto-1"})
            assert out == {"ok": True, "instance": "srv-auto-1"}
            out = await conn.request("server", "deprovision",
                                     {"slug": "auto-1"})
            assert out["ok"] is True
            assert deleted == ["srv-auto-1"]
            assert handle.state.store.server_by_slug("auto-1") is None
            await conn.close()
            await handle.stop()
        run(go())

    def test_default_provider_factory(self, H):
        server = H.server
        with pytest.raises(ValueError, match="unknown server provider"):
            server._default_server_provider_factory("nimbus")
        sak = server._default_server_provider_factory(
            "sakura", runner=lambda a: (0, "[]"))
        aws = server._default_server_provider_factory(
            "aws", runner=lambda a: (0, "{}"))
        assert (type(sak).__name__, type(aws).__name__) == \
            ("SakuraServerProvider", "AwsServerProvider")


class TestServerRegisterLabels:
    def test_register_accepts_wire_class_label(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            out = await conn.request("server", "register", {
                "slug": "web-1",
                "labels": {"tier": "std", "class": "general"}})
            assert out["server"]["labels"]["class"] == "general"
            await conn.close()
            await handle.stop()
        run(go())


class TestDeployRunSsh:
    def test_run_records_deployment(self, H):
        calls = []

        async def go():
            def runner(args, timeout):
                calls.append(args)
                return 0, "remote: 3 deployed\n", ""
            handle = await start_cp(H, start_kw=dict(ssh_runner=runner))
            handle.state.store.register_server("tokyo-1",
                                               hostname="203.0.113.4")
            conn, _ = await connect(H, handle)
            out = await conn.request("deploy", "run", {
                "server": "tokyo-1", "path": "/srv/shop", "stage": "live",
                "ssh_user": "deploy"})
            assert out["deployment"]["status"] == "succeeded"
            assert "remote: 3 deployed" in out["deployment"]["log"]
            await conn.close()
            await handle.stop()
        run(go())
        assert calls and "deploy@203.0.113.4" in calls[0]
        assert calls[0][-1] == "cd /srv/shop && fleet deploy live -y"

    def test_run_failure_marks_failed(self, H):
        async def go():
            handle = await start_cp(H, start_kw=dict(
                ssh_runner=lambda a, t: (255, "", "unreachable")))
            handle.state.store.register_server("tokyo-1")
            conn, _ = await connect(H, handle)
            with pytest.raises(H.protocol.RpcError):
                await conn.request("deploy", "run", {
                    "server": "tokyo-1", "path": "/srv/x", "stage": "live"})
            deps = handle.state.store.deployment_history()
            assert deps and deps[0].status == "failed"
            assert "unreachable" in deps[0].error
            await conn.close()
            await handle.stop()
        run(go())


class TestHealthAlerts:
    def test_health_alerts_method(self, H):
        async def go():
            handle = await start_cp(H)
            handle.state.store.create("alerts", H.models.Alert(
                server="n1", kind="unhealthy", message="api flapping"))
            conn, _ = await connect(H, handle)
            out = await conn.request("health", "alerts", {})
            assert len(out["alerts"]) == 1
            assert out["alerts"][0]["kind"] == "unhealthy"
            await conn.close()
            await handle.stop()
        run(go())

    def test_solver_slots_and_metrics(self, P):
        """health's solver.slots (the scheduler's budget, also on the host
        path) and metrics (the registry in JSON)."""
        async def go():
            handle = await start_cp(P)
            conn, _ = await connect(P, handle)
            slots = await conn.request("health", "solver.slots")
            metrics = await conn.request("health", "metrics")
            await conn.close()
            await handle.stop()
            return slots, metrics
        slots, metrics = run(go())
        assert slots["enabled"] is True
        assert slots["budget_bytes"] == 256 << 20 and slots["max_slots"] == 8
        assert slots["slots"] == [] and slots["resident_bytes"] == 0
        assert "fleet_cp_request_duration_seconds" in metrics["metrics"]


class TestAgentChannelSecurity:
    def test_agent_register_requires_write_agent(self, H):
        async def go():
            handle = await start_cp(H, auth_kind="token", auth_secret="s3")
            ro = handle.state.auth.issue("dash@x", ["read:*"])
            conn, _ = await connect(H, handle, identity="dash", token=ro)
            with pytest.raises(H.protocol.RpcError, match="write:agent"):
                await conn.request("agent", "register", {"slug": "node-1"})
            assert not handle.state.agent_registry.is_connected("node-1")
            await conn.close()
            ag = handle.state.auth.issue("agent@node-1", ["write:agent"])
            conn2, _ = await connect(H, handle, identity="node-1", token=ag)
            out = await conn2.request("agent", "register",
                                      {"slug": "node-1"})
            assert out["registered"]
            await conn2.close()
            await handle.stop()
        run(go())

    def test_agent_events_dropped_without_write_agent(self, H):
        async def go():
            handle = await start_cp(H, auth_kind="token", auth_secret="s3")
            ro = handle.state.auth.issue("dash@x", ["read:*"])
            conn, _ = await connect(H, handle, identity="dash", token=ro)
            await asyncio.sleep(0.05)
            server_conn = next(iter(handle.server.connections))
            handle.state._agent_conn_slugs[id(server_conn)] = "dash"
            handle.state.store.register_server("dash")
            before = handle.state.store.server_by_slug(
                "dash").last_heartbeat
            await conn.send_event("agent", "heartbeat", {"version": "evil"})
            await asyncio.sleep(0.05)
            after = handle.state.store.server_by_slug("dash").last_heartbeat
            assert after == before
            await conn.close()
            await handle.stop()
        run(go())

    def test_server_delete_evicts_live_agent(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "node-1").connect(handle)
            admin, _ = await connect(H, handle)
            out = await admin.request("server", "delete", {"slug": "node-1"})
            assert out["deleted"]
            assert not handle.state.agent_registry.is_connected("node-1")
            fresh, _ = await connect(H, handle, identity="replacement")
            reply = await fresh.request("agent", "register",
                                        {"slug": "node-1"})
            assert reply["registered"]
            await fresh.close()
            await admin.close()
            await agent.conn.close()
            await handle.stop()
        run(go())

    def test_live_slug_hijack_refused(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "node-1").connect(handle)
            original = handle.state.agent_registry.connection_of("node-1")
            evil, _ = await connect(H, handle, identity="mallory")
            with pytest.raises(H.protocol.RpcError,
                               match="already registered"):
                await evil.request("agent", "register", {"slug": "node-1"})
            assert (handle.state.agent_registry.connection_of("node-1")
                    is original)
            out = await handle.state.agent_registry.send_command(
                "node-1", "ping", {}, timeout=5)
            assert out["ok"] and agent.commands
            await evil.close()
            await agent.conn.close()
            await handle.stop()
        run(go())

    def test_shared_agent_token_allows_takeover(self, H):
        async def go():
            handle = await start_cp(H, auth_kind="token", auth_secret="s3")
            shared = handle.state.auth.issue("agents@fleet", ["write:agent"])
            victim, _ = await connect(H, handle, identity="node-1",
                                      token=shared)
            assert (await victim.request("agent", "register",
                                         {"slug": "node-1"}))["registered"]
            original = handle.state.agent_registry.connection_of("node-1")
            mallory, _ = await connect(H, handle, identity="mallory",
                                       token=shared)
            out = await mallory.request("agent", "register",
                                        {"slug": "node-1"})
            assert out["registered"]
            assert (handle.state.agent_registry.connection_of("node-1")
                    is not original)
            await mallory.close()
            await victim.close()
            await handle.stop()
        run(go())

    def test_per_node_tokens_refuse_takeover(self, H):
        async def go():
            handle = await start_cp(H, auth_kind="token", auth_secret="s3")
            tok1 = handle.state.auth.issue("agent@node-1", ["write:agent"])
            tok2 = handle.state.auth.issue("agent@node-2", ["write:agent"])
            victim, _ = await connect(H, handle, identity="node-1",
                                      token=tok1)
            assert (await victim.request("agent", "register",
                                         {"slug": "node-1"}))["registered"]
            original = handle.state.agent_registry.connection_of("node-1")
            mallory, _ = await connect(H, handle, identity="node-1",
                                       token=tok2)
            with pytest.raises(H.protocol.RpcError,
                               match="already registered"):
                await mallory.request("agent", "register",
                                      {"slug": "node-1"})
            assert (handle.state.agent_registry.connection_of("node-1")
                    is original)
            await mallory.close()
            await victim.close()
            await handle.stop()
        run(go())

    def test_same_principal_reconnect_wins(self, H):
        async def go():
            handle = await start_cp(H)
            first = await FakeAgent(H, "node-1").connect(handle)
            before = handle.state.agent_registry.connection_of("node-1")
            second = await FakeAgent(H, "node-1").connect(handle)
            after = handle.state.agent_registry.connection_of("node-1")
            assert after is not before
            out = await handle.state.agent_registry.send_command(
                "node-1", "ping", {}, timeout=5)
            assert out["ok"] and second.commands and not first.commands
            await first.conn.close()
            await second.conn.close()
            await handle.stop()
        run(go())


class TestTenantSecretHygiene:
    def test_listing_payloads_omit_secrets(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            created = await conn.request("tenant", "create",
                                         {"name": "acme"})
            assert "secrets" not in created["tenant"]
            await conn.request("tenant", "secret.set", {
                "name": "acme", "key": "db", "value": "hunter2"})
            listing = await conn.request("tenant", "list")
            assert all("secrets" not in t for t in listing["tenants"])
            got = await conn.request("tenant", "get", {"name": "acme"})
            assert "secrets" not in got["tenant"]
            val = await conn.request("tenant", "secret.get",
                                     {"name": "acme", "key": "db"})
            assert val["value"] == "hunter2"
            await conn.close()
            await handle.stop()
        run(go())


class TestProtocolRobustness:
    def test_garbage_and_oversized_frames_rejected(self, H):
        async def go():
            handle = await start_cp(H)
            r, w = await asyncio.open_connection(handle.host, handle.port)
            w.write(b"\x00\x00\x00\x05notjs")
            await w.drain()
            assert await r.read(64) == b""
            w.close()
            r, w = await asyncio.open_connection(handle.host, handle.port)
            w.write((2 << 30).to_bytes(4, "big") + b"x")
            await w.drain()
            assert await r.read(64) == b""
            w.close()
            r, w = await asyncio.open_connection(handle.host, handle.port)
            w.write(H.protocol.encode_frame({"type": "hello",
                                             "identity": "x",
                                             "token": None}))
            await w.drain()
            welcome = await asyncio.wait_for(r.read(200), 5)
            assert b"welcome" in welcome
            w.write((500).to_bytes(4, "big") + b"short")
            w.close()
            conn, _ = await connect(H, handle)
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            await handle.stop()
        run(go())

    def test_idle_preauth_connection_reaped(self, H):
        async def go():
            handle = await start_cp(H)
            handle.server.handshake_timeout = 0.2
            r, w = await asyncio.open_connection(handle.host, handle.port)
            assert await asyncio.wait_for(r.read(64), 5) == b""
            w.close()
            conn, _ = await connect(H, handle)
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            await handle.stop()
        run(go())

    def test_unknown_message_type_ignored(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            await conn._send({"type": "mystery", "x": 1})
            assert (await conn.request("health", "ping"))["pong"]
            await conn.close()
            await handle.stop()
        run(go())

    def test_session_frames_past_the_handshake_cap(self):
        """The port's session frames may exceed the handshake's 1 MiB (a
        deliberate difference): a 2 MB flow reaches placement.solve; a
        pre-auth frame of that size is still refused."""
        async def go():
            handle = await start_cp(PORT)
            conn, _ = await connect(PORT, handle)
            blob = "x" * (2 << 20)
            with pytest.raises(PORT.protocol.RpcError,
                               match="unknown method"):
                await conn.request("health", "nope", {"blob": blob})
            r, w = await asyncio.open_connection(handle.host, handle.port)
            w.write((2 << 20).to_bytes(4, "big") + b"x")
            await w.drain()
            assert await r.read(64) == b""
            w.close()
            await conn.close()
            await handle.stop()
        run(go())


class TestVolumeChannel:
    def test_adopt_snapshot_list(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            v = await conn.request("volume", "adopt",
                                   {"server": "n1", "name": "pgdata",
                                    "tenant": "acme"})
            assert v["volume"]["adopted"] is True
            vid = v["volume"]["id"]
            v2 = await conn.request("volume", "adopt",
                                    {"server": "n1", "name": "pgdata"})
            assert v2["volume"]["id"] == vid
            snap = await conn.request("volume", "snapshot",
                                      {"volume": vid, "label": "pre-migrate"})
            assert snap["snapshot"]["label"] == "pre-migrate"
            listing = await conn.request("volume", "snapshots",
                                         {"volume": vid})
            assert len(listing["snapshots"]) == 1
            vols = await conn.request("volume", "list", {"server": "n1"})
            assert [x["name"] for x in vols["volumes"]] == ["pgdata"]
            assert (await conn.request("volume", "list",
                                       {"server": "other"}))["volumes"] == []
            await conn.close()
            await handle.stop()
        run(go())


class TestBuildChannel:
    def test_submit_routes_to_worker_and_records_log(self, H):
        async def go():
            handle = await start_cp(H)
            agent = await FakeAgent(H, "builder-1").connect(handle)
            agent.respond = lambda cmd, p: {"log": f"built {p['image_tag']}"}
            conn, _ = await connect(H, handle)
            out = await conn.request("build", "submit",
                                     {"repo": "https://x/y.git",
                                      "image_tag": "y:1", "push": False})
            jid = out["job"]["id"]
            assert out["job"]["worker"] == "builder-1"
            for _ in range(100):
                await asyncio.sleep(0.02)
                job = (await conn.request("build", "show",
                                          {"job": jid}))["job"]
                if job["status"] in ("succeeded", "failed"):
                    break
            assert job["status"] == "succeeded", job
            logs = await conn.request("build", "logs", {"job": jid})
            assert logs["log"] == "built y:1"
            res = await conn.request("build", "cancel", {"job": jid})
            assert res["cancelled"] is False
            await conn.close()
            await agent.conn.close()
            await handle.stop()
        run(go())

    def test_submit_without_worker_queues(self, H):
        async def go():
            handle = await start_cp(H)
            conn, _ = await connect(H, handle)
            out = await conn.request("build", "submit",
                                     {"repo": "https://x/y.git",
                                      "image_tag": "y:1"})
            assert out["job"]["status"] == "queued"
            res = await conn.request("build", "cancel",
                                     {"job": out["job"]["id"]})
            assert res["cancelled"] is True
            await conn.close()
            await handle.stop()
        run(go())


_RV_KDL = """
project "rv"
service "a0" { image "x"; resources { cpu 3; memory 64; disk 1 } }
stage "live" { service "a0"; servers "n0" "n1" }
"""


class TestReservationVisibility:
    def test_journal_over_the_wire(self, P):
        parse = __import__(f"{P.root}.core.parser",
                           fromlist=["parser"]).parse_kdl_string

        async def go():
            handle = await start_cp(P)
            conn, _ = await connect(P, handle)
            agents = []
            for slug in ("n0", "n1"):
                c, _ = await P.protocol.ProtocolClient.connect(
                    handle.host, handle.port, identity=slug)
                await c.request("agent", "register", {
                    "slug": slug, "version": "1",
                    "capacity": {"cpu": 4, "memory": 8192, "disk": 99999}})
                agents.append(c)
            flow = parse(_RV_KDL)
            out = await conn.request("placement", "solve", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "live",
                "reserve": True})
            rid = out["reservation"]
            assert rid
            j = await conn.request("placement", "reservations")
            assert [r["id"] for r in j["in_flight"]] == [rid]
            assert j["in_flight"][0]["stage"] == "rv/live"
            assert j["in_flight"][0]["churn"] is False
            (node,) = j["in_flight"][0]["demand_by_node"].keys()
            assert node in ("n0", "n1")
            assert j["committed"] == []
            assert (await conn.request("placement", "commit",
                                       {"reservation": rid}))["ok"]
            j = await conn.request("placement", "reservations")
            assert j["in_flight"] == []
            assert [c["stage"] for c in j["committed"]] == ["rv/live"]
            await conn.request("placement", "node_events", {
                "events": [{"slug": node, "online": False}]})
            j = await conn.request("placement", "reservations")
            churn = [r for r in j["in_flight"] if r["churn"]]
            assert len(churn) == 1 and churn[0]["stage"] == "rv/live"
            for c in agents + [conn]:
                await c.close()
            await handle.stop()
        run(go())

    def test_reservations_is_read_gated(self, H):
        async def go():
            handle = await start_cp(H, auth_kind="token", auth_secret="s3")
            ro = handle.state.auth.issue("dash@x", ["read:placement"])
            conn, _ = await connect(H, handle, token=ro)
            j = await conn.request("placement", "reservations")
            assert j == {"in_flight": [], "committed": []}
            with pytest.raises(H.protocol.RpcError,
                               match="write:placement"):
                await conn.request("placement", "solve",
                                   {"flow": {}, "stage": "x"})
            await conn.close()
            await handle.stop()
        run(go())


class TestAgentDeathMidDeploy:
    def test_deploy_fails_fast_when_agent_dies_mid_command(self, P,
                                                           tmp_path):
        (tmp_path / ".fleetflow").mkdir(parents=True)
        (tmp_path / ".fleetflow" / "fleet.kdl").write_text("""
project "dd"
service "a" { image "x" }
stage "live" { service "a"; servers "node-1" }
""")

        async def go():
            handle = await start_cp(P)
            agent = await FakeAgent(P, "node-1").connect(handle)
            received = []

            async def on_event(conn, method, payload):
                received.append(method)
                await conn.close()
            agent.conn.event_handlers["agent"] = on_event
            flow = P.loader.load_project_from_root_with_stage(
                str(tmp_path), "live")
            cli, _ = await connect(P, handle)
            t0 = time.monotonic()
            with pytest.raises(P.protocol.RpcError,
                               match="disconnected mid-command"):
                await cli.request("deploy", "execute", {
                    "request": P.runtime.DeployRequest(
                        flow=flow, stage_name="live").to_dict()},
                    timeout=60)
            assert time.monotonic() - t0 < 30
            assert received
            deps = handle.state.store.list("deployments")
            assert len(deps) == 1 and deps[0].status == "failed"
            assert "disconnected mid-command" in (deps[0].error or "")
            await cli.close()
            await handle.stop()
        run(go())


def _stream_flow(P, name: str):
    m = __import__(f"{P.root}.core.model", fromlist=["model"])
    flow = m.Flow(name=name)
    flow.services["base"] = m.Service(
        name="base", image="x", version="1",
        resources=m.ResourceSpec(cpu=0.1, memory=32.0))
    flow.stages["live"] = m.Stage(name="live", services=["base"],
                                  servers=["node-1"])
    return flow


def _online_node(P, handle) -> None:
    db = handle.state.store
    s = db.register_server("node-1")
    db.update("servers", s.id, status="online",
              capacity=P.models.ServerCapacity(cpu=4.0, memory=4096.0,
                                               disk=1024.0))


class TestStreamingAdmission:
    def test_submit_attach_drain_and_status(self, P):
        flow = _stream_flow(P, "streamy")

        async def go():
            handle = await start_cp(P)
            _online_node(P, handle)
            cli, _ = await connect(P, handle)
            out = await cli.request("deploy", "submit", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "live",
                "arrivals": [{"name": "s1", "cpu": 0.1, "memory": 16.0}]})
            assert out["stage"] == "streamy/live"
            assert len(out["accepted"]) == 1
            ctrl = handle.state.admission
            for _ in range(100):
                if not ctrl.has_work():
                    break
                await asyncio.sleep(0.05)
            assert "s1" in ctrl.live_names("streamy/live")
            st = await cli.request("deploy", "admit_status")
            assert st["enabled"]
            assert st["streams"]["streamy/live"]["live_streamed"] == 1
            assert st["stats"]["admitted"] == 1
            await cli.request("deploy", "submit", {
                "stage": "streamy/live", "departures": ["s1"]})
            for _ in range(100):
                if not ctrl.has_work():
                    break
                await asyncio.sleep(0.05)
            assert ctrl.live_names("streamy/live") == []
            with pytest.raises(P.protocol.RpcError, match="no such live"):
                await cli.request("deploy", "submit", {
                    "stage": "streamy/live", "departures": ["ghost"]})
            await cli.close()
            await handle.stop()
        run(go())

    def test_backpressure_surfaces_retryable_error(self, P):
        flow = _stream_flow(P, "bp")

        async def go():
            handle = await start_cp(P, admission_queue=1)
            _online_node(P, handle)
            handle.state.admission.stop()
            cli, _ = await connect(P, handle)
            await cli.request("deploy", "submit", {
                "flow": P.serialize.flow_to_dict(flow), "stage": "live",
                "arrivals": [{"name": "a0"}]})
            with pytest.raises(P.protocol.RpcError) as ei:
                await cli.request("deploy", "submit", {
                    "stage": "bp/live", "arrivals": [{"name": "a1"}]})
            msg = str(ei.value)
            assert "AdmissionRejected" in msg
            assert "queue-depth" in msg and "retry_after_s" in msg
            await cli.close()
            await handle.stop()
        run(go())

    def test_admission_disabled(self, H):
        async def go():
            handle = await start_cp(H, admission=False)
            cli, _ = await connect(H, handle)
            st = await cli.request("deploy", "admit_status")
            with pytest.raises(H.protocol.RpcError, match="disabled"):
                await cli.request("deploy", "submit", {"stage": "x"})
            await cli.close()
            await handle.stop()
            return st
        assert run(go()) == {"enabled": False}


# --------------------------------------------------------------------------
# the server paths of test_collector.py, test_autoscaler.py,
# test_replication.py and test_slo.py
# --------------------------------------------------------------------------

class TestObsChannel:
    def test_series_query_export_over_live_cp(self, H):
        async def go():
            handle = await start_cp(H, collector_interval_s=0.05)
            try:
                coll = handle.state.collector
                for _ in range(100):
                    if len(coll.tsdb):
                        break
                    await asyncio.sleep(0.02)
                cli, _ = await connect(H, handle)
                series = await cli.request("health", "obs.series")
                query = await cli.request("health", "obs.query",
                                          {"window_s": 60.0})
                om = await cli.request("health", "obs.export",
                                       {"format": "openmetrics"})
                jl = await cli.request("health", "obs.export",
                                       {"format": "jsonl"})
                await cli.close()
                return series, query, om, jl
            finally:
                await handle.stop()
        series, query, om, jl = run(go())
        assert series["enabled"] and series["stats"]["series"] > 0
        names = {s["name"] for s in series["series"]}
        assert {"fleet_agents_connected",
                "fleet_sched_resident_budget_bytes"} <= names
        assert query["enabled"] and query["window_s"] == 60.0
        assert any(r["agg"]["count"] > 0 for r in query["series"])
        assert om["text"].rstrip().endswith("# EOF")
        rows = [json.loads(ln) for ln in jl["text"].splitlines()]
        assert rows and all("samples" in r for r in rows)

    def test_disabled_collector_answers_not_errors(self, H):
        async def go():
            handle = await start_cp(H, collector=False)
            cli, _ = await connect(H, handle)
            out = await cli.request("health", "obs.query",
                                    {"window_s": 5.0})
            await cli.close()
            await handle.stop()
            return out
        assert run(go()) == {"enabled": False}

    def test_heartbeat_ships_agent_labeled_series(self, H):
        async def go():
            handle = await start_cp(H, collector_interval_s=0.05)
            agent = await FakeAgent(H, "node-1").connect(handle)
            await agent.conn.send_event("agent", "heartbeat", {
                "version": "0.1.0", "metrics": {
                    "schema": 1,
                    "m": [["fleet_agent_containers", {}, 3.0, "gauge"]]}})
            coll = handle.state.collector
            for _ in range(200):
                if coll.tsdb.match(labels={"agent": "node-1"}):
                    break
                await asyncio.sleep(0.02)
            cli, _ = await connect(H, handle)
            out = await cli.request("health", "obs.query", {
                "window_s": 60.0, "labels": {"agent": "node-1"}})
            await cli.close()
            await agent.conn.close()
            await handle.stop()
            return out
        out = run(go())
        rows = [r for r in out["series"]
                if r["labels"].get("agent") == "node-1"]
        assert rows and rows[0]["name"] == "fleet_agent_containers"


def _provider(H, log):
    class FakeProvider(H.provider.ServerProvider):
        name = "fake"

        def list_servers(self):
            return []

        def get_server(self, server_id):
            return None

        def create_server(self, spec):
            if log.get("fail_create"):
                raise RuntimeError("quota exceeded")
            log["created"].append(spec.name)
            return H.provider.ServerInfo(id=f"i-{spec.name}", name=spec.name,
                                         status="running",
                                         ip="203.0.113.50")

        def delete_server(self, server_id):
            log["deleted"].append(server_id)
            return True

        def power_on(self, server_id):
            return True

        def power_off(self, server_id):
            return True
    return lambda name, **kw: FakeProvider()


class TestAutoscalerOnServer:
    @pytest.mark.parametrize("fail", [False, True], ids=["ok", "quota"])
    def test_sweep_provisions_through_the_server_state(self, H, fail):
        auto = __import__(f"{H.root}.cp.autoscaler", fromlist=["x"])
        log = {"created": [], "deleted": [], "fail_create": fail}

        async def go():
            handle = await start_cp(H, start_kw=dict(
                server_provider_factory=_provider(H, log)))
            handle.state.store.create("worker_pools", H.models.WorkerPool(
                tenant="default", name="builders", min_servers=5,
                max_servers=2, preferred_labels={"provider": "fake"}))
            scaler = auto.Autoscaler(handle.state)
            actions = scaler.run_sweep()
            servers = handle.state.store.list(
                "servers", lambda s: s.pool == "builders")
            await handle.stop()
            return actions, servers
        actions, servers = run(go())
        if fail:
            assert actions and not any(a.ok for a in actions)
            assert "quota exceeded" in actions[0].error and servers == []
        else:
            assert [a.kind for a in actions] == ["provision"] * 2
            assert len(servers) == 2
            assert all(s.hostname == "203.0.113.50" for s in servers)


class TestStandbyServer:
    def test_standby_refuses_writes_and_agents_until_promoted(self, H):
        async def go():
            primary = await start_cp(H, self_heal=False)
            standby = await start_cp(
                H, name="cp-b", self_heal=False,
                standby_of=f"{primary.host}:{primary.port}",
                standby_ping_interval_s=0.05, standby_lease_s=0.4,
                standby_grace_s=0.15)
            cli, _ = await connect(H, standby)
            assert cli.welcome["role"] == "standby"
            with pytest.raises(H.protocol.RpcError, match="not primary"):
                await cli.request("tenant", "create", {"name": "x"})
            with pytest.raises(H.protocol.RpcError, match="not primary"):
                await cli.request("agent", "register", {"slug": "n1"})
            out = await cli.request("health", "overview")
            assert out["servers"] == 0
            st = await cli.request("replication", "status")
            assert st["role"] == "standby"
            await cli.close()
            await standby.stop()
            await primary.stop()
        run(go())

    def test_replication_survives_primary_compaction(self, H, tmp_path):
        async def go():
            primary = await start_cp(H, self_heal=False,
                                     db_path=str(tmp_path / "cp.json"))
            standby = await start_cp(
                H, name="cp-b", self_heal=False,
                standby_of=f"{primary.host}:{primary.port}",
                standby_ping_interval_s=0.05, standby_lease_s=0.4,
                standby_grace_s=0.15)
            db = primary.state.store
            for i in range(10):
                db.create("tenants", H.models.Tenant(name=f"t{i}"))
            db.flush()
            for i in range(10, 15):
                db.create("tenants", H.models.Tenant(name=f"t{i}"))
            for _ in range(100):
                await asyncio.sleep(0.02)
                if standby.state.store.seq == db.seq:
                    break
            n = len(standby.state.store.list("tenants"))
            await standby.stop()
            await primary.stop()
            return n
        assert run(go()) == 15

    def test_promotion_solves_on_a_fresh_service(self, project):
        """The port's promoted standby serves placement on a fresh
        PlacementService on its configured device, its committed book
        loaded from the replicated placements: a re-solve of a stage the
        dead primary committed supersedes that allocation."""
        root, _ = project

        async def go():
            fast = dict(standby_ping_interval_s=0.05, standby_lease_s=0.4,
                        standby_grace_s=0.15, self_heal=False)
            primary = await start_cp(PORT_CARD, **fast)
            standby = await start_cp(
                PORT_CARD, name="cp-b",
                standby_of=f"{primary.host}:{primary.port}", **fast)
            before = standby.state.placement
            cli, task = await connect(PORT_CARD, primary)
            c1, _ = await PORT.protocol.ProtocolClient.connect(
                primary.host, primary.port, identity="node-1")
            await c1.request("agent", "register", {
                "slug": "node-1", "capacity": {"cpu": 4, "memory": 8192,
                                               "disk": 99999}})
            fd = PORT.serialize.flow_to_dict(load_flow(PORT, root))
            out = await cli.request("placement", "solve", {
                "flow": fd, "stage": "local", "reserve": True})
            await cli.request("placement", "commit",
                              {"reservation": out["reservation"]})
            alloc = primary.state.store.server_by_slug("node-1").allocated
            for _ in range(100):
                await asyncio.sleep(0.02)
                if standby.state.store.seq == primary.state.store.seq:
                    break
            await cli.close()
            task.cancel()
            await c1.close()
            await primary.stop()
            for _ in range(200):
                if standby.state.replication_role == "primary":
                    break
                await asyncio.sleep(0.02)
            fresh = standby.state.placement
            cli, task = await connect(PORT_CARD, standby)
            again = await cli.request("placement", "solve", {
                "flow": fd, "stage": "local", "reserve": True})
            await cli.request("placement", "commit",
                              {"reservation": again["reservation"]})
            after = standby.state.store.server_by_slug("node-1").allocated
            await cli.close()
            task.cancel()
            await standby.stop()
            return before, fresh, out, again, alloc, after
        before, fresh, out, again, alloc, after = run(go())
        assert fresh is not before
        assert str(fresh._sched_gpu.device) == "cpu"
        assert again["source"] == "gpu-anneal" and again["feasible"]
        assert again["assignment"] == out["assignment"]
        assert alloc.cpu > 0 and after.cpu == pytest.approx(alloc.cpu)


class TestSloOnServer:
    def test_server_installs_engine_with_config_objectives(self, H):
        slo = __import__(f"{H.root}.obs.slo", fromlist=["slo"])

        async def go():
            handle = await start_cp(H, slo={"placement-p99-ms": 50})
            try:
                state = handle.state
                assert state.slo is not None
                assert slo.get_engine() is state.slo
                assert [o.name for o in state.slo.objectives] == \
                    ["placement-p99-ms"]
                cli, _ = await connect(H, handle)
                out = await cli.request("health", "slo.status")
                await cli.close()
                assert out["enabled"] and len(out["objectives"]) == 1
            finally:
                await handle.stop()
        run(go())


# --------------------------------------------------------------------------
# the card scheduler under start
# --------------------------------------------------------------------------

class TestCardUnderStart:
    def test_every_placement_rpc_solves_on_the_scheduler_off_loop(
            self, project):
        """placement.solve, node_events, deploy.execute and deploy.submit
        each reach GpuSolverScheduler.place, from executor threads (never
        the loop's), and every reply names the card's source."""
        import threading
        root, _ = project
        from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
        place = GpuSolverScheduler.place
        calls = []

        def spy(sched, pt, **kw):
            calls.append((threading.current_thread() is
                          threading.main_thread(), str(sched.device)))
            return place(sched, pt, **kw)

        async def go():
            handle = await start_cp(PORT_CARD)
            agents = [await FakeAgent(PORT_CARD, f"node-{i}").connect(handle)
                      for i in range(3)]
            conn, task = await connect(PORT_CARD, handle)
            flow = load_flow(PORT_CARD, root)
            fd = PORT.serialize.flow_to_dict(flow)
            counts = {}
            sol = await conn.request("placement", "solve",
                                     {"flow": fd, "stage": "local"})
            counts["solve"] = len(calls)
            kill = sorted(set(sol["assignment"].values()))[0]
            churn = await conn.request("placement", "node_events", {
                "events": [{"slug": kill, "online": False}]})
            counts["node_events"] = len(calls)
            flow.stages["local"].servers = ["node-1", "node-2"]
            dep = await conn.request("deploy", "execute", {
                "request": PORT.runtime.DeployRequest(
                    flow=flow, stage_name="local").to_dict()})
            counts["deploy"] = len(calls)
            flow2 = _stream_flow(PORT, "streamy")
            flow2.stages["live"].servers = ["node-1"]
            await conn.request("deploy", "submit", {
                "flow": PORT.serialize.flow_to_dict(flow2),
                "stage": "live", "arrivals": [{"name": "s1", "cpu": 0.1,
                                               "memory": 16.0}]})
            for _ in range(100):
                if not handle.state.admission.has_work():
                    break
                await asyncio.sleep(0.05)
            counts["submit"] = len(calls)
            snap = handle.state.placement.snapshot()
            for a in agents:
                await a.conn.close()
            await conn.close()
            task.cancel()
            await handle.stop()
            return sol, churn, dep, counts, snap

        GpuSolverScheduler.place = spy
        try:
            sol, churn, dep, counts, snap = run(go())
        finally:
            GpuSolverScheduler.place = place
        assert sol["source"] == "gpu-anneal"
        assert churn["rescheduled"][0]["feasible"]
        assert dep["deployment"]["status"] == "succeeded"
        assert counts["solve"] >= 1
        assert counts["node_events"] > counts["solve"]
        assert counts["deploy"] > counts["node_events"]
        assert counts["submit"] > counts["deploy"]
        assert calls and not any(main for main, _ in calls)
        assert {d for _, d in calls} == {"cpu"}
        assert {v["source"] for v in snap.values()} == {"gpu-anneal"}


def _heal_flow(P):
    m = __import__(f"{P.root}.core.model", fromlist=["model"])
    flow = m.Flow(name="healdemo")
    flow.services["web"] = m.Service(
        name="web", image="app", version="1",
        resources=m.ResourceSpec(cpu=0.5, memory=128.0))
    flow.stages["main"] = m.Stage(name="main", services=["web"],
                                  servers=["node-1", "node-2"])
    return flow


class TestSelfHealE2E:
    def test_kill_one_agent_heals_on_survivor(self, P):
        """tests/test_selfheal.py's end to end over the wire: a CP with
        short leases, two agents (chip_smoke's WireAgent: the agent
        contract over P's client, a DeployEngine on its own MockBackend),
        one agent's session closes and the service heals onto the
        survivor with no operator RPC."""
        kit = chip_smoke.heal_kit(P.root)
        flow = _heal_flow(P)

        async def go():
            handle = await start_cp(
                P, self_heal=True, lease_s=0.4, suspect_grace_s=0.15,
                heal_interval_s=0.05, heal_backoff_base_s=0.05,
                heal_backoff_max_s=0.2)
            fleet = chip_smoke.HealAgents(
                kit, ["node-1", "node-2"], None,
                type("Clock", (), {"advance": staticmethod(
                    lambda s: None)}))
            agents = {s: await chip_smoke.WireAgent(fleet.agents[s]).connect(
                P.protocol.ProtocolClient, handle.host, handle.port, None,
                heartbeat_s=0.05) for s in fleet.agents}
            sent = []
            orig_batch = handle.state.agent_registry.send_batch

            async def spy_batch(items, timeout=60.0):
                sent.extend((s, c, dict(p or {})) for s, c, p in items)
                return await orig_batch(items, timeout=timeout)
            handle.state.agent_registry.send_batch = spy_batch
            cli, task = await connect(P, handle)
            req = kit.DeployRequest(flow=flow, stage_name="main")
            out = await cli.request("deploy", "execute",
                                    {"request": req.to_dict()}, timeout=30)
            assert out["deployment"]["status"] == "succeeded"
            victim = out["deployment"]["placement"]["web"]
            survivor = "node-2" if victim == "node-1" else "node-1"
            cname = kit.container_name("healdemo", "main", "web")
            assert fleet.agents[victim].backend.inspect(cname).running
            await agents[victim].close()
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                info = fleet.agents[survivor].backend.inspect(cname)
                if info is not None and info.running:
                    break
                await asyncio.sleep(0.05)
            else:
                pytest.fail(f"never healed onto {survivor}: "
                            f"{handle.state.reconverger.status()}")
            status = await cli.request("health", "heal.status")
            for _ in range(100):
                if not status["work"]:
                    break
                await asyncio.sleep(0.05)
                status = await cli.request("health", "heal.status")
            heal_deps = [d for d in handle.state.store.list("deployments")
                         if d.log.startswith("self-heal")]
            src = handle.state.placement.snapshot()["healdemo/main"]
            await cli.close()
            task.cancel()
            for a in agents.values():
                await a.close()
            await handle.stop()
            return survivor, sent, status, heal_deps, src
        survivor, sent, status, heal_deps, src = run(go())
        heals = [(s, p) for s, c, p in sent
                 if c == "deploy.execute" and p.get("idempotency_key")]
        assert heals and all(s == survivor for s, _ in heals)
        assert heals[0][1]["idempotency_key"].startswith(
            "heal-healdemo/main-")
        assert heal_deps and heal_deps[-1].placement == {"web": survivor}
        assert status["enabled"] is True and status["work"] == []
        assert status["stats"]["redeliveries_ok"] >= 1
        if P is PORT_CARD:
            assert src["source"] == "gpu-anneal"


@pytest.fixture
def wire_rehearsal(monkeypatch):
    """chip_smoke's [wire] on the CPU: no sync to make, and the plain
    versions launch no kernel to count."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cp_expect_launches",
                        lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "read_launches",
                        lambda torch, _ext, tag, path, off=(), size=None:
                        dict(_ext.LAUNCHES))
    monkeypatch.setenv("FLEET_SUBSOLVE_MIN", "16")
    monkeypatch.setattr(chip_smoke, "WIRE_DIR", "")
    return chip_smoke


def _small_fleet():
    from fleetflow_tpu_torch.core import parser
    from fleetflow_tpu_torch.lower import fleetgen
    flow = parser.parse_kdl_string(fleetgen.generate_fleet_kdl(
        "t0", 240, seed=100, n_nodes_hint=24, port_base=10000), cache=False)
    pool = parser.parse_kdl_string(fleetgen.generate_servers_kdl(24, seed=7),
                                   cache=False)
    return flow, pool


class TestWirePhase:
    def test_rehearsed_on_the_cpu(self, wire_rehearsal, tmp_path,
                                  monkeypatch, capsys):
        """[wire] with the card scheduler's plain versions at 240 services
        on 24 servers, 8 agents and a 40-service deploy: every RPC, the
        heal and the promotion, with every check of the phase held."""
        from fleetflow_tpu_torch import _ext
        from fleetflow_tpu_torch.obs.metrics import REGISTRY
        from fleetflow_tpu_torch.sched.gpu import GpuSolverScheduler
        from fleetflow_tpu_torch.solver.repair import verify
        monkeypatch.setattr(wire_rehearsal, "WIRE_DIR", str(tmp_path))
        place = GpuSolverScheduler.place
        flow, pool = _small_fleet()
        launches = wire_rehearsal.run_wire_phase(
            torch, np, _ext, REGISTRY, verify, "cpu", flow, pool, "CARD",
            device="cpu", agents=8, services=40, arrivals=6, kill=3)
        assert GpuSolverScheduler.place is place
        assert set(launches) == set(_ext.LAUNCHES)
        rows = [json.loads(ln.split(" ", 1)[1])
                for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[wire] {")]
        rpcs = [r["rpc"] for r in rows if "rpc" in r]
        for want in ("solve t0/prod", "commit t0/prod",
                     "node_events one node", "node_events 3 nodes",
                     "solver.slots", "deploy.submit 6 arrivals",
                     "agent.register x8", "deploy.execute chaosfleet/app0",
                     "promotion", "promoted solve t0/prod"):
            assert want in rpcs, (want, rpcs)
        solve = next(r for r in rows if r.get("rpc") == "solve t0/prod")
        assert solve["reply_solve_ms"] > 0 and solve["solves"] == 1
        heal = next(r for r in rows if r.get("rpc", "").startswith("heal "))
        assert heal["heal_records"] >= 1 and heal["solves"] >= 1
        end = rows[-1]
        assert end["budget_s"] == wire_rehearsal.WIRE_BUDGET_S
        assert end["heal_s"] > 0 and end["promote_s"] > 0
        assert any(r.get("errors") == {} and r.get("fallbacks") == 0
                   for r in rows)

    def test_a_device_fault_fails_the_phase(self, wire_rehearsal, tmp_path,
                                            monkeypatch):
        from fleetflow_tpu_torch import _ext
        from fleetflow_tpu_torch.core.errors import KernelError
        from fleetflow_tpu_torch.cp.placement import PlacementService
        from fleetflow_tpu_torch.obs.metrics import REGISTRY
        from fleetflow_tpu_torch.solver.repair import verify
        monkeypatch.setattr(wire_rehearsal, "WIRE_DIR", str(tmp_path))

        def boom(self, *a, **k):
            raise KernelError("k4_greedy: launch failed")
        monkeypatch.setattr(PlacementService, "solve_stage", boom)
        flow, pool = _small_fleet()
        with pytest.raises(Exception, match="KernelError"):
            wire_rehearsal.run_wire_phase(
                torch, np, _ext, REGISTRY, verify, "cpu", flow, pool,
                "CARD", device="cpu", agents=4, services=20, arrivals=2,
                kill=2)


# --------------------------------------------------------------------------
# device faults
# --------------------------------------------------------------------------

def _errors(P, channel):
    return P.metrics.REGISTRY.get("fleet_cp_request_errors_total").value(
        channel=channel)


class TestDeviceFaults:
    @pytest.mark.parametrize("rpc", ["placement.solve", "deploy.execute"])
    def test_kernel_error_reaches_the_client(self, project, monkeypatch,
                                             rpc):
        root, _ = project
        from fleetflow_tpu_torch.core.errors import KernelError

        def boom(*a, **k):
            raise KernelError("k4_greedy: an illegal memory access")

        async def go():
            handle = await start_cp(PORT_CARD)
            agent = await FakeAgent(PORT_CARD, "node-1").connect(handle)
            monkeypatch.setattr(handle.state.placement, "solve_stage", boom)
            conn, task = await connect(PORT_CARD, handle)
            flow = load_flow(PORT, root)
            flow.stages["local"].servers = ["node-1"]
            channel, method = rpc.split(".")
            payload = ({"flow": PORT.serialize.flow_to_dict(flow),
                        "stage": "local"} if channel == "placement" else
                       {"request": PORT.runtime.DeployRequest(
                           flow=flow, stage_name="local").to_dict()})
            before = _errors(PORT, channel)
            with pytest.raises(PORT.protocol.RpcError,
                               match="KernelError: k4_greedy") as e:
                await conn.request(channel, method, payload)
            moved = _errors(PORT, channel) - before
            deps = handle.state.store.deployment_history()
            await agent.conn.close()
            await conn.close()
            task.cancel()
            await handle.stop()
            return moved, deps, str(e.value)
        moved, deps, msg = run(go())
        assert moved == 1
        if rpc == "deploy.execute":
            assert deps[0].status == "failed"
            assert "k4_greedy" in deps[0].error

    def test_a_loop_ended_by_a_device_fault_is_logged(self, monkeypatch):
        """The reconverger's loop, as start spawns it, ends on a device
        fault; the server logs the ending, keeps serving, and stops."""
        from fleetflow_tpu_torch.core.errors import KernelError
        from fleetflow_tpu_torch.cp.reconverge import Reconverger
        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(record)

        async def step(self):
            raise KernelError("k2_prerepair: launch failed")
        monkeypatch.setattr(Reconverger, "step", step)
        log = logging.getLogger("fleetflow.cp.server")
        keep = Keep(level=logging.ERROR)
        log.addHandler(keep)

        async def go():
            handle = await start_cp(PORT_CARD, heal_interval_s=0.01)
            task = handle.state.reconverger._task
            for _ in range(100):
                if task.done():
                    break
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.01)
            conn, ctask = await connect(PORT_CARD, handle)
            pong = await conn.request("health", "ping")
            await conn.close()
            ctask.cancel()
            await asyncio.wait_for(handle.stop(), 10)
            return pong, task.done()
        try:
            pong, ended = run(go())
        finally:
            log.removeHandler(keep)
        assert pong["pong"] and ended
        msgs = [r.getMessage() for r in records]
        assert any("reconverge loop ended" in m and "KernelError" in m
                   for m in msgs), msgs

    def test_start_without_cuda_raises_before_listening(self):
        from fleetflow_tpu_torch.core.errors import DeviceUnavailable
        from fleetflow_tpu_torch.cp import ServerConfig, start
        if torch.cuda.is_available():
            pytest.skip("a card is present: start would take it")
        listening = []
        from fleetflow_tpu_torch.cp import protocol
        orig = protocol.ProtocolServer.start

        async def spy(self, *a, **k):
            listening.append(1)
            return await orig(self, *a, **k)

        async def go():
            await start(ServerConfig())
        protocol.ProtocolServer.start = spy
        try:
            with pytest.raises(DeviceUnavailable):
                run(go())
        finally:
            protocol.ProtocolServer.start = orig
        assert listening == []

    def test_default_config_is_the_card(self):
        cfg = PORT.cp.ServerConfig()
        assert cfg.use_gpu_solver is True and cfg.device is None
        assert config(PORT_CARD).device == "cpu"
        assert config(PORT).use_gpu_solver is False
