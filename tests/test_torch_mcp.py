"""The port's MCP server (fleetflow_tpu_torch.mcp) against the
reference's (fleetflow_tpu.mcp), on the CPU.

- the handshake: ``initialize`` equal (``SERVER_INFO`` kept), and
  ``tools/list`` equal apart from ``fleet_solve``'s description, which
  names the GPU solver;
- tests/test_cli_mcp.py's MCP cases on the port, each tool answer of the
  local project tools (analyze, up, ps, solve on the host, validate, down)
  and the CP tools over a fake client equal to the reference's;
- ``fleet_solve`` on the card path (``device="cpu"``): feasible, 0
  violations, source ``gpu-anneal``; without CUDA the call answers with
  the DeviceUnavailable error and no placement;
- the stdio transport in process and as ``python -m fleetflow_tpu_torch
  .cli --device cpu mcp``.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from fleetflow_tpu.mcp import server as ref_server
from fleetflow_tpu.runtime import MockBackend as RefMock
from fleetflow_tpu_torch.mcp import server as port_server
from fleetflow_tpu_torch.mcp.server import FleetMcpServer, serve_stdio
from fleetflow_tpu_torch.runtime import MockBackend
from test_torch_cli import card_project  # noqa: F401  (a fixture)
from test_torch_cli import check_assignment

REPO = Path(__file__).resolve().parent.parent
NO_CUDA = "needs a CUDA device"
# the tool descriptions the port rewords: the placement runs on the card
REWORDED = {"fleet_solve": "Solve a stage's placement on the GPU solver"}


def rpc(server, method, params=None, mid=1):
    msg = {"jsonrpc": "2.0", "id": mid, "method": method}
    if params is not None:
        msg["params"] = params
    return server.handle(msg)


def call(server, name, **kw):
    return rpc(server, "tools/call", {"name": name, "arguments": kw})


def text(resp):
    assert not resp["result"].get("isError"), resp
    return json.loads(resp["result"]["content"][0]["text"])


def norm(doc):
    """The answer with the host wall times (the engine's event lines)
    normalised."""
    return json.loads(re.sub(r"\d+\.\d+(m?s)", r"<t>\1", json.dumps(doc)))


def pair(root, **kw):
    """The reference's server and the port's on the same project, each
    with its own mock backend."""
    return (ref_server.FleetMcpServer(project_root=str(root),
                                      backend=RefMock(auto_pull=True), **kw),
            FleetMcpServer(project_root=str(root),
                           backend=MockBackend(auto_pull=True), **kw))


class TestHandshake:
    def test_initialize_equal(self, project):
        ref, port = pair(project[0])
        assert rpc(port, "initialize", {}) == rpc(ref, "initialize", {})
        assert rpc(port, "initialize", {})["result"]["serverInfo"] == \
            {"name": "fleetflow-tpu-mcp", "version": "0.1.0"}

    def test_tools_list_equal_but_the_reworded(self, project):
        ref, port = pair(project[0])
        a = rpc(ref, "tools/list", mid=2)["result"]["tools"]
        b = rpc(port, "tools/list", mid=2)["result"]["tools"]
        assert [t["name"] for t in a] == [t["name"] for t in b]
        assert len(b) >= 20
        for ta, tb in zip(a, b):
            if tb["name"] in REWORDED:
                assert tb["description"] == REWORDED[tb["name"]]
                assert "TPU" in ta["description"]
                assert dict(ta, description=None) == \
                    dict(tb, description=None)
            else:
                assert ta == tb

    def test_notification_and_errors(self, project):
        _, port = pair(project[0])
        assert port.handle({"jsonrpc": "2.0",
                            "method": "notifications/initialized"}) is None
        assert call(port, "nope")["result"]["isError"]
        assert rpc(port, "bogus/method", mid=2)["error"]["code"] == -32601
        assert rpc(port, "ping")["result"] == {}


class TestLocalTools:
    def test_analyze_up_ps_solve_down_equal(self, project):
        ref, port = pair(project[0])
        for name, kw in (("project_analyze", {}),
                         ("fleet_up", {"stage": "local"}),
                         ("fleet_ps", {"stage": "local"}),
                         ("fleet_validate", {}),
                         ("fleet_down", {"stage": "local"})):
            a, b = (norm(text(call(srv, name, **kw))) for srv in (ref, port))
            assert b == a, name
        doc = text(call(port, "project_analyze"))
        assert doc["project"] == "testproj"
        assert doc["services"]["app"]["depends_on"] == ["postgres", "redis"]

    def test_solve_host_only_equal(self, project):
        ref, port = pair(project[0])
        a = text(call(ref, "fleet_solve", stage="local", host_only=True))
        b = text(call(port, "fleet_solve", stage="local", host_only=True))
        a.pop("solve_ms"), b.pop("solve_ms")
        assert b == a and b["source"] == "host-greedy" and b["feasible"]

    def test_mock_lifecycle(self, project):
        _, port = pair(project[0])
        up = text(call(port, "fleet_up", stage="local"))
        assert up["ok"] and len(up["deployed"]) == 3
        assert {r["state"] for r in text(call(port, "fleet_ps",
                                              stage="local"))} == {"running"}
        assert len(text(call(port, "fleet_down", stage="local"))
                   ["removed"]) == 3


class TestCardSolve:
    def test_fleet_solve_on_the_card_solver(self, card_project):
        server = FleetMcpServer(project_root=str(card_project),
                                device="cpu")
        doc = text(call(server, "fleet_solve", stage="prod"))
        assert doc["source"] == "gpu-anneal"
        assert doc["feasible"] and doc["violations"] == 0
        check_assignment(card_project, doc["assignment"])
        ref = ref_server.FleetMcpServer(project_root=str(card_project))
        rdoc = text(call(ref, "fleet_solve", stage="prod"))
        assert rdoc["source"] == "tpu-anneal" and rdoc["violations"] == 0
        assert sorted(rdoc["assignment"]) == sorted(doc["assignment"])

    def test_fleet_solve_without_cuda_is_an_error(self, card_project):
        server = FleetMcpServer(project_root=str(card_project))
        resp = call(server, "fleet_solve", stage="prod")
        assert resp["result"]["isError"]
        msg = resp["result"]["content"][0]["text"]
        assert msg.startswith("error: ") and NO_CUDA in msg
        # host_only asks for the host placer, which needs no card
        doc = text(call(server, "fleet_solve", stage="prod",
                        host_only=True))
        assert doc["source"] in ("host-greedy", "native-ffd") \
            and doc["feasible"]

    def test_validate_stays_on_the_host(self, card_project):
        ref = ref_server.FleetMcpServer(project_root=str(card_project))
        port = FleetMcpServer(project_root=str(card_project))
        assert text(call(port, "fleet_validate")) == \
            text(call(ref, "fleet_validate"))


class FakeCp:
    def __init__(self, answer):
        self.calls = []
        self.answer = answer

    def request(self, channel, method, payload=None, timeout=60.0):
        self.calls.append((channel, method, payload))
        return self.answer(channel, method, payload)


@pytest.mark.parametrize("name,args", [
    ("cp_overview", {}), ("cp_servers", {}), ("cp_auth_status", {}),
    ("cp_node_events", {"events": [{"slug": "n1", "online": False},
                                   {"slug": "n2", "online": False}]}),
    ("cp_server_cordon", {"slug": "n1", "action": "drain"}),
    ("cp_cost_summary", {"month": "2026-07", "tenant": "acme"}),
    ("cp_cost_list", {"month": "2026-07"})])
def test_cp_tools_equal_the_reference(name, args, project):
    """Each CP tool sends the reference's request and renders its answer
    the same way."""
    def answer(channel, method, payload):
        return {"health.ping": {"pong": True},
                "health.overview": {"agents": ["n1"], "servers": 1},
                "server.list": {"servers": [{"slug": "n1"}]},
                "placement.node_events": {"rescheduled": [
                    {"stage": "p/live", "feasible": True}]},
                "server.drain": {"ok": True,
                                 "scheduling_state": "draining"},
                "cost.summary": {"month": "2026-07", "tenant": "acme",
                                 "total": 42.5},
                "cost.list": {"entries": [{"tenant": "acme",
                                           "amount": 42.5}]},
                }.get(f"{channel}.{method}", {})
    root = str(project[0])
    got = []
    for mod in (ref_server, port_server):
        cp = FakeCp(answer)
        server = mod.FleetMcpServer(project_root=root, cp_client=cp)
        got.append((call(server, name, **args), cp.calls))
    assert got[1] == got[0]
    assert not got[1][0]["result"].get("isError")


class TestStdio:
    def test_transport_equal(self, project):
        root = str(project[0])
        lines = "\n".join([
            json.dumps({"jsonrpc": "2.0", "id": 1, "method": "initialize",
                        "params": {}}),
            "not json at all",
            json.dumps({"jsonrpc": "2.0", "id": 2, "method": "tools/list"}),
            json.dumps({"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                        "params": {"name": "project_analyze"}}),
        ]) + "\n"
        outs = []
        for fn in (ref_server.serve_stdio, serve_stdio):
            out = io.StringIO()
            fn(project_root=root, stdin=io.StringIO(lines), stdout=out)
            outs.append([json.loads(ln) for ln in
                         out.getvalue().splitlines()])
        assert [r["id"] for r in outs[1]] == [1, 2, 3]
        assert outs[1][0] == outs[0][0] and outs[1][2] == outs[0][2]

    def test_cli_mcp_subprocess_on_the_card_solver(self, card_project):
        """`python -m fleetflow_tpu_torch.cli --device cpu mcp` over
        pipes: initialize, tools/list, tools/call fleet_solve."""
        msgs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
                 "params": {}},
                {"jsonrpc": "2.0", "method": "notifications/initialized"},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                 "params": {"name": "fleet_solve",
                            "arguments": {"stage": "prod"}}}]
        proc = subprocess.run(
            [sys.executable, "-m", "fleetflow_tpu_torch.cli",
             "--project-root", str(card_project), "--device", "cpu", "mcp"],
            input="".join(json.dumps(m) + "\n" for m in msgs),
            capture_output=True, text=True, timeout=120, cwd=str(REPO))
        assert proc.returncode == 0, proc.stderr
        replies = [json.loads(ln) for ln in proc.stdout.splitlines()]
        assert [r["id"] for r in replies] == [1, 2, 3]
        doc = text(replies[2])
        assert doc["source"] == "gpu-anneal" and doc["violations"] == 0
