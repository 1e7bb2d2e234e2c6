"""Shared helpers of the wire tests (tests/test_torch_server.py,
tests/test_torch_auth.py): both packages' control-plane modules side by
side, a control-plane server of either package started on 127.0.0.1 with
the case's solver, and the reference's fake agent contract
(tests/test_cp.py:43-77) over either package's client.

Three packages: the reference (its server's default host greedy solver),
the port on the reference's host path (``use_gpu_solver=False``) and the
port's card scheduler on the CPU (``device="cpu"``: its plain PyTorch
versions).
"""

from __future__ import annotations

import asyncio
import importlib
from types import SimpleNamespace

_MODS = dict(cp="cp", protocol="cp.protocol", auth="cp.auth",
             models="cp.models", store="cp.store", server="cp.server",
             handlers="cp.handlers", placement="cp.placement",
             log_router="cp.log_router", runtime="runtime",
             errors="core.errors", serialize="core.serialize",
             loader="core.loader", provider="cloud.provider",
             metrics="obs.metrics")


def package(root: str, name: str, solver: dict) -> SimpleNamespace:
    return SimpleNamespace(root=root, name=name, solver=dict(solver), **{
        k: importlib.import_module(f"{root}.{m}") for k, m in _MODS.items()})


REF = package("fleetflow_tpu", "ref", {})
PORT = package("fleetflow_tpu_torch", "port", {"use_gpu_solver": False})
PORT_CARD = package("fleetflow_tpu_torch", "port-card", {"device": "cpu"})
ALL = (REF, PORT, PORT_CARD)
HOSTS = (REF, PORT)


def ids(pkgs) -> list:
    return [p.name for p in pkgs]


def run(coro, timeout: float = 60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def config(P, **kw):
    """P's ServerConfig with the case's solver. A reference test's
    `use_tpu_solver=True` names the reference's device solver: the port's
    counterpart is its card scheduler (on the CPU here)."""
    tpu = kw.pop("use_tpu_solver", None)
    if P.root == "fleetflow_tpu":
        if tpu is not None:
            kw["use_tpu_solver"] = tpu
        return P.cp.ServerConfig(**kw)
    solver = {"device": "cpu"} if tpu else dict(P.solver)
    return P.cp.ServerConfig(**solver, **kw)


def mock_backend(P):
    return lambda: P.runtime.MockBackend(auto_pull=True)


async def start_cp(P, start_kw=None, **kw):
    return await P.cp.start(config(P, **kw), backend_factory=mock_backend(P),
                            deploy_sleep=lambda d: None, **(start_kw or {}))


async def connect(P, handle, identity="cli", token=None, **kw):
    return await P.protocol.ProtocolClient.connect(
        handle.host, handle.port, identity=identity, token=token, **kw)


class FakeAgent:
    """The agent wire contract: register request, then heartbeats / alerts
    / logs as events, and command_result correlation for inbound commands
    (fleet-agent agent.rs:215-254), over package P's client."""

    def __init__(self, P, slug: str):
        self.P = P
        self.slug = slug
        self.commands: list[tuple[str, dict]] = []
        self.conn = None
        self.task = None
        self.respond = lambda cmd, payload: {"ok": True, "cmd": cmd}

    async def connect(self, handle, token=None,
                      capacity=None) -> "FakeAgent":
        async def on_event(conn, method, payload):
            rid = payload.get("request_id")
            self.commands.append((method, payload.get("payload", {})))
            result = self.respond(method, payload.get("payload", {}))
            if rid:
                await conn.send_event("agent", "command_result",
                                      {"request_id": rid, "result": result})

        self.conn, self.task = await self.P.protocol.ProtocolClient.connect(
            handle.host, handle.port, identity=self.slug, token=token,
            event_handlers={"agent": on_event})
        reply = await self.conn.request("agent", "register", {
            "slug": self.slug, "version": "0.1.0",
            "capacity": capacity or {"cpu": 8, "memory": 16384,
                                     "disk": 102400}})
        assert reply["registered"]
        return self


def load_flow(P, root):
    """The conftest `project` fixture's flow, loaded by package P."""
    return P.loader.load_project_from_root_with_stage(str(root), "local")
