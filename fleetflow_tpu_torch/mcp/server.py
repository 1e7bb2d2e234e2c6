"""MCP server: stdio JSON-RPC 2.0.

Analog of fleetflow-mcp lib.rs:146-1003 (rmcp #[tool_router]): implements
the Model Context Protocol handshake (initialize / tools/list / tools/call)
directly over stdio — no SDK dependency — and exposes the same tool
surface: local project tools against the loaded Flow + runtime backend,
and CP tools over the protocol client.

Every tool returns MCP `content: [{type: "text", text: ...}]` with JSON
payloads, matching how the reference's tools serialize results.

`fleet_solve` places on the card (`device=None`; "cpu" runs the card
scheduler's plain versions). Without CUDA its call answers with the
DeviceUnavailable error, as any failing tool does; it never places on the
host instead.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Callable, Optional

from ..core.errors import FlowError
from ..core.loader import load_project
from ..lower.tensors import lower_stage
from ..sched import pick_scheduler, place_with_fallback

__all__ = ["FleetMcpServer", "serve_stdio"]

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "fleetflow-tpu-mcp", "version": "0.1.0"}


def _tool(name: str, description: str, schema: Optional[dict] = None):
    def deco(fn):
        fn._mcp = {"name": name, "description": description,
                   "inputSchema": schema or {"type": "object",
                                             "properties": {}}}
        return fn
    return deco


def _text(payload: Any) -> dict:
    text = payload if isinstance(payload, str) else json.dumps(
        payload, indent=2, default=str)
    return {"content": [{"type": "text", "text": text}]}


_STAGE_SCHEMA = {"type": "object", "properties": {
    "stage": {"type": "string", "description": "stage name (default local)"}}}


class FleetMcpServer:
    def __init__(self, project_root: Optional[str] = None,
                 cp_endpoint: Optional[str] = None,
                 backend=None, cp_client=None, device=None):
        self.project_root = project_root
        # the card solver's device for fleet_solve (None: the card)
        self.device = device
        self.cp_endpoint = cp_endpoint
        self._backend = backend
        self._cp = cp_client
        self.tools: dict[str, Callable] = {}
        for attr in dir(self):
            fn = getattr(self, attr)
            if callable(fn) and hasattr(fn, "_mcp"):
                self.tools[fn._mcp["name"]] = fn

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def _flow(self, stage: Optional[str] = None):
        return load_project(stage=stage or "local", start=self.project_root)

    def backend(self):
        if self._backend is None:
            from ..runtime.backend import DockerCliBackend
            self._backend = DockerCliBackend()
        return self._backend

    def cp(self):
        if self._cp is None:
            from ..cli.client import CpClient
            self._cp = CpClient(self.cp_endpoint).connect()
        return self._cp

    def handle(self, msg: dict) -> Optional[dict]:
        """One JSON-RPC message -> response (None for notifications)."""
        mid = msg.get("id")
        method = msg.get("method", "")
        params = msg.get("params", {})
        if mid is None:
            return None   # notifications (initialized, cancelled) need no reply
        try:
            if method == "initialize":
                result = {"protocolVersion": PROTOCOL_VERSION,
                          "capabilities": {"tools": {}},
                          "serverInfo": SERVER_INFO}
            elif method == "tools/list":
                result = {"tools": [fn._mcp for fn in self.tools.values()]}
            elif method == "tools/call":
                name = params.get("name", "")
                fn = self.tools.get(name)
                if fn is None:
                    raise FlowError(f"unknown tool {name!r}")
                result = fn(**(params.get("arguments") or {}))
            elif method == "ping":
                result = {}
            else:
                return {"jsonrpc": "2.0", "id": mid,
                        "error": {"code": -32601,
                                  "message": f"method not found: {method}"}}
            return {"jsonrpc": "2.0", "id": mid, "result": result}
        except Exception as e:
            return {"jsonrpc": "2.0", "id": mid,
                    "result": {"content": [{"type": "text",
                                            "text": f"error: {e}"}],
                               "isError": True}}

    # ------------------------------------------------------------------
    # local tools (lib.rs:165-417)
    # ------------------------------------------------------------------

    @_tool("project_analyze", "Summarize the fleet project: services, "
           "stages, dependencies, resources", _STAGE_SCHEMA)
    def project_analyze(self, stage: str = "local") -> dict:
        flow = self._flow(stage)
        return _text({
            "project": flow.name,
            "stages": {name: {"services": st.services,
                              "servers": st.servers,
                              "backend": st.backend.value}
                       for name, st in flow.stages.items()},
            "services": {name: {
                "image": svc.image_name(),
                "depends_on": svc.depends_on,
                "ports": [f"{p.host}:{p.container}" for p in svc.ports],
                "resources": {"cpu": svc.resources.cpu,
                              "memory": svc.resources.memory}}
                for name, svc in flow.services.items()},
            "servers": sorted(flow.servers),
        })

    @_tool("fleet_ps", "List this project's containers", _STAGE_SCHEMA)
    def fleet_ps(self, stage: str = "local") -> dict:
        flow = self._flow(stage)
        infos = self.backend().list(label_filter={
            "fleetflow.project": flow.name, "fleetflow.stage": stage})
        return _text([{"name": i.name, "state": i.state, "health": i.health,
                       "image": i.image} for i in infos])

    @_tool("fleet_up", "Start a stage's services", _STAGE_SCHEMA)
    def fleet_up(self, stage: str = "local") -> dict:
        from ..runtime.engine import DeployEngine, DeployRequest
        flow = self._flow(stage)
        events: list[str] = []
        res = DeployEngine(self.backend()).execute(
            DeployRequest(flow=flow, stage_name=stage),
            on_event=lambda e: events.append(str(e)))
        return _text({"ok": res.ok, "deployed": res.deployed,
                      "failed": res.failed, "events": events[-20:]})

    @_tool("fleet_down", "Stop a stage", _STAGE_SCHEMA)
    def fleet_down(self, stage: str = "local") -> dict:
        from ..runtime.engine import DeployEngine
        flow = self._flow(stage)
        res = DeployEngine(self.backend()).down(flow, stage)
        return _text({"removed": res.removed})

    @_tool("fleet_logs", "Tail one service's container logs",
           {"type": "object", "properties": {
               "service": {"type": "string"},
               "stage": {"type": "string"},
               "tail": {"type": "integer"}},
            "required": ["service"]})
    def fleet_logs(self, service: str, stage: str = "local",
                   tail: int = 100) -> dict:
        from ..runtime.converter import container_name
        flow = self._flow(stage)
        return _text(self.backend().logs(
            container_name(flow.name, stage, service), tail=tail))

    @_tool("fleet_restart", "Restart one service's container",
           {"type": "object", "properties": {
               "service": {"type": "string"}, "stage": {"type": "string"}},
            "required": ["service"]})
    def fleet_restart(self, service: str, stage: str = "local") -> dict:
        from ..runtime.converter import container_name
        flow = self._flow(stage)
        cname = container_name(flow.name, stage, service)
        self.backend().restart(cname)
        return _text({"restarted": cname})

    @_tool("fleet_validate", "Validate config and placement feasibility")
    def fleet_validate(self) -> dict:
        flow = self._flow()
        out = {}
        for stage_name in sorted(flow.stages):
            try:
                pt = lower_stage(flow, stage_name)
                pl, _ = place_with_fallback(
                    pick_scheduler(pt.S, pt.N, prefer_gpu=False), pt)
                out[stage_name] = {"services": pt.S, "nodes": pt.N,
                                   "feasible": pl.feasible,
                                   "violations": pl.violations}
            except FlowError as e:
                out[stage_name] = {"error": str(e)}
        return _text(out)

    @_tool("fleet_build", "Build a service's image",
           {"type": "object", "properties": {
               "service": {"type": "string"}}, "required": ["service"]})
    def fleet_build(self, service: str) -> dict:
        from ..build import BuildResolver, ImageBuilder
        flow = self._flow()
        svc = flow.services.get(service)
        if svc is None or svc.build is None:
            raise FlowError(f"service {service!r} has no build config")
        resolved = BuildResolver(self.project_root or ".").resolve(svc)
        tag = ImageBuilder().build(resolved)
        return _text({"image": tag})

    @_tool("fleet_solve", "Solve a stage's placement on the GPU solver",
           {"type": "object", "properties": {
               "stage": {"type": "string"},
               "host_only": {"type": "boolean"}}})
    def fleet_solve(self, stage: str = "local",
                    host_only: bool = False) -> dict:
        flow = self._flow(stage)
        pt = lower_stage(flow, stage)
        pl, _ = place_with_fallback(
            pick_scheduler(pt.S, pt.N, prefer_gpu=not host_only,
                           device=self.device), pt)
        return _text({"assignment": pl.assignment, "feasible": pl.feasible,
                      "violations": pl.violations, "source": pl.source,
                      "solve_ms": round(pl.solve_ms, 1)})

    # ------------------------------------------------------------------
    # CP tools (lib.rs:557-1003)
    # ------------------------------------------------------------------

    @_tool("cp_auth_status", "Check control-plane connectivity and auth")
    def cp_auth_status(self) -> dict:
        try:
            out = self.cp().request("health", "ping")
            return _text({"connected": True, "pong": out})
        except Exception as e:
            return _text({"connected": False, "error": str(e)})

    @_tool("cp_overview", "Cluster overview: servers, agents, alerts")
    def cp_overview(self) -> dict:
        return _text(self.cp().request("health", "overview"))

    @_tool("cp_projects", "List control-plane projects",
           {"type": "object", "properties": {"tenant": {"type": "string"}}})
    def cp_projects(self, tenant: Optional[str] = None) -> dict:
        return _text(self.cp().request("project", "list",
                                       {"tenant": tenant})["projects"])

    @_tool("cp_servers", "List registered servers with capacity/allocation")
    def cp_servers(self) -> dict:
        return _text(self.cp().request("server", "list")["servers"])

    @_tool("cp_alerts", "Active alerts (restart loops, unexpected stops, "
           "unhealthy containers, offline nodes)",
           {"type": "object", "properties": {"tenant": {"type": "string"}}})
    def cp_alerts(self, tenant: Optional[str] = None) -> dict:
        return _text(self.cp().request("health", "alerts",
                                       {"tenant": tenant})["alerts"])

    @_tool("cp_pools", "Worker pools with min/max and member servers")
    def cp_pools(self) -> dict:
        return _text(self.cp().request("server", "pool.list")["pools"])

    @_tool("cp_tenant_overview", "One tenant's projects/servers/alerts",
           {"type": "object", "properties": {"tenant": {"type": "string"}},
            "required": ["tenant"]})
    def cp_tenant_overview(self, tenant: str) -> dict:
        projects = self.cp().request("project", "list",
                                     {"tenant": tenant})["projects"]
        return _text({"tenant": tenant, "projects": projects})

    @_tool("cp_project_detail", "One project's record and stages "
           "(fleetflow_cp_project_detail)",
           {"type": "object", "properties": {"project": {"type": "string"},
                                             "tenant": {"type": "string"}},
            "required": ["project"]})
    def cp_project_detail(self, project: str, tenant: str = "default") -> dict:
        # without a tenant the handler defaults to 'default' and projects
        # in other tenants come back null even though cp_projects can list
        # them (ADVICE r2)
        rec = self.cp().request("project", "get",
                                {"name": project, "tenant": tenant})
        proj = rec.get("project")
        # stages are keyed by project ID, not the human name
        stages = (self.cp().request(
            "stage", "list", {"project": proj["id"]})["stages"]
            if proj else [])
        return _text({"project": proj, "stages": stages})

    @_tool("cp_stage_services", "Services registered under a stage "
           "(fleetflow_cp_stage_services)",
           {"type": "object", "properties": {"stage_id": {"type": "string"}},
            "required": ["stage_id"]})
    def cp_stage_services(self, stage_id: str) -> dict:
        return _text(self.cp().request("service", "list",
                                       {"stage": stage_id})["services"])

    @_tool("cp_stage_status", "Services/deployments/alerts of a stage",
           {"type": "object", "properties": {"stage_id": {"type": "string"}},
            "required": ["stage_id"]})
    def cp_stage_status(self, stage_id: str) -> dict:
        return _text(self.cp().request("stage", "status", {"stage": stage_id}))

    @_tool("cp_deployments", "Deployment history",
           {"type": "object", "properties": {"stage_id": {"type": "string"},
                                             "limit": {"type": "integer"}}})
    def cp_deployments(self, stage_id: Optional[str] = None,
                       limit: int = 20) -> dict:
        return _text(self.cp().request("deploy", "history",
                                       {"stage": stage_id,
                                        "limit": limit})["deployments"])

    @_tool("cp_service_restart", "Restart a container via its node agent",
           {"type": "object", "properties": {
               "server": {"type": "string"}, "container": {"type": "string"}},
            "required": ["server", "container"]})
    def cp_service_restart(self, server: str, container: str) -> dict:
        return _text(self.cp().request("service", "restart",
                                       {"server": server,
                                        "container": container}))

    @_tool("cp_container_logs", "Cached container logs from the log router",
           {"type": "object", "properties": {
               "server": {"type": "string"}, "container": {"type": "string"},
               "limit": {"type": "integer"}},
            "required": ["server", "container"]})
    def cp_container_logs(self, server: str, container: str,
                          limit: int = 50) -> dict:
        out = self.cp().request("container", "logs",
                                {"server": server, "container": container,
                                 "limit": limit})
        return _text([e["line"] for e in out["lines"]])

    @_tool("cp_containers", "Observed containers across the fleet",
           {"type": "object", "properties": {"server": {"type": "string"}}})
    def cp_containers(self, server: Optional[str] = None) -> dict:
        return _text(self.cp().request("container", "ps",
                                       {"server": server})["containers"])

    @_tool("cp_container_start", "Start a stopped container via its node "
           "agent (fleetflow_cp_container_start)",
           {"type": "object", "properties": {
               "server": {"type": "string"}, "container": {"type": "string"}},
            "required": ["server", "container"]})
    def cp_container_start(self, server: str, container: str) -> dict:
        return _text(self.cp().request("container", "start",
                                       {"server": server,
                                        "container": container}))

    @_tool("cp_container_stop", "Stop a running container via its node "
           "agent (fleetflow_cp_container_stop)",
           {"type": "object", "properties": {
               "server": {"type": "string"}, "container": {"type": "string"}},
            "required": ["server", "container"]})
    def cp_container_stop(self, server: str, container: str) -> dict:
        return _text(self.cp().request("container", "stop",
                                       {"server": server,
                                        "container": container}))

    @_tool("cp_container_restart", "Restart a container via its node "
           "agent (fleetflow_cp_container_restart)",
           {"type": "object", "properties": {
               "server": {"type": "string"}, "container": {"type": "string"}},
            "required": ["server", "container"]})
    def cp_container_restart(self, server: str, container: str) -> dict:
        return _text(self.cp().request("container", "restart",
                                       {"server": server,
                                        "container": container}))

    @_tool("cp_agents", "Connected node agents")
    def cp_agents(self) -> dict:
        return _text(self.cp().request("health", "overview")["agents"])

    @_tool("cp_tenant_users", "A tenant's users",
           {"type": "object", "properties": {"tenant": {"type": "string"}},
            "required": ["tenant"]})
    def cp_tenant_users(self, tenant: str) -> dict:
        return _text(self.cp().request("tenant", "user.list",
                                       {"tenant": tenant})["users"])

    @_tool("cp_placement_solve", "Solve placement for a flow stage against "
           "live CP inventory",
           {"type": "object", "properties": {"stage": {"type": "string"}},
            "required": ["stage"]})
    def cp_placement_solve(self, stage: str) -> dict:
        from ..core.serialize import flow_to_dict
        flow = self._flow(stage)
        return _text(self.cp().request("placement", "solve",
                                       {"flow": flow_to_dict(flow),
                                        "stage": stage}))

    @_tool("cp_placement_explain", "Why is a service on its node: per-node "
           "hard/soft breakdown of the stage's latest placement",
           {"type": "object", "properties": {
               "stage": {"type": "string",
                         "description": "stage key, <flow>/<stage>"},
               "service": {"type": "string"}},
            "required": ["stage", "service"]})
    def cp_placement_explain(self, stage: str, service: str) -> dict:
        return _text(self.cp().request("placement", "explain",
                                       {"stage": stage, "service": service}))

    @_tool("cp_redeploy", "Redeploy a stage through the control plane",
           {"type": "object", "properties": {"stage": {"type": "string"}},
            "required": ["stage"]})
    def cp_redeploy(self, stage: str) -> dict:
        from ..runtime.engine import DeployRequest
        flow = self._flow(stage)
        req = DeployRequest(flow=flow, stage_name=stage)
        return _text(self.cp().request("deploy", "execute",
                                       {"request": req.to_dict()},
                                       timeout=600))

    @_tool("cp_cost_summary", "Monthly cost total for a tenant "
           "(YYYY-MM month)",
           {"type": "object", "properties": {
               "month": {"type": "string"},
               "tenant": {"type": "string"}},
            "required": ["month"]})
    def cp_cost_summary(self, month: str, tenant: str = "default") -> dict:
        return _text(self.cp().request("cost", "summary",
                                       {"month": month, "tenant": tenant}))

    @_tool("cp_cost_list", "List recorded cost entries, optionally "
           "filtered by tenant and/or YYYY-MM month",
           {"type": "object", "properties": {
               "tenant": {"type": "string"},
               "month": {"type": "string"}}})
    def cp_cost_list(self, tenant: str = None, month: str = None) -> dict:
        return _text(self.cp().request("cost", "list",
                                       {"tenant": tenant, "month": month}))

    @_tool("cp_node_events", "Report a churn burst (nodes going offline/"
           "online) as ONE coalesced warm re-solve — maintenance windows "
           "should use this instead of N single node_event calls",
           {"type": "object", "properties": {
               "events": {"type": "array", "items": {
                   "type": "object", "properties": {
                       "slug": {"type": "string"},
                       "online": {"type": "boolean"}},
                   "required": ["slug", "online"]}}},
            "required": ["events"]})
    def cp_node_events(self, events: list) -> dict:
        return _text(self.cp().request("placement", "node_events",
                                       {"events": events}, timeout=120))

    @_tool("cp_server_cordon", "Cordon, uncordon, or drain a server "
           "(drain also warm-reschedules its services)",
           {"type": "object", "properties": {
               "slug": {"type": "string"},
               "action": {"type": "string",
                          "enum": ["cordon", "uncordon", "drain"]}},
            "required": ["slug", "action"]})
    def cp_server_cordon(self, slug: str, action: str) -> dict:
        if action not in ("cordon", "uncordon", "drain"):
            raise ValueError(f"unknown action {action!r}")
        return _text(self.cp().request("server", action, {"slug": slug},
                                       timeout=120))


def serve_stdio(project_root: Optional[str] = None,
                cp_endpoint: Optional[str] = None,
                stdin=None, stdout=None, device=None) -> None:
    """Line-delimited JSON-RPC over stdio (the MCP stdio transport)."""
    server = FleetMcpServer(project_root=project_root,
                            cp_endpoint=cp_endpoint, device=device)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        resp = server.handle(msg)
        if resp is not None:
            stdout.write(json.dumps(resp) + "\n")
            stdout.flush()
