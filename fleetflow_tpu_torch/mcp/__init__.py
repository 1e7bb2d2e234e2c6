"""MCP server (L6).

Analog of fleetflow-mcp (SURVEY.md §2.8): ~25 tools over stdio JSON-RPC —
local project tools (analyze/ps/up/down/logs/restart/validate/build/solve)
and CP tools (status/overview/projects/servers/stage status/redeploy/
restart/container logs/alerts/agents/tenant users).
"""

from .server import FleetMcpServer, serve_stdio

__all__ = ["FleetMcpServer", "serve_stdio"]
