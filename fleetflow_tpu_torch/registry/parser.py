"""fleet-registry.kdl parser.

Analog of fleetflow-registry parser.rs:12-73: parses `fleet`, `server`
(reusing the core server parser, parser.rs:18), and `route` nodes, then
validates route referential integrity.

Document shape:

    fleet "blog" path="~/code/blog" description="the blog" tenant="acme"
    server "web-1" { capacity { cpu 4; memory 8192 } labels { tier "std" } }
    route fleet="blog" stage="live" server="web-1"

The port's copy of ``fleetflow_tpu/registry/parser.py``.
"""

from __future__ import annotations

import os

from ..core.kdl import parse_document
from ..core.parser import parse_server
from .model import DeploymentRoute, FleetEntry, Registry

__all__ = ["parse_registry_string", "parse_registry_file"]


def parse_registry_string(text: str, source: str | None = None) -> Registry:
    reg = Registry(source=source)
    for node in parse_document(text):
        if node.name == "fleet":
            name = node.first_string()
            if not name:
                raise ValueError("fleet node requires a name argument")
            path = str(node.prop("path", ""))
            if not path:
                raise ValueError(f"fleet {name!r} requires path=")
            reg.fleets[name] = FleetEntry(
                name=name, path=os.path.expanduser(path),
                description=str(node.prop("description", "")),
                tenant=node.prop("tenant"))
        elif node.name == "server":
            server = parse_server(node)
            reg.servers[server.name] = server
        elif node.name == "route":
            fleet = node.prop("fleet") or node.arg(0)
            stage = node.prop("stage") or node.arg(1)
            server = node.prop("server") or node.arg(2)
            if not (fleet and stage and server):
                raise ValueError("route requires fleet=, stage=, server=")
            reg.routes.append(DeploymentRoute(
                fleet=str(fleet), stage=str(stage), server=str(server)))
        # unknown nodes ignored (forward compatibility)
    reg.validate()
    return reg


def parse_registry_file(path: str) -> Registry:
    with open(path) as f:
        return parse_registry_string(f.read(), source=path)
