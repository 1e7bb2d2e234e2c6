"""Registry model (the port's copy of ``fleetflow_tpu/registry/model.py``).

Analog of fleetflow-registry model.rs:10-63: `Registry` holds fleet entries
(name -> project path), the shared server pool, and deployment routes
(fleet, stage) -> server; `resolve_route` and the `routes_for_*` queries.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.model import ServerResource

__all__ = ["FleetEntry", "DeploymentRoute", "Registry"]


@dataclass
class FleetEntry:
    """model.rs FleetEntry."""
    name: str
    path: str                       # project root containing .fleetflow/
    description: str = ""
    tenant: Optional[str] = None


@dataclass
class DeploymentRoute:
    """model.rs DeploymentRoute: one (fleet, stage) lands on one server."""
    fleet: str
    stage: str
    server: str


@dataclass
class Registry:
    """model.rs Registry:10-63."""
    fleets: dict[str, FleetEntry] = field(default_factory=dict)
    servers: dict[str, ServerResource] = field(default_factory=dict)
    routes: list[DeploymentRoute] = field(default_factory=list)
    source: Optional[str] = None

    def resolve_route(self, fleet: str, stage: str) -> Optional[DeploymentRoute]:
        """model.rs resolve_route: exact (fleet, stage) match."""
        for r in self.routes:
            if r.fleet == fleet and r.stage == stage:
                return r
        return None

    def routes_for_fleet(self, fleet: str) -> list[DeploymentRoute]:
        return [r for r in self.routes if r.fleet == fleet]

    def routes_for_server(self, server: str) -> list[DeploymentRoute]:
        return [r for r in self.routes if r.server == server]

    def validate(self) -> None:
        """Route referential integrity (parser.rs:18-73): every route must
        name a registered fleet and server."""
        for r in self.routes:
            if r.fleet not in self.fleets:
                raise ValueError(
                    f"route ({r.fleet!r}, {r.stage!r}) references unknown "
                    f"fleet; registered: {sorted(self.fleets)}")
            if r.server not in self.servers:
                raise ValueError(
                    f"route ({r.fleet!r}, {r.stage!r}) references unknown "
                    f"server {r.server!r}; registered: {sorted(self.servers)}")
