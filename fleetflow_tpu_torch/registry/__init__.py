"""Multi-fleet registry (the port's copy of ``fleetflow_tpu/registry``,
its model and its cross-fleet deploy).

Analog of fleetflow-registry (SURVEY.md §2.9): a `fleet-registry.kdl` that
aggregates many fleets onto a shared server pool with deployment routes.
The port holds the registry model and the route deploy (ssh to each
route's server, the servers-sync payloads). The KDL parser
(`parse_registry_file`, `parse_registry_string`), `find_registry` and the
aggregation of every fleet x stage into one batched placement instance
(`aggregate_fleets`) are not ported yet (ROADMAP queue 1 item 4).
"""

from .model import DeploymentRoute, FleetEntry, Registry
from .deploy import RouteResult, deploy_routes, sync_servers_payloads

__all__ = ["Registry", "FleetEntry", "DeploymentRoute", "RouteResult",
           "deploy_routes", "sync_servers_payloads"]
