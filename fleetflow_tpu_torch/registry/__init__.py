"""Multi-fleet registry (the port's copy of ``fleetflow_tpu/registry``).

Analog of fleetflow-registry (SURVEY.md §2.9): a `fleet-registry.kdl` that
aggregates many fleets onto a shared server pool with deployment routes —
plus the piece the reference points at but never builds: the aggregation
of every registered fleet x stage into ONE batched placement instance (the
10k-service scale axis of BASELINE config 4), which the card's
`GpuSolverScheduler` places.
"""

from .model import DeploymentRoute, FleetEntry, Registry
from .parser import parse_registry_file, parse_registry_string
from .discovery import find_registry
from .aggregate import aggregate_fleets
from .deploy import RouteResult, deploy_routes, sync_servers_payloads

__all__ = ["Registry", "FleetEntry", "DeploymentRoute",
           "parse_registry_file", "parse_registry_string", "find_registry",
           "aggregate_fleets", "RouteResult", "deploy_routes",
           "sync_servers_payloads"]
