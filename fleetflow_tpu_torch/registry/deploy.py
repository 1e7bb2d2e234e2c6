"""Cross-fleet deploy: walk registry routes and run `fleet deploy` on the
route's server over ssh (the port's copy of
``fleetflow_tpu/registry/deploy.py``).

Analog of the reference CLI's registry deploy (commands/registry.rs:250-417):
resolve the (fleet, stage) routes, ssh to each route's server, and execute a
remote `fleet deploy` from the fleet's project path. The ssh layer takes an
injectable runner so the whole flow is testable without a network.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass
from typing import Callable, Optional

from ..cloud.ssh import SshTarget, exec_with_timeout
from ..core.errors import CloudError
from ..obs import get_logger, kv
from .model import DeploymentRoute, Registry

__all__ = ["RouteResult", "deploy_routes", "sync_servers_payloads",
           "remote_deploy_cmd"]

log = get_logger("registry")

REMOTE_DEPLOY_TIMEOUT_S = 600.0   # matches the CP's deploy timeout


@dataclass
class RouteResult:
    route: DeploymentRoute
    ok: bool
    output: str = ""
    error: str = ""


def remote_deploy_cmd(path: str, stage: str, fleet_bin: str = "fleet") -> str:
    """The remote `fleet deploy` invocation — shared by registry routes and
    the CP's deploy.run SSH path so the two cannot drift."""
    return (f"cd {shlex.quote(path)} && "
            f"{fleet_bin} deploy {shlex.quote(stage)} -y")


def _target_for(reg: Registry, server_name: str) -> SshTarget:
    srv = reg.servers.get(server_name)
    if srv is None:
        raise CloudError(f"route references unknown server {server_name!r}")
    return SshTarget(host=srv.ssh_host or server_name, user=srv.ssh_user)


def deploy_routes(reg: Registry, *, fleet: Optional[str] = None,
                  stage: Optional[str] = None,
                  fleet_bin: str = "fleet",
                  runner=None, dry_run: bool = False,
                  on_line: Callable[[str], None] = lambda s: None,
                  ) -> list[RouteResult]:
    """Deploy every matching route (all routes by default; filter by fleet
    and/or stage). Serial, in registry order — same as the reference."""
    routes = [r for r in reg.routes
              if (fleet is None or r.fleet == fleet)
              and (stage is None or r.stage == stage)]
    results: list[RouteResult] = []
    for route in routes:
        entry = reg.fleets.get(route.fleet)
        if entry is None:
            results.append(RouteResult(route, False,
                                       error=f"unknown fleet {route.fleet!r}"))
            continue
        cmd = remote_deploy_cmd(entry.path, route.stage, fleet_bin)
        if dry_run:
            on_line(f"would run on {route.server}: {cmd}")
            results.append(RouteResult(route, True, output=cmd))
            continue
        on_line(f"{route.fleet}/{route.stage} -> {route.server}: {cmd}")
        try:
            target = _target_for(reg, route.server)
            out = exec_with_timeout(target, cmd,
                                    timeout=REMOTE_DEPLOY_TIMEOUT_S,
                                    runner=runner)
            log.info("route deployed %s", kv(fleet=route.fleet,
                                             stage=route.stage,
                                             server=route.server))
            results.append(RouteResult(route, True, output=out))
        except CloudError as e:
            log.error("route failed %s", kv(fleet=route.fleet,
                                            stage=route.stage,
                                            server=route.server, error=e))
            results.append(RouteResult(route, False, error=str(e)))
    return results


def sync_servers_payloads(reg: Registry) -> list[dict]:
    """`server.register` payloads for every server the registry declares —
    the `registry sync` verb pushes these to the CP so routes and the CP
    inventory agree."""
    out = []
    for name, srv in sorted(reg.servers.items()):
        out.append({
            "slug": name,
            "hostname": srv.ssh_host or name,
            "capacity": {"cpu": srv.capacity.cpu,
                         "memory": srv.capacity.memory,
                         "disk": srv.capacity.disk},
            "labels": {k: v for k, v in (
                ("tier", srv.labels.tier), ("region", srv.labels.region),
                ("class", srv.labels.clazz), ("arch", srv.labels.arch))
                if v},
        })
    return out
