"""Service -> ContainerConfig conversion (the port's copy of
``fleetflow_tpu/runtime/converter.py``).

Analog of the reference's Bollard converter (fleetflow-container
converter.rs:27-190): image resolution, env assembly, port bindings, volume
binds with relative-path absolutization, restart-policy mapping, fleetflow +
compose-compat labels, per-stage network with service-name alias, and
healthcheck (seconds -> nanoseconds at the container-API boundary).

Naming contracts (converter.rs:12,185):
  container  {project}-{stage}-{service}
  network    {project}-{stage}
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from ..core.model import Flow, RestartPolicy, Service, Stage

__all__ = ["ContainerConfig", "container_name", "network_name",
           "service_to_container_config", "stage_services"]

NS_PER_S = 1_000_000_000


def container_name(project: str, stage: str, service: str) -> str:
    return f"{project}-{stage}-{service}"


def network_name(project: str, stage: str) -> str:
    return f"{project}-{stage}"


@dataclass
class ContainerConfig:
    """Runtime-neutral container create spec (the dict Bollard's
    ContainerCreateBody would carry)."""
    name: str
    image: str
    env: list[str] = field(default_factory=list)            # KEY=VALUE
    command: Optional[list[str]] = None
    exposed_ports: list[str] = field(default_factory=list)  # "8080/tcp"
    port_bindings: dict[str, list[dict]] = field(default_factory=dict)
    binds: list[str] = field(default_factory=list)          # host:cont[:ro]
    restart_policy: Optional[str] = None
    labels: dict[str, str] = field(default_factory=dict)
    network: Optional[str] = None
    aliases: list[str] = field(default_factory=list)
    healthcheck: Optional[dict] = None                      # interval etc in ns

    def to_dict(self) -> dict:
        d = {"name": self.name, "image": self.image}
        for k in ("env", "command", "exposed_ports", "port_bindings", "binds",
                  "restart_policy", "labels", "network", "aliases",
                  "healthcheck"):
            v = getattr(self, k)
            if v:
                d[k] = v
        return d


def _absolutize(path: str, base: str) -> str:
    """Relative host paths are resolved against the project root
    (converter.rs volume-bind absolutization)."""
    if path.startswith(("/", "~")):
        return os.path.expanduser(path)
    if path.startswith("."):
        return os.path.normpath(os.path.join(base, path))
    return path  # named volume: leave as-is


def service_to_container_config(
        svc: Service, project: str, stage: str, *,
        project_root: str = ".",
        network: Optional[str] = None) -> ContainerConfig:
    """Lower one Service to a ContainerConfig (converter.rs:27-190)."""
    cfg = ContainerConfig(
        name=container_name(project, stage, svc.name),
        image=svc.image_name(),
    )

    cfg.env = [f"{k}={v}" for k, v in sorted(svc.environment.items())]
    if svc.command:
        cfg.command = svc.command.split()

    for p in svc.ports:
        key = f"{p.container}/{p.protocol.value}"
        cfg.exposed_ports.append(key)
        binding = {"HostPort": str(p.host)}
        if p.host_ip:
            binding["HostIp"] = p.host_ip
        cfg.port_bindings.setdefault(key, []).append(binding)

    for v in svc.volumes:
        host = _absolutize(v.host, project_root)
        bind = f"{host}:{v.container}"
        if v.read_only:
            bind += ":ro"
        cfg.binds.append(bind)

    if svc.restart is not None:
        cfg.restart_policy = {
            RestartPolicy.NO: "no",
            RestartPolicy.ALWAYS: "always",
            RestartPolicy.ON_FAILURE: "on-failure",
            RestartPolicy.UNLESS_STOPPED: "unless-stopped",
        }[svc.restart]

    # fleetflow labels + compose-compat labels (converter.rs:128-139: the
    # compose pair makes OrbStack/Desktop group containers per stage)
    cfg.labels = {
        "fleetflow.project": project,
        "fleetflow.stage": stage,
        "fleetflow.service": svc.name,
        "com.docker.compose.project": f"{project}-{stage}",
        "com.docker.compose.service": svc.name,
        **svc.labels,
    }

    cfg.network = network or network_name(project, stage)
    cfg.aliases = [svc.name]  # service-name DNS alias on the stage network

    if svc.healthcheck and svc.healthcheck.test:
        hc = svc.healthcheck
        test = hc.test
        if test and test[0] not in ("CMD", "CMD-SHELL", "NONE"):
            test = ["CMD-SHELL", " ".join(test)]
        cfg.healthcheck = {
            "test": test,
            "interval": int(hc.interval * NS_PER_S),
            "timeout": int(hc.timeout * NS_PER_S),
            "retries": hc.retries,
            "start_period": int(hc.start_period * NS_PER_S),
        }

    return cfg


def stage_services(flow: Flow, stage: Stage,
                   target: Optional[list[str]] = None) -> list[Service]:
    """Resolved services of a stage, optionally filtered to `target` names
    (converter.rs get_stage_services:193)."""
    services = stage.resolved_services(flow)
    if target:
        unknown = set(target) - {s.name for s in services}
        if unknown:
            raise KeyError(f"unknown services {sorted(unknown)} "
                           f"in stage {stage.name!r}")
        services = [s for s in services if s.name in target]
    return services
