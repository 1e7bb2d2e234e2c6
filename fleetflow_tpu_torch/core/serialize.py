"""Flow <-> plain-dict serialization.

The reference ships `DeployRequest{flow,...}` over QUIC as serde JSON
(fleetflow-container engine.rs:17-25; round-trip tests engine.rs:547-601).
Here the same contract is explicit dict codecs so a Flow can ride the
control-plane wire protocol, be persisted in the CP store, and round-trip
through `DeployRequest` byte-identically.

Only fields that differ from the dataclass default are emitted, which keeps
wire payloads small for 10k-service fleets and makes round-trip equality
exact (defaults never materialize spuriously).

The port's copy of ``fleetflow_tpu/core/serialize.py``.
"""

from __future__ import annotations

from typing import Any, Optional

from .model import (Backend, BuildConfig, CloudProviderDecl, DeployConfig,
                    FallbackPolicy, Flow, HealthCheck, PlacementPolicy,
                    PlacementStrategy, Port, Protocol, ReadinessCheck,
                    RegistryRef, ResourceQuota, ResourceSpec, RestartPolicy,
                    ServerLabels, ServerResource, Service, ServiceType,
                    SpreadConstraint, Stage, TenantSpec, Volume, WaitConfig)

__all__ = ["flow_to_dict", "flow_from_dict", "service_to_dict",
           "service_from_dict", "stage_to_dict", "stage_from_dict"]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _put(d: dict, key: str, value, default) -> None:
    if value != default:
        d[key] = value


def _port_to_dict(p: Port) -> dict:
    d: dict[str, Any] = {"host": p.host, "container": p.container}
    _put(d, "protocol", p.protocol.value, Protocol.TCP.value)
    _put(d, "host_ip", p.host_ip, None)
    return d


def _port_from_dict(d: dict) -> Port:
    return Port(host=d["host"], container=d["container"],
                protocol=Protocol(d.get("protocol", "tcp")),
                host_ip=d.get("host_ip"))


def _volume_to_dict(v: Volume) -> dict:
    d: dict[str, Any] = {"host": v.host, "container": v.container}
    _put(d, "read_only", v.read_only, False)
    return d


def _volume_from_dict(d: dict) -> Volume:
    return Volume(host=d["host"], container=d["container"],
                  read_only=d.get("read_only", False))


def _resources_to_dict(r: ResourceSpec) -> dict:
    return {"cpu": r.cpu, "memory": r.memory, "disk": r.disk}


def _resources_from_dict(d: dict) -> ResourceSpec:
    return ResourceSpec(cpu=d.get("cpu", 0.1), memory=d.get("memory", 64.0),
                        disk=d.get("disk", 0.0))


def _health_to_dict(h: HealthCheck) -> dict:
    d: dict[str, Any] = {}
    _put(d, "test", h.test, [])
    _put(d, "interval", h.interval, 30.0)
    _put(d, "timeout", h.timeout, 3.0)
    _put(d, "retries", h.retries, 3)
    _put(d, "start_period", h.start_period, 10.0)
    return d


def _health_from_dict(d: dict) -> HealthCheck:
    return HealthCheck(test=d.get("test", []), interval=d.get("interval", 30.0),
                       timeout=d.get("timeout", 3.0), retries=d.get("retries", 3),
                       start_period=d.get("start_period", 10.0))


def _readiness_to_dict(r: ReadinessCheck) -> dict:
    d: dict[str, Any] = {}
    _put(d, "type", r.type, "http")
    _put(d, "path", r.path, "/health")
    _put(d, "port", r.port, None)
    _put(d, "timeout", r.timeout, 30.0)
    _put(d, "interval", r.interval, 2.0)
    return d


def _readiness_from_dict(d: dict) -> ReadinessCheck:
    return ReadinessCheck(type=d.get("type", "http"), path=d.get("path", "/health"),
                          port=d.get("port"), timeout=d.get("timeout", 30.0),
                          interval=d.get("interval", 2.0))


def _wait_to_dict(w: WaitConfig) -> dict:
    d: dict[str, Any] = {}
    _put(d, "max_retries", w.max_retries, 23)
    _put(d, "initial_delay", w.initial_delay, 1.0)
    _put(d, "max_delay", w.max_delay, 30.0)
    _put(d, "multiplier", w.multiplier, 2.0)
    return d


def _wait_from_dict(d: dict) -> WaitConfig:
    return WaitConfig(max_retries=d.get("max_retries", 23),
                      initial_delay=d.get("initial_delay", 1.0),
                      max_delay=d.get("max_delay", 30.0),
                      multiplier=d.get("multiplier", 2.0))


def _build_to_dict(b: BuildConfig) -> dict:
    d: dict[str, Any] = {}
    _put(d, "context", b.context, ".")
    _put(d, "dockerfile", b.dockerfile, None)
    _put(d, "args", b.args, {})
    _put(d, "target", b.target, None)
    _put(d, "no_cache", b.no_cache, False)
    _put(d, "image_tag", b.image_tag, None)
    return d


def _build_from_dict(d: dict) -> BuildConfig:
    return BuildConfig(context=d.get("context", "."), dockerfile=d.get("dockerfile"),
                       args=d.get("args", {}), target=d.get("target"),
                       no_cache=d.get("no_cache", False),
                       image_tag=d.get("image_tag"))


def _deploy_to_dict(dc: DeployConfig) -> dict:
    d: dict[str, Any] = {}
    _put(d, "type", dc.type, "cloudflare-pages")
    _put(d, "output", dc.output, None)
    _put(d, "command", dc.command, None)
    _put(d, "project", dc.project, None)
    return d


def _deploy_from_dict(d: dict) -> DeployConfig:
    return DeployConfig(type=d.get("type", "cloudflare-pages"),
                        output=d.get("output"), command=d.get("command"),
                        project=d.get("project"))


# --------------------------------------------------------------------------
# Service
# --------------------------------------------------------------------------

def service_to_dict(s: Service) -> dict:
    d: dict[str, Any] = {"name": s.name}
    _put(d, "type", s.service_type.value, ServiceType.CONTAINER.value)
    _put(d, "image", s.image, None)
    _put(d, "version", s.version, None)
    _put(d, "command", s.command, None)
    if s.restart is not None:
        d["restart"] = s.restart.value
    if s.ports:
        d["ports"] = [_port_to_dict(p) for p in s.ports]
    if s.volumes:
        d["volumes"] = [_volume_to_dict(v) for v in s.volumes]
    _put(d, "environment", s.environment, {})
    _put(d, "depends_on", s.depends_on, [])
    if s.build is not None:
        d["build"] = _build_to_dict(s.build)
    if s.deploy is not None:
        d["deploy"] = _deploy_to_dict(s.deploy)
    if s.healthcheck is not None:
        d["healthcheck"] = _health_to_dict(s.healthcheck)
    if s.readiness is not None:
        d["readiness"] = _readiness_to_dict(s.readiness)
    if s.wait is not None:
        d["wait"] = _wait_to_dict(s.wait)
    _put(d, "variables", s.variables, {})
    if s._resources_set or s.resources != ResourceSpec():
        # same contract as replicas below: explicit declaration OR a
        # non-default value set programmatically must survive the wire
        d["resources"] = _resources_to_dict(s.resources)
    _put(d, "labels", s.labels, {})
    _put(d, "registry", s.registry, None)
    _put(d, "colocate_with", s.colocate_with, [])
    _put(d, "anti_affinity", s.anti_affinity, [])
    if s._replicas_set or s.replicas != 1:
        # _replicas_set tracks an explicit config declaration, but a
        # programmatically built Flow (tests, chaos harness, API users)
        # sets the field directly — a replica count must never be lost
        # over the deploy wire (found by the chaos harness: replica rows
        # vanished from agent-side lowering after the round-trip)
        d["replicas"] = s.replicas
    return d


def service_from_dict(d: dict) -> Service:
    return Service(
        name=d["name"],
        service_type=ServiceType(d.get("type", "container")),
        image=d.get("image"),
        version=d.get("version"),
        command=d.get("command"),
        restart=RestartPolicy(d["restart"]) if "restart" in d else None,
        ports=[_port_from_dict(p) for p in d.get("ports", [])],
        volumes=[_volume_from_dict(v) for v in d.get("volumes", [])],
        environment=d.get("environment", {}),
        depends_on=d.get("depends_on", []),
        build=_build_from_dict(d["build"]) if "build" in d else None,
        deploy=_deploy_from_dict(d["deploy"]) if "deploy" in d else None,
        healthcheck=_health_from_dict(d["healthcheck"]) if "healthcheck" in d else None,
        readiness=_readiness_from_dict(d["readiness"]) if "readiness" in d else None,
        wait=_wait_from_dict(d["wait"]) if "wait" in d else None,
        variables=d.get("variables", {}),
        resources=_resources_from_dict(d["resources"]) if "resources" in d else ResourceSpec(),
        labels=d.get("labels", {}),
        registry=d.get("registry"),
        colocate_with=d.get("colocate_with", []),
        anti_affinity=d.get("anti_affinity", []),
        replicas=d.get("replicas", 1),
        _resources_set="resources" in d,
        _replicas_set="replicas" in d,
    )


# --------------------------------------------------------------------------
# Placement policy
# --------------------------------------------------------------------------

def _policy_to_dict(p: PlacementPolicy) -> dict:
    d: dict[str, Any] = {}
    _put(d, "tier", p.tier, None)
    _put(d, "preferred_labels", p.preferred_labels, {})
    _put(d, "required_labels", p.required_labels, {})
    if p.resource_quota is not None:
        q: dict[str, Any] = {}
        _put(q, "cpu", p.resource_quota.cpu, None)
        _put(q, "memory", p.resource_quota.memory, None)
        _put(q, "disk", p.resource_quota.disk, None)
        _put(q, "max_services", p.resource_quota.max_services, None)
        d["resource_quota"] = q
    if p.fallback_policy is not None:
        d["fallback_policy"] = {"relax_order": p.fallback_policy.relax_order}
    if p.spread_constraint is not None:
        d["spread_constraint"] = {"topology_key": p.spread_constraint.topology_key,
                                  "max_skew": p.spread_constraint.max_skew}
    _put(d, "strategy", p.strategy.value, PlacementStrategy.SPREAD_ACROSS_POOL.value)
    _put(d, "streaming", p.streaming, False)
    return d


def _policy_from_dict(d: dict) -> PlacementPolicy:
    quota = None
    if "resource_quota" in d:
        q = d["resource_quota"]
        quota = ResourceQuota(cpu=q.get("cpu"), memory=q.get("memory"),
                              disk=q.get("disk"),
                              max_services=q.get("max_services"))
    fallback = None
    if "fallback_policy" in d:
        fallback = FallbackPolicy(relax_order=d["fallback_policy"].get(
            "relax_order", ["preferred_labels", "spread"]))
    spread = None
    if "spread_constraint" in d:
        sc = d["spread_constraint"]
        spread = SpreadConstraint(topology_key=sc.get("topology_key", "node"),
                                  max_skew=sc.get("max_skew", 1))
    return PlacementPolicy(
        tier=d.get("tier"),
        preferred_labels=d.get("preferred_labels", {}),
        required_labels=d.get("required_labels", {}),
        resource_quota=quota, fallback_policy=fallback,
        spread_constraint=spread,
        strategy=PlacementStrategy(d.get("strategy", "spread_across_pool")),
        streaming=d.get("streaming", False),
    )


# --------------------------------------------------------------------------
# Stage
# --------------------------------------------------------------------------

def stage_to_dict(st: Stage) -> dict:
    d: dict[str, Any] = {"name": st.name}
    _put(d, "services", st.services, [])
    if st.service_overrides:
        d["service_overrides"] = {k: service_to_dict(v)
                                  for k, v in st.service_overrides.items()}
    _put(d, "servers", st.servers, [])
    _put(d, "variables", st.variables, {})
    _put(d, "registry", st.registry, None)
    _put(d, "backend", st.backend.value, Backend.DOCKER.value)
    if st.placement is not None:
        d["placement"] = _policy_to_dict(st.placement)
    return d


def stage_from_dict(d: dict) -> Stage:
    return Stage(
        name=d["name"],
        services=d.get("services", []),
        service_overrides={k: service_from_dict(v)
                           for k, v in d.get("service_overrides", {}).items()},
        servers=d.get("servers", []),
        variables=d.get("variables", {}),
        registry=d.get("registry"),
        backend=Backend(d.get("backend", "docker")),
        placement=_policy_from_dict(d["placement"]) if "placement" in d else None,
    )


# --------------------------------------------------------------------------
# Servers / providers / tenant
# --------------------------------------------------------------------------

def _labels_to_dict(lb: ServerLabels) -> dict:
    d: dict[str, Any] = {}
    _put(d, "tier", lb.tier, None)
    _put(d, "region", lb.region, None)
    _put(d, "class", lb.clazz, None)
    _put(d, "arch", lb.arch, None)
    _put(d, "extra", lb.extra, {})
    return d


def _labels_from_dict(d: dict) -> ServerLabels:
    return ServerLabels(tier=d.get("tier"), region=d.get("region"),
                        clazz=d.get("class"), arch=d.get("arch"),
                        extra=d.get("extra", {}))


_DEFAULT_CAPACITY = ResourceSpec(cpu=2.0, memory=4096.0, disk=40960.0)


def _server_to_dict(sv: ServerResource) -> dict:
    d: dict[str, Any] = {"name": sv.name}
    _put(d, "provider", sv.provider, None)
    _put(d, "plan", sv.plan, None)
    _put(d, "disk_size", sv.disk_size, None)
    _put(d, "os", sv.os, None)
    _put(d, "archive", sv.archive, None)
    _put(d, "ssh_keys", sv.ssh_keys, [])
    _put(d, "ssh_host", sv.ssh_host, None)
    _put(d, "ssh_user", sv.ssh_user, None)
    _put(d, "tags", sv.tags, [])
    _put(d, "startup_script", sv.startup_script, None)
    _put(d, "dns_hostname", sv.dns_hostname, None)
    _put(d, "dns_aliases", sv.dns_aliases, [])
    if sv.capacity != _DEFAULT_CAPACITY:
        d["capacity"] = _resources_to_dict(sv.capacity)
    lbl = _labels_to_dict(sv.labels)
    if lbl:
        d["labels"] = lbl
    return d


def _server_from_dict(d: dict) -> ServerResource:
    return ServerResource(
        name=d["name"], provider=d.get("provider"), plan=d.get("plan"),
        disk_size=d.get("disk_size"), os=d.get("os"),
        archive=d.get("archive"),
        ssh_keys=d.get("ssh_keys", []), ssh_host=d.get("ssh_host"),
        ssh_user=d.get("ssh_user"), tags=d.get("tags", []),
        startup_script=d.get("startup_script"),
        dns_hostname=d.get("dns_hostname"), dns_aliases=d.get("dns_aliases", []),
        capacity=(_resources_from_dict(d["capacity"]) if "capacity" in d
                  else ResourceSpec(cpu=2.0, memory=4096.0, disk=40960.0)),
        labels=_labels_from_dict(d.get("labels", {})),
    )


# --------------------------------------------------------------------------
# Flow
# --------------------------------------------------------------------------

def flow_to_dict(f: Flow) -> dict:
    d: dict[str, Any] = {"name": f.name}
    if f.services:
        d["services"] = {k: service_to_dict(v) for k, v in f.services.items()}
    if f.stages:
        d["stages"] = {k: stage_to_dict(v) for k, v in f.stages.items()}
    if f.providers:
        d["providers"] = {k: {"name": v.name, "zone": v.zone, "options": v.options}
                          for k, v in f.providers.items()}
    if f.servers:
        d["servers"] = {k: _server_to_dict(v) for k, v in f.servers.items()}
    if f.registry is not None:
        d["registry"] = {"url": f.registry.url, "username": f.registry.username}
    _put(d, "variables", f.variables, {})
    if f.tenant is not None:
        d["tenant"] = {"name": f.tenant.name,
                       "display_name": f.tenant.display_name,
                       "options": f.tenant.options}
    return d


def flow_from_dict(d: dict) -> Flow:
    registry: Optional[RegistryRef] = None
    if "registry" in d:
        registry = RegistryRef(url=d["registry"]["url"],
                               username=d["registry"].get("username"))
    tenant: Optional[TenantSpec] = None
    if "tenant" in d:
        tenant = TenantSpec(name=d["tenant"]["name"],
                            display_name=d["tenant"].get("display_name"),
                            options=d["tenant"].get("options", {}))
    return Flow(
        name=d.get("name", "unnamed"),
        services={k: service_from_dict(v)
                  for k, v in d.get("services", {}).items()},
        stages={k: stage_from_dict(v) for k, v in d.get("stages", {}).items()},
        providers={k: CloudProviderDecl(name=v["name"], zone=v.get("zone"),
                                        options=v.get("options", {}))
                   for k, v in d.get("providers", {}).items()},
        servers={k: _server_from_dict(v) for k, v in d.get("servers", {}).items()},
        registry=registry,
        variables=d.get("variables", {}),
        tenant=tenant,
    )
