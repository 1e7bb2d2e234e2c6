"""Fleet configuration model.

Python analog of the reference's config aggregate (crates/fleetflow-core/src/
model/*.rs): ``Flow`` is the root, holding services, stages, providers,
servers, registry, variables and tenant. Merge semantics follow the
reference's ``Service::merge`` (model/service.rs:381-433):

  - scalar/Option fields: last-wins (override if the other side is set)
  - list fields: non-empty-wins (override only if the other side is non-empty)
  - dict fields: merged key-by-key (other side's entries win)

This build adds first-class *placement* inputs absent from the reference's
file config but present in its control-plane model (model.rs:82-95,400-442):
per-service ``resources{}`` demand, per-server ``capacity{}`` / ``labels{}``,
and per-stage ``placement{}`` policy — these feed the solver's constraint
tensors (see lower/).

The port's copy of ``fleetflow_tpu/core/model.py``: the same classes, so a
flow parsed by either package serializes to the same dict.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "Flow", "Service", "ServiceType", "Stage", "Backend", "Port", "Protocol",
    "Volume", "Process", "ProcessState", "BuildConfig", "DeployConfig",
    "HealthCheck", "ReadinessCheck", "WaitConfig", "RestartPolicy",
    "CloudProviderDecl", "ServerResource", "TenantSpec", "ResourceSpec",
    "ServerLabels", "PlacementPolicy", "ResourceQuota", "SpreadConstraint",
    "FallbackPolicy", "PlacementStrategy", "RegistryRef", "SourceLoc",
    "RESOURCE_AXES",
]

# ResourceSpec.axes(): the R=3 columns of demand/capacity
RESOURCE_AXES: tuple[str, ...] = ("cpu", "memory", "disk")


@dataclass(frozen=True)
class SourceLoc:
    """1-based source position of a config declaration.

    Threaded from the KDL parser's node spans (core/kdl.py) through
    core/parser.py onto the model, so static analysis
    can point a diagnostic at file:line instead of at "somewhere in the
    flow". ``file`` is None when the text came from a concatenated
    multi-file load — the lint SourceMap resolves the line back to its
    file. Excluded from equality/serialization everywhere it is embedded:
    two configs declaring the same fleet are the same flow regardless of
    formatting.
    """
    line: int = 0
    col: int = 0
    file: Optional[str] = None

    def label(self) -> str:
        f = self.file or "<config>"
        return f"{f}:{self.line}:{self.col}" if self.line else f


# --------------------------------------------------------------------------
# Leaf types
# --------------------------------------------------------------------------

class Protocol(str, enum.Enum):
    TCP = "tcp"
    UDP = "udp"

    @classmethod
    def parse(cls, s: str) -> "Protocol":
        try:
            return cls(s.lower())
        except ValueError:
            raise ValueError(f"unknown protocol {s!r} (expected tcp|udp)") from None


@dataclass
class Port:
    """Port mapping (reference: model/port.rs:11)."""
    host: int
    container: int
    protocol: Protocol = Protocol.TCP
    host_ip: Optional[str] = None
    loc: Optional[SourceLoc] = field(default=None, compare=False, repr=False)

    def key(self) -> tuple:
        """Host-side conflict identity: two services binding the same key
        cannot share a node (solver anti-affinity input)."""
        return (self.host_ip or "0.0.0.0", self.host, self.protocol.value)


@dataclass
class Volume:
    """Volume mount (reference: model/volume.rs:15)."""
    host: str
    container: str
    read_only: bool = False
    loc: Optional[SourceLoc] = field(default=None, compare=False, repr=False)

    @property
    def is_named(self) -> bool:
        """Named (docker-managed) volume vs. host path bind."""
        return not (self.host.startswith("/") or self.host.startswith(".")
                    or self.host.startswith("~"))

    def conflict_key(self) -> Optional[str]:
        """Exclusive-writer identity: two services writing the same host path
        on the same node conflict (solver anti-affinity input). Read-only
        mounts never conflict."""
        return None if self.read_only else self.host


class RestartPolicy(str, enum.Enum):
    NO = "no"
    ALWAYS = "always"
    ON_FAILURE = "on-failure"
    UNLESS_STOPPED = "unless-stopped"

    @classmethod
    def parse(cls, s: str) -> "RestartPolicy":
        norm = s.lower().replace("_", "-")
        try:
            return cls(norm)
        except ValueError:
            raise ValueError(
                f"unknown restart policy {s!r} "
                "(expected no|always|on-failure|unless-stopped)") from None


@dataclass
class HealthCheck:
    """Container healthcheck (reference: model/service.rs:236, defaults :258-269)."""
    test: list[str] = field(default_factory=list)
    interval: float = 30.0
    timeout: float = 3.0
    retries: int = 3
    start_period: float = 10.0


@dataclass
class ReadinessCheck:
    """One-shot post-start readiness probe (reference: model/service.rs:282,
    defaults :300-308)."""
    type: str = "http"
    path: str = "/health"
    port: Optional[int] = None
    timeout: float = 30.0
    interval: float = 2.0


@dataclass
class WaitConfig:
    """Dependency-wait backoff (reference: model/service.rs:318,337-348)."""
    max_retries: int = 23
    initial_delay: float = 1.0
    max_delay: float = 30.0
    multiplier: float = 2.0

    def delay_for_attempt(self, attempt: int) -> float:
        """Exponential backoff, capped: 1s, 2s, 4s ... 30s, 30s, ..."""
        if attempt <= 0:
            return self.initial_delay
        return min(self.initial_delay * (self.multiplier ** attempt), self.max_delay)

    def total_budget(self) -> float:
        return sum(self.delay_for_attempt(i) for i in range(self.max_retries))


@dataclass
class BuildConfig:
    """Image build spec (reference: model/service.rs:204)."""
    context: str = "."
    dockerfile: Optional[str] = None
    args: dict[str, str] = field(default_factory=dict)
    target: Optional[str] = None
    no_cache: bool = False
    image_tag: Optional[str] = None


@dataclass
class DeployConfig:
    """Static-site deploy spec (reference: model/service.rs:129)."""
    type: str = "cloudflare-pages"
    output: Optional[str] = None
    command: Optional[str] = None
    project: Optional[str] = None


class ServiceType(str, enum.Enum):
    CONTAINER = "container"
    STATIC = "static"


@dataclass
class ResourceSpec:
    """Per-service resource demand, feeding the solver's (S, R) demand matrix.

    Units: cpu in fractional cores, memory/disk in MiB. The reference keeps
    resource quotas only in its control plane (model.rs:40,415); here demand
    is declared on the service so placement is first-class.
    """
    cpu: float = 0.1
    memory: float = 64.0
    disk: float = 0.0

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.cpu, self.memory, self.disk)

    @staticmethod
    def axes() -> tuple[str, ...]:
        return RESOURCE_AXES


# --------------------------------------------------------------------------
# Service
# --------------------------------------------------------------------------

def _merge_opt(a, b):
    """Option semantics: other (b) wins when set."""
    return b if b is not None else a


def _merge_vec(a: list, b: list) -> list:
    """Vec semantics: other wins when non-empty."""
    return list(b) if b else list(a)


def _merge_map(a: dict, b: dict) -> dict:
    """HashMap semantics: merged, other's entries win."""
    out = dict(a)
    out.update(b)
    return out


@dataclass
class Service:
    """Service spec (reference: model/service.rs:26-70)."""
    name: str
    service_type: ServiceType = ServiceType.CONTAINER
    image: Optional[str] = None
    version: Optional[str] = None
    command: Optional[str] = None
    restart: Optional[RestartPolicy] = None
    ports: list[Port] = field(default_factory=list)
    volumes: list[Volume] = field(default_factory=list)
    environment: dict[str, str] = field(default_factory=dict)
    depends_on: list[str] = field(default_factory=list)
    build: Optional[BuildConfig] = None
    deploy: Optional[DeployConfig] = None
    healthcheck: Optional[HealthCheck] = None
    readiness: Optional[ReadinessCheck] = None
    wait: Optional[WaitConfig] = None
    variables: dict[str, str] = field(default_factory=dict)
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    labels: dict[str, str] = field(default_factory=dict)
    # per-service push registry (reference service.rs:69; build-tag
    # precedence flag > service > stage > flow, build.rs:203-205)
    registry: Optional[str] = None
    # Placement hints (extensions; reference keeps these CP-side)
    colocate_with: list[str] = field(default_factory=list)
    anti_affinity: list[str] = field(default_factory=list)
    replicas: int = 1

    _resources_set: bool = field(default=False, repr=False, compare=False)
    _replicas_set: bool = field(default=False, repr=False, compare=False)

    # source locations (lint spans): the declaration itself, plus one per
    # depends_on TARGET so a bad reference is reported at the reference
    loc: Optional[SourceLoc] = field(default=None, repr=False, compare=False)
    dep_locs: dict[str, SourceLoc] = field(default_factory=dict,
                                           repr=False, compare=False)

    def image_name(self) -> str:
        """Resolve the full image reference (reference: converter.rs:35-46):
        explicit image wins; `image` may already carry a tag; `version`
        appends `:version`; bare service name + version as fallback."""
        base = self.image or self.name
        if ":" in base.rsplit("/", 1)[-1]:
            return base
        tag = self.version or "latest"
        return f"{base}:{tag}"

    def shallow_copy(self) -> "Service":
        """Fast shallow copy. Same sharing semantics as
        `dataclasses.replace(self)` — mutable fields are SHARED with the
        original, so callers that change one must rebind it — but ~5x
        cheaper (replace round-trips every field through __init__; at
        10k-service aggregation scale that is ~0.3 s per pipeline run)."""
        new = object.__new__(type(self))   # preserves subclasses
        new.__dict__.update(self.__dict__)
        return new

    def merge(self, other: "Service") -> "Service":
        """Merge `other` (override) onto self, reference semantics
        (model/service.rs:381-433)."""
        return Service(
            name=other.name or self.name,
            service_type=other.service_type
            if other.service_type != ServiceType.CONTAINER or
               self.service_type == ServiceType.CONTAINER
            else self.service_type,
            image=_merge_opt(self.image, other.image),
            version=_merge_opt(self.version, other.version),
            command=_merge_opt(self.command, other.command),
            restart=_merge_opt(self.restart, other.restart),
            ports=_merge_vec(self.ports, other.ports),
            volumes=_merge_vec(self.volumes, other.volumes),
            environment=_merge_map(self.environment, other.environment),
            depends_on=_merge_vec(self.depends_on, other.depends_on),
            build=_merge_opt(self.build, other.build),
            deploy=_merge_opt(self.deploy, other.deploy),
            healthcheck=_merge_opt(self.healthcheck, other.healthcheck),
            readiness=_merge_opt(self.readiness, other.readiness),
            wait=_merge_opt(self.wait, other.wait),
            registry=_merge_opt(self.registry, other.registry),
            variables=_merge_map(self.variables, other.variables),
            resources=other.resources if other._resources_set else self.resources,
            labels=_merge_map(self.labels, other.labels),
            colocate_with=_merge_vec(self.colocate_with, other.colocate_with),
            anti_affinity=_merge_vec(self.anti_affinity, other.anti_affinity),
            replicas=other.replicas if other._replicas_set else self.replicas,
            _resources_set=self._resources_set or other._resources_set,
            _replicas_set=self._replicas_set or other._replicas_set,
            loc=self.loc or other.loc,
            dep_locs={**self.dep_locs, **other.dep_locs},
        )


# --------------------------------------------------------------------------
# Placement policy (reference control-plane model.rs:40-95, surfaced in config)
# --------------------------------------------------------------------------

class PlacementStrategy(str, enum.Enum):
    """Reference: model.rs:68-75."""
    SPREAD_ACROSS_POOL = "spread_across_pool"
    PACK_INTO_DEDICATED = "pack_into_dedicated"
    FILL_LOWEST = "fill_lowest"

    @classmethod
    def parse(cls, s: str) -> "PlacementStrategy":
        norm = s.lower().replace("-", "_")
        try:
            return cls(norm)
        except ValueError:
            raise ValueError(f"unknown placement strategy {s!r}") from None


@dataclass
class ResourceQuota:
    """Reference: model.rs:40 (cpu_cores/memory_gb + max_services)."""
    cpu: Optional[float] = None
    memory: Optional[float] = None
    disk: Optional[float] = None
    max_services: Optional[int] = None


@dataclass
class SpreadConstraint:
    """PodTopologySpread analog (reference: model.rs:58)."""
    topology_key: str = "node"
    max_skew: int = 1


@dataclass
class FallbackPolicy:
    """Constraint relax order when placement is infeasible (reference: model.rs:49)."""
    relax_order: list[str] = field(default_factory=lambda: ["preferred_labels", "spread"])


@dataclass
class PlacementPolicy:
    """Reference: model.rs:82-95."""
    tier: Optional[str] = None
    preferred_labels: dict[str, str] = field(default_factory=dict)
    required_labels: dict[str, str] = field(default_factory=dict)
    resource_quota: Optional[ResourceQuota] = None
    fallback_policy: Optional[FallbackPolicy] = None
    spread_constraint: Optional[SpreadConstraint] = None
    strategy: PlacementStrategy = PlacementStrategy.SPREAD_ACROSS_POOL
    # the stage is aimed at the streaming admission path (deploy.submit,
    # cp/admission.py): services arrive/depart continuously as bucketed
    # micro-solves. Declaring it here gives static tooling the intent —
    # lint rule FF015 warns pre-deploy about services the delta path
    # must reject at runtime (ports/volumes/anti-affinity/coloc/deps,
    # replicas > 1; docs/guide/14-streaming-admission.md)
    streaming: bool = False


# --------------------------------------------------------------------------
# Stage
# --------------------------------------------------------------------------

class Backend(str, enum.Enum):
    """Execution backend (reference: model/stage.rs:15-23)."""
    DOCKER = "docker"
    QUADLET = "quadlet"
    COMPOSE = "compose"

    @classmethod
    def parse(cls, s: str) -> "Backend":
        try:
            return cls(s.lower())
        except ValueError:
            raise ValueError(f"unknown backend {s!r} (expected docker|quadlet|compose)") from None


@dataclass
class Stage:
    """Stage = service list + servers + vars + backend (reference: model/stage.rs:48-64)."""
    name: str
    services: list[str] = field(default_factory=list)
    service_overrides: dict[str, Service] = field(default_factory=dict)
    servers: list[str] = field(default_factory=list)
    variables: dict[str, str] = field(default_factory=dict)
    registry: Optional[str] = None
    backend: Backend = Backend.DOCKER
    placement: Optional[PlacementPolicy] = None

    # source locations (lint spans): the stage decl, plus one per service /
    # server REFERENCE so an unknown name is reported where it is written
    loc: Optional[SourceLoc] = field(default=None, repr=False, compare=False)
    service_locs: dict[str, SourceLoc] = field(default_factory=dict,
                                               repr=False, compare=False)
    server_locs: dict[str, SourceLoc] = field(default_factory=dict,
                                              repr=False, compare=False)

    def resolved_services(self, flow: "Flow") -> list[Service]:
        """Base service defs merged with per-stage overrides, in declared
        order.  Services with no override and no service-scoped variables
        are returned AS the flow's own objects (read-only contract: no
        consumer mutates resolved services; anything that needs to rebind
        fields copies first, as registry aggregation does) — copying all
        10k of them cost ~40 ms per fleet-scale lowering."""
        out = []
        overrides = self.service_overrides
        for name in self.services:
            base = flow.services.get(name)
            if base is None:
                raise KeyError(f"stage {self.name!r} references unknown service {name!r}")
            override = overrides.get(name)
            if override is None and not base.variables:
                out.append(base)
                continue
            svc = base.merge(override) if override else base.shallow_copy()
            if svc.variables:
                # service-scoped variables{} become container env; stage-level
                # variables{} are template context only (loader pre-pass).
                # svc is fresh either way above, so rebinding is safe.
                merged_env = dict(svc.environment)
                merged_env.update({k: str(v) for k, v in svc.variables.items()})
                svc.environment = merged_env
            out.append(svc)
        return out


# --------------------------------------------------------------------------
# Cloud / servers / tenant / registry
# --------------------------------------------------------------------------

@dataclass
class CloudProviderDecl:
    """Provider declaration (reference: model/cloud.rs:10)."""
    name: str
    zone: Optional[str] = None
    options: dict[str, Any] = field(default_factory=dict)


@dataclass
class ServerLabels:
    """Reference: model.rs:400."""
    tier: Optional[str] = None
    region: Optional[str] = None
    clazz: Optional[str] = None
    arch: Optional[str] = None
    extra: dict[str, str] = field(default_factory=dict)

    def as_dict(self) -> dict[str, str]:
        out = dict(self.extra)
        for k in ("tier", "region", "arch"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.clazz is not None:
            out["class"] = self.clazz
        return out


@dataclass
class ServerResource:
    """Server declaration (reference: model/cloud.rs:23 + CP model.rs:495-541)."""
    name: str
    provider: Optional[str] = None
    plan: Optional[str] = None
    disk_size: Optional[int] = None
    os: Optional[str] = None
    # disk source archive (name or id; reference provider.rs:43-46,106-108
    # resolves names to ids) — wins over `os` at create time
    archive: Optional[str] = None
    ssh_keys: list[str] = field(default_factory=list)
    ssh_host: Optional[str] = None
    ssh_user: Optional[str] = None
    tags: list[str] = field(default_factory=list)
    startup_script: Optional[str] = None
    dns_hostname: Optional[str] = None
    dns_aliases: list[str] = field(default_factory=list)
    capacity: ResourceSpec = field(default_factory=lambda: ResourceSpec(cpu=2.0, memory=4096.0, disk=40960.0))
    labels: ServerLabels = field(default_factory=ServerLabels)
    loc: Optional[SourceLoc] = field(default=None, repr=False, compare=False)


@dataclass
class TenantSpec:
    """Reference: model/tenant.rs:23."""
    name: str
    display_name: Optional[str] = None
    options: dict[str, Any] = field(default_factory=dict)


@dataclass
class RegistryRef:
    """Image registry declaration on flow/stage."""
    url: str
    username: Optional[str] = None


# --------------------------------------------------------------------------
# Process (runtime record)
# --------------------------------------------------------------------------

class ProcessState(str, enum.Enum):
    """7-state container lifecycle (reference: model/process.rs:43)."""
    CREATED = "created"
    RUNNING = "running"
    PAUSED = "paused"
    RESTARTING = "restarting"
    EXITED = "exited"
    DEAD = "dead"
    UNKNOWN = "unknown"


@dataclass
class Process:
    """Runtime process record (reference: model/process.rs:11)."""
    id: str
    service: str
    container_id: Optional[str] = None
    pid: Optional[int] = None
    state: ProcessState = ProcessState.UNKNOWN
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    ports: list[Port] = field(default_factory=list)
    health: Optional[str] = None
    node: Optional[str] = None


# --------------------------------------------------------------------------
# Flow (root aggregate)
# --------------------------------------------------------------------------

@dataclass
class Flow:
    """Root aggregate (reference: model/flow.rs:15-41)."""
    name: str = "unnamed"
    services: dict[str, Service] = field(default_factory=dict)
    stages: dict[str, Stage] = field(default_factory=dict)
    providers: dict[str, CloudProviderDecl] = field(default_factory=dict)
    servers: dict[str, ServerResource] = field(default_factory=dict)
    registry: Optional[RegistryRef] = None
    variables: dict[str, str] = field(default_factory=dict)
    tenant: Optional[TenantSpec] = None

    # where each KDL-declared variable was defined (lint spans; variables
    # merged from .env / process env at load time have no source line)
    variable_locs: dict[str, SourceLoc] = field(default_factory=dict,
                                                repr=False, compare=False)
    # (name, earlier loc, later loc) per top-level service redefinition —
    # merging is a FEATURE across files (override files), but a same-file
    # redefinition is usually a copy-paste accident; lint rule FF005 reads
    # this to tell the two apart via the source map
    redefinitions: list[tuple] = field(default_factory=list,
                                       repr=False, compare=False)

    def stage(self, name: str) -> Stage:
        try:
            return self.stages[name]
        except KeyError:
            raise KeyError(
                f"unknown stage {name!r}; defined stages: {sorted(self.stages)}"
            ) from None

    def merge_service(self, svc: Service) -> None:
        """Service redefinition merges onto the existing def (reference:
        parser/mod.rs service-merge-on-redefinition)."""
        if svc.name in self.services:
            old = self.services[svc.name]
            self.redefinitions.append((svc.name, old.loc, svc.loc))
            self.services[svc.name] = old.merge(svc)
        else:
            self.services[svc.name] = svc
