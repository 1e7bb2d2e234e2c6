"""Control-plane records (the port's copy of ``fleetflow_tpu/cp/models.py``).

Analog of fleetflow-controlplane model.rs (SURVEY.md §2.4): tenants, users,
projects, stages, services, servers (labels/capacity/allocation/scheduling
state), worker pools, deployments, alerts, observed containers, volumes +
snapshots, build jobs, cost entries, DNS records. Placement policy types are
shared with the config layer (core.model), since this build surfaces them in
stage config too.

Records serialize with dataclasses.asdict-style plain dicts via `to_dict`/
`from_dict` so they ride the wire protocol and the store's JSON snapshots.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import asdict, dataclass, field, fields
from typing import Optional

from ..core.model import PlacementPolicy, ResourceSpec  # noqa: F401  (re-export)

__all__ = [
    "now_ts", "new_id", "Record", "Tenant", "TenantRole", "TenantUser",
    "Project", "StageRecord", "ServiceRecord", "SchedulingState",
    "DesiredState", "ServerLabelsRec", "ServerCapacity", "ServerAllocated",
    "Server", "WorkerPool", "DeploymentStatus", "Deployment", "AlertKind",
    "Alert", "ObservedContainer", "VolumeRecord", "VolumeSnapshot",
    "BuildStatus", "BuildJob", "CostEntry", "DnsRecord", "ParkedWork",
    "PlacementRecord",
]


def now_ts() -> float:
    return time.time()


def new_id(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


@dataclass
class Record:
    """Base: id + timestamps; subclasses add their fields. Timestamps
    are assigned by the Store on create/update (from its injectable
    clock — the chaos harness runs stores on virtual time); a caller
    that pre-sets created_at explicitly keeps it."""
    id: str = ""
    created_at: float = 0.0
    updated_at: float = 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        for k, v in list(d.items()):
            if isinstance(v, enum.Enum):
                d[k] = v.value
        return d

    @classmethod
    def from_dict(cls, d: dict):
        known = {f.name: f for f in fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in known:
                continue
            # enum-typed fields round-trip from their value strings
            kwargs[k] = v
        obj = cls(**kwargs)
        obj._coerce()
        return obj

    def _coerce(self) -> None:
        pass


# --------------------------------------------------------------------------
# Tenancy (model.rs:18,111,143)
# --------------------------------------------------------------------------

@dataclass
class Tenant(Record):
    name: str = ""
    display_name: str = ""
    secrets: dict[str, str] = field(default_factory=dict)  # name -> ciphertext

    def public_dict(self) -> dict:
        """API/listing payload: to_dict minus the secrets map. Without a
        master key the stored values are plaintext, and even ciphertext
        must not be reachable under a read grant (the same invariant that
        keeps secret.get write-gated). Persistence keeps to_dict."""
        d = self.to_dict()
        d.pop("secrets", None)
        return d


class TenantRole(str, enum.Enum):
    OWNER = "owner"
    ADMIN = "admin"
    MEMBER = "member"
    VIEWER = "viewer"


@dataclass
class TenantUser(Record):
    tenant: str = ""
    email: str = ""
    role: str = TenantRole.MEMBER.value

    def can_write(self) -> bool:
        return self.role in (TenantRole.OWNER.value, TenantRole.ADMIN.value,
                             TenantRole.MEMBER.value)

    def can_admin(self) -> bool:
        return self.role in (TenantRole.OWNER.value, TenantRole.ADMIN.value)


# --------------------------------------------------------------------------
# Project / stage / service (model.rs:215,240,331)
# --------------------------------------------------------------------------

@dataclass
class Project(Record):
    tenant: str = ""
    name: str = ""
    description: str = ""


@dataclass
class StageRecord(Record):
    project: str = ""               # project id
    name: str = ""
    backend: str = "docker"
    servers: list[str] = field(default_factory=list)
    placement: Optional[dict] = None   # serialized PlacementPolicy
    adopted: bool = False              # stage adoption flow (db.rs:480)


@dataclass
class ServiceRecord(Record):
    stage: str = ""                 # stage id
    name: str = ""
    image: str = ""
    status: str = "unknown"
    desired_replicas: int = 1


# --------------------------------------------------------------------------
# Servers / pools (model.rs:395-563)
# --------------------------------------------------------------------------

class SchedulingState(str, enum.Enum):
    """model.rs:435-442."""
    SCHEDULABLE = "schedulable"
    CORDONED = "cordoned"
    DRAINING = "draining"


class DesiredState(str, enum.Enum):
    """model.rs:446."""
    ACTIVE = "active"
    STOPPED = "stopped"
    TERMINATED = "terminated"


@dataclass
class ServerLabelsRec:
    """model.rs:400."""
    tier: Optional[str] = None
    region: Optional[str] = None
    clazz: Optional[str] = None
    arch: Optional[str] = None
    extra: dict[str, str] = field(default_factory=dict)


@dataclass
class ServerCapacity:
    """model.rs:415 — cpu cores, memory MiB, disk MiB."""
    cpu: float = 2.0
    memory: float = 4096.0
    disk: float = 40960.0


@dataclass
class ServerAllocated:
    """Two-phase commit/release of reserved resources (model.rs:421-427):
    `reserved` holds in-flight placements until the deploy confirms, then
    moves into `committed`. The reservation journal in placement.py is the
    authoritative racing-re-solve guard (SURVEY.md hard part (c))."""
    cpu: float = 0.0
    memory: float = 0.0
    disk: float = 0.0
    reserved_cpu: float = 0.0
    reserved_memory: float = 0.0
    reserved_disk: float = 0.0


@dataclass
class Server(Record):
    tenant: str = ""
    slug: str = ""
    hostname: str = ""
    provider: Optional[str] = None
    status: str = "unknown"         # online|offline|unknown
    agent_version: str = ""
    last_heartbeat: float = 0.0
    labels: ServerLabelsRec = field(default_factory=ServerLabelsRec)
    capacity: ServerCapacity = field(default_factory=ServerCapacity)
    allocated: ServerAllocated = field(default_factory=ServerAllocated)
    scheduling_state: str = SchedulingState.SCHEDULABLE.value
    desired_state: str = DesiredState.ACTIVE.value
    pool: Optional[str] = None

    def to_dict(self) -> dict:
        d = super().to_dict()
        # wire parity with the reference model.rs ("class", a Rust keyword
        # there and a Python keyword here — stored as clazz on both sides)
        lbl = d.get("labels") or {}
        if "clazz" in lbl:
            lbl["class"] = lbl.pop("clazz")
        return d

    def _coerce(self) -> None:
        if isinstance(self.labels, dict):
            if "class" in self.labels:
                self.labels["clazz"] = self.labels.pop("class")
            self.labels = ServerLabelsRec(**self.labels)
        if isinstance(self.capacity, dict):
            self.capacity = ServerCapacity(**self.capacity)
        if isinstance(self.allocated, dict):
            self.allocated = ServerAllocated(**self.allocated)

    @property
    def schedulable(self) -> bool:
        return (self.scheduling_state == SchedulingState.SCHEDULABLE.value
                and self.status == "online")


@dataclass
class WorkerPool(Record):
    """model.rs:552-563."""
    tenant: str = ""
    name: str = ""
    required_labels: dict[str, str] = field(default_factory=dict)
    preferred_labels: dict[str, str] = field(default_factory=dict)
    min_servers: int = 0
    max_servers: int = 0


@dataclass
class ParkedWork(Record):
    """Self-healing backlog entry (cp/reconverge.py): a stage the
    reconverger could not converge yet. `parked=True` means blocked on
    capacity (infeasible re-solve, exhausted retries) and retried on the
    next node-online verdict; `parked=False` is in-flight redelivery work
    persisted so a CP restart resumes it instead of forgetting it."""
    stage_key: str = ""              # "{project}/{stage}"
    reason: str = ""                 # infeasible|retries-exhausted|...
    parked: bool = True
    attempt: int = 0
    detail: str = ""


@dataclass
class ParkedArrival(Record):
    """A parked ADMISSION arrival (cp/admission.py): accepted by submit()
    but deferred — an infeasible micro-solve, the park-on-full depth
    policy, or a per-tenant hard quota cap. Journaled so accepted-but-
    deferred work survives a CP failover: the promoted primary re-parks
    these from the replicated store instead of silently forgetting work
    the client was told was accepted. Distinct from ParkedWork, which is
    the reconverger's per-STAGE backlog; this is per-REQUEST admission
    state. `spec` is the make_arrival wire dict the service rebuilds
    from; `seq` preserves submission order across the restore."""
    tenant: str = ""
    name: str = ""                   # streamed service name
    stage_key: str = ""              # "{flow}/{stage}"
    submitted_at: float = 0.0        # admission-clock submit time
    seq: int = 0                     # controller submission sequence
    reason: str = "capacity"         # capacity | depth | quota
    spec: dict = field(default_factory=dict)
    eligible_nodes: list = field(default_factory=list)


@dataclass
class PlacementRecord(Record):
    """A stage's COMMITTED placement (cp/placement.py): the assignment the
    fleet actually runs and the per-node demand it books. Persisted so a
    restarted or promoted CP rebuilds its capacity ledger from the store
    instead of double-counting the next commit — the in-memory `_committed`
    map alone dies with the process, but the `servers.allocated` numbers it
    explains do not."""
    stage_key: str = ""                              # "{project}/{stage}"
    assignment: dict[str, str] = field(default_factory=dict)  # row -> slug
    # slug -> [cpu, memory, disk] booked by this placement
    demand_by_node: dict[str, list[float]] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Deployments (model.rs:639)
# --------------------------------------------------------------------------

class DeploymentStatus(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


@dataclass
class Deployment(Record):
    tenant: str = ""
    project: str = ""
    stage: str = ""
    status: str = DeploymentStatus.PENDING.value
    services: list[str] = field(default_factory=list)
    server: Optional[str] = None
    log: str = ""
    error: str = ""
    placement: Optional[dict] = None   # assignment snapshot
    # the serialized DeployRequest that produced this deployment, kept so
    # redeploy (web.rs api_stage_redeploy analog) can re-execute without
    # access to the project's config tree
    request: Optional[dict] = None
    finished_at: float = 0.0

    def public_dict(self) -> dict:
        """API/listing payload: to_dict minus the stored request — the
        whole flow config would otherwise ride along in every 50-entry
        history response. Persistence keeps to_dict (the request must
        survive restarts for redeploy)."""
        d = self.to_dict()
        d.pop("request", None)
        return d


# --------------------------------------------------------------------------
# Alerts / observation (model.rs:168,373)
# --------------------------------------------------------------------------

class AlertKind(str, enum.Enum):
    RESTART_LOOP = "restart_loop"
    UNEXPECTED_STOP = "unexpected_stop"
    UNHEALTHY = "unhealthy"
    NODE_OFFLINE = "node_offline"


@dataclass
class Alert(Record):
    tenant: str = ""
    server: str = ""
    container: str = ""
    kind: str = ""
    message: str = ""
    active: bool = True
    resolved_at: float = 0.0


@dataclass
class ObservedContainer(Record):
    """Desired-vs-observed reconciliation input (model.rs:373)."""
    server: str = ""
    name: str = ""
    image: str = ""
    state: str = ""
    health: Optional[str] = None
    restart_count: int = 0
    project: Optional[str] = None   # fleetflow label attribution
    stage: Optional[str] = None
    service: Optional[str] = None
    runtime: str = "docker"         # docker | podman | podman-rootless


# --------------------------------------------------------------------------
# Volumes (model.rs:743,793)
# --------------------------------------------------------------------------

@dataclass
class VolumeRecord(Record):
    tenant: str = ""
    server: str = ""
    name: str = ""
    driver: str = "local"
    size_mb: float = 0.0
    adopted: bool = False


@dataclass
class VolumeSnapshot(Record):
    volume: str = ""
    label: str = ""
    size_mb: float = 0.0


# --------------------------------------------------------------------------
# Builds (model.rs:881)
# --------------------------------------------------------------------------

class BuildStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class BuildJob(Record):
    tenant: str = ""
    repo: str = ""
    ref: str = "main"
    dockerfile: Optional[str] = None
    context: str = "."
    image_tag: str = ""
    push: bool = False
    status: str = BuildStatus.QUEUED.value
    worker: Optional[str] = None
    log: str = ""
    error: str = ""
    finished_at: float = 0.0


# --------------------------------------------------------------------------
# Cost / DNS (model.rs:579,611)
# --------------------------------------------------------------------------

@dataclass
class CostEntry(Record):
    tenant: str = ""
    server: str = ""
    provider: str = ""
    month: str = ""                 # "2026-07"
    amount: float = 0.0
    currency: str = "USD"


@dataclass
class DnsRecord(Record):
    tenant: str = ""
    zone: str = ""
    name: str = ""
    type: str = "A"
    content: str = ""
    ttl: int = 300
    proxied: bool = False
    synced: bool = False
