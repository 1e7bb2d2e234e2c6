"""Control-plane server bootstrap (the port's copy of
``fleetflow_tpu/cp/server.py``).

Analog of controlplane server.rs:82-197: store connect -> auth select ->
AppState{store, auth, agent_registry, log_router, placement} -> register
channels -> mesh CA load/gen + per-boot server cert -> listen; a
CpServerHandle supports graceful shutdown (server.rs CpServerHandle).

The placement service solves on the card: `ServerConfig.use_gpu_solver`
is on by default, as `PlacementService`'s `use_gpu` is (the reference's
`use_tpu_solver` is off by default), and `ServerConfig.device` names the
card's device (`None`: the card, and `start` raises DeviceUnavailable
before it listens when CUDA is absent; `"cpu"` runs the card scheduler's
plain PyTorch versions). With `use_gpu_solver=False` the service runs the
reference's host greedy path and `device` is not read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import asyncio

from .admission import AdmissionConfig, AdmissionController
from .agent_registry import AgentRegistry
from .auth import Claims, NoAuth, make_provider
from .failure_detector import FailureDetector, LeaseConfig
from .log_router import LogRouter
from .placement import PlacementService
from .protocol import ProtocolServer
from .reconverge import ReconvergeConfig, Reconverger
from .replication import (ReplicationConfig, Replicator, StandbyReplica,
                          StandbyRunner)
from .shards import ShardTable, shards_from_env
from .store import Store
from ..obs import get_logger, kv

log = get_logger("cp.server")

__all__ = ["ServerConfig", "AppState", "CpServerHandle", "start",
           "collector_sources"]

@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral (tests)
    name: str = "fleetflow-cp"
    db_path: Optional[str] = None      # None = in-memory (kv-mem analog)
    auth_kind: str = "none"            # none | token | jwks/auth0
    auth_secret: Optional[str] = None
    auth_jwks: Optional[str] = None    # JWKS url/path for kind=jwks
    auth_issuer: Optional[str] = None
    auth_audience: Optional[str] = None
    auth_client_id: Optional[str] = None   # OAuth client for device flow
    tls_dir: Optional[str] = None      # mesh-CA dir; None = plaintext
    use_gpu_solver: bool = True
    # the card scheduler's device: None = the card (no CUDA raises
    # DeviceUnavailable at start), "cpu" = its plain PyTorch versions
    device: Optional[str] = None
    master_key_env: bool = False       # load SecretBox from env
    # self-healing (cp/failure_detector.py + cp/reconverge.py): lease-
    # based failure detection driving automatic re-solve + redeploy.
    # Tuning guidance: docs/guide/12-self-healing.md
    self_heal: bool = True
    lease_s: float = 90.0
    suspect_grace_s: float = 30.0
    heal_interval_s: float = 5.0
    heal_backoff_base_s: float = 2.0
    heal_backoff_max_s: float = 60.0
    heal_max_attempts: int = 5
    # replication (cp/replication.py, docs/guide/13-cp-replication.md).
    # A primary needs nothing: standbys dial in on the replication
    # channel. A standby sets `standby_of` to the primary's host:port;
    # it streams the journal, watches the primary's lease, and promotes
    # itself (epoch bump + fencing) when the lease dies.
    standby_of: Optional[str] = None
    standby_token: Optional[str] = None      # auth for the primary dial
    replication_ring: int = 8192             # replayable backlog entries
    standby_ping_interval_s: float = 2.0
    standby_lease_s: float = 10.0
    standby_grace_s: float = 5.0
    # streaming admission (cp/admission.py, docs/guide/14): continuous
    # arrivals/departures batched into bucketed micro-solves with
    # backpressure + tenant fairness; primaries only (a standby must not
    # admit — there is one writer per epoch)
    admission: bool = True
    admission_queue: int = 4096
    admission_batch: int = 128
    admission_shed_age_s: float = 120.0
    # rolling SLO objectives (obs/slo.py, docs/guide/10): objective
    # name -> threshold, e.g. {"placement-p99-ms": 50}. The engine is
    # built on primaries (and on promotion) even with no objectives —
    # `fleet slo status` then reports raw stream quantiles only.
    slo: Optional[dict] = None
    # fleet-horizon collector (obs/collector.py + obs/tsdb.py): the
    # cadence sampler feeding the in-process time-series store behind
    # `fleet top`, `fleet obs query/export` and the obs.query channel.
    # Primaries only (built again on promotion) — a standby's series
    # would be all zeros with no agents attached.
    collector: bool = True
    collector_interval_s: float = 5.0
    collector_capacity: int = 512          # samples retained per series
    collector_max_series: int = 4096       # series-cardinality cap
    # control-plane fan-out sharding (cp/shards.py, docs/guide/17):
    # agents are consistent-hashed onto this many worker shards; every
    # fan-out path (registry batches, log lanes, verdict coalescing)
    # runs shard-parallel. 0 = take FLEET_CP_SHARDS from the env
    # (default 4); 1 = effectively unsharded.
    cp_shards: int = 0


@dataclass
class AppState:
    """server.rs AppState:18-28 (+ the placement service)."""
    store: Store
    auth: object
    agent_registry: AgentRegistry
    log_router: LogRouter
    placement: PlacementService
    name: str = "fleetflow-cp"
    secret_box: Optional[object] = None
    dns_backend: Optional[object] = None
    backend_factory: Callable = None       # () -> ContainerBackend
    # name -> cloud ServerProvider (server.rs provision path; injectable
    # for tests, shells out to usacloud/aws otherwise)
    server_provider_factory: Callable = None
    ssh_runner: Callable = None            # injectable for deploy.run tests
    deploy_sleep: Callable[[float], None] = time.sleep
    started_at: float = field(default_factory=time.time)
    bg_tasks: set = field(default_factory=set)
    # chaos-harness injector when this state is driven by the chaos
    # runner (chaos/injector.py); None in production. An extension point:
    # anything holding AppState can consult the active fault set.
    chaos: Optional[object] = None
    # self-healing pair (None when self_heal is off): the lease-based
    # failure detector fed by agent heartbeats/disconnects, and the
    # reconverger that turns its verdicts into re-solves + redeploys
    failure_detector: Optional[FailureDetector] = None
    reconverger: Optional[Reconverger] = None
    # {"issuer", "client_id", "audience"} when the CP runs JwksAuth with a
    # device-flow-capable IdP; the dashboard's browser login uses it
    auth_idp: Optional[dict] = None
    # replication (docs/guide/13-cp-replication.md): "primary" serves
    # every channel and ships its journal through `replicator`;
    # "standby" refuses mutations + agent sessions until its
    # StandbyRunner promotes it
    replication_role: str = "primary"
    replicator: Optional[Replicator] = None
    standby: Optional[StandbyRunner] = None
    # streaming-admission controller (cp/admission.py); None on standbys
    # and when ServerConfig.admission is off. Its pressure() output is
    # the autoscaler's solver-pressure input.
    admission: Optional[AdmissionController] = None
    # rolling SLO engine (obs/slo.py); None on standbys. Installed as
    # the process default so the placement/admission/reconverge
    # observation points route to it.
    slo: Optional[object] = None
    # fleet-horizon collector (obs/collector.py); None on standbys and
    # when ServerConfig.collector is off. The obs.query channel and the
    # agent heartbeat handler both reach it through here.
    collector: Optional[object] = None


class CpServerHandle:
    def __init__(self, server: ProtocolServer, state: AppState,
                 host: str, port: int, ca: Optional["MeshCa"]):
        self.server = server
        self.state = state
        self.host = host
        self.port = port
        self.ca = ca

    @property
    def ca_pem(self) -> Optional[bytes]:
        return self.ca.ca_pem if self.ca else None

    async def stop(self) -> None:
        if self.state.standby is not None:
            self.state.standby.stop()
        if self.state.reconverger is not None:
            self.state.reconverger.stop()
        if self.state.admission is not None:
            self.state.admission.stop()
        if self.state.collector is not None:
            self.state.collector.stop()
        await self.server.stop()
        self.state.store.flush()


def _default_server_provider_factory(name: str, **kw):
    """Resolve a cloud ServerProvider by name (server_provider.rs enum
    dispatch). Shells out to the provider CLI; raises on unknown names."""
    if name == "sakura":
        from ..cloud.sakura import SakuraServerProvider
        return SakuraServerProvider(**kw)
    if name == "aws":
        from ..cloud.aws import AwsServerProvider
        return AwsServerProvider(**kw)
    raise ValueError(f"unknown server provider {name!r}")


def _default_backend_factory():
    """CP-local deploys (handlers/deploy.rs:470-507) use the local docker
    daemon when reachable, the in-memory mock otherwise (tests/dev)."""
    from ..runtime.backend import DockerCliBackend, MockBackend
    docker = DockerCliBackend()
    if docker.ping():
        return docker
    # dev mock: images materialize on pull, so deploys succeed end-to-end
    return MockBackend(auto_pull=True)


async def start(config: ServerConfig, *,
                backend_factory: Optional[Callable] = None,
                server_provider_factory: Optional[Callable] = None,
                ssh_runner: Optional[Callable] = None,
                deploy_sleep: Callable[[float], None] = time.sleep,
                ) -> CpServerHandle:
    """server.rs start:82-126. The placement service is built before
    anything listens or spawns: on the card (`config.device` None)
    without CUDA, start raises DeviceUnavailable."""
    store = Store(config.db_path)
    auth = make_provider(config.auth_kind, config.auth_secret,
                         jwks=config.auth_jwks, issuer=config.auth_issuer,
                         audience=config.auth_audience)

    secret_box = None
    if config.master_key_env:
        from .crypto import SecretBox
        secret_box = SecretBox.from_env()

    shard_table = ShardTable(config.cp_shards or shards_from_env())
    state = AppState(
        store=store,
        auth=auth,
        agent_registry=AgentRegistry(shard_table=shard_table),
        log_router=LogRouter(shard_table=shard_table),
        placement=PlacementService(store, use_gpu=config.use_gpu_solver,
                                   device=config.device),
        name=config.name,
        secret_box=secret_box,
        backend_factory=backend_factory or _default_backend_factory,
        server_provider_factory=(server_provider_factory
                                 or _default_server_provider_factory),
        ssh_runner=ssh_runner,
        deploy_sleep=deploy_sleep,
        auth_idp=({"issuer": config.auth_issuer,
                   "client_id": config.auth_client_id,
                   "audience": config.auth_audience}
                  if (config.auth_kind in ("jwks", "auth0")
                      and config.auth_issuer and config.auth_client_id)
                  else None),
    )

    def authenticate(identity: str, token: Optional[str]):
        """Returns the peer's Claims (stashed on the Connection for
        per-method permission checks, handlers._need_perm) or False.
        NoAuth returns True: no claims, handlers skip enforcement —
        the reference's NoAuth '(everything is the anonymous admin)'."""
        if isinstance(auth, NoAuth):
            return True
        try:
            claims: Claims = auth.verify(token)
            return claims if claims.sub else False
        except Exception:
            return False

    ca: Optional["MeshCa"] = None
    ssl_ctx = None
    if config.tls_dir:
        # lazy: cert.py needs the `cryptography` package, which plaintext
        # deployments (and the chaos harness) must not require
        from .cert import ensure_mesh_ca, server_ssl_context
        ca = ensure_mesh_ca(config.tls_dir)
        ssl_ctx = server_ssl_context(ca, common_name=config.name,
                                     work_dir=config.tls_dir)

    repl_config = ReplicationConfig(
        ring_entries=config.replication_ring,
        ping_interval_s=config.standby_ping_interval_s,
        lease_s=config.standby_lease_s,
        grace_s=config.standby_grace_s)

    if config.standby_of:
        # standby: stream the primary's journal, watch its lease, promote
        # on death. No self-heal machinery until promotion — a standby
        # must not issue verdicts about agents it doesn't serve.
        state.replication_role = "standby"
        host_s, _, port_s = config.standby_of.rpartition(":")
        state.standby = StandbyRunner(
            StandbyReplica(store), host_s, int(port_s),
            identity=config.name, token=config.standby_token,
            config=repl_config,
            on_promote=lambda: _promote(state, config, repl_config))
        state.standby.spawn()
    else:
        state.replicator = Replicator(
            store, config=repl_config, loop=asyncio.get_running_loop())
        state.agent_registry.epoch_source = lambda: store.epoch
        _build_slo(state, config)
        if config.self_heal:
            _build_self_heal(state, config)
        if config.admission:
            _build_admission(state, config)
        if config.collector:
            _build_collector(state, config)

    server = ProtocolServer(
        name=config.name, authenticate=authenticate, ssl_context=ssl_ctx,
        # the welcome frame advertises role + fencing epoch, so agents
        # and CLIs can spot a zombie ex-primary at the handshake
        welcome_extra=lambda: {"role": state.replication_role,
                               "epoch": store.epoch})
    from .handlers import register_all
    register_all(server, state)

    host, port = await server.start(config.host, config.port)
    log.info("listening %s", kv(
        host=host, port=port, name=config.name,
        role=state.replication_role,
        tls=bool(config.tls_dir), auth=config.auth_kind,
        db=config.db_path or ":memory:",
        solver=("gpu" if config.use_gpu_solver else "host"),
        device=(config.device or "cuda") if config.use_gpu_solver else None))
    return CpServerHandle(server, state, host, port, ca)


def _watch(task: Optional[asyncio.Task], name: str) -> None:
    """Log a background loop that ends by itself: a fault of the device
    path ends the reconverger's, the admission drain's and the
    collector's loops by design (retrying around a missing card or a
    broken kernel would hide it), and the server goes on serving its
    channels, so the ending must be visible."""
    if task is None:
        return

    def ended(t: asyncio.Task) -> None:
        if t.cancelled():
            return
        e = t.exception()
        if e is not None:
            log.error("%s loop ended %s", name,
                      kv(error=f"{type(e).__name__}: {e}"))
    task.add_done_callback(ended)


def _build_self_heal(state: AppState, config: ServerConfig) -> None:
    """The self-healing pair + crash-recovery boot sequence, shared by
    primary start and standby promotion (crash-only design: recovery IS
    the boot path)."""
    state.failure_detector = FailureDetector(LeaseConfig(
        lease_s=config.lease_s,
        suspect_grace_s=config.suspect_grace_s))
    state.reconverger = Reconverger(
        state, state.failure_detector,
        config=ReconvergeConfig(
            interval_s=config.heal_interval_s,
            backoff_base_s=config.heal_backoff_base_s,
            backoff_max_s=config.heal_backoff_max_s,
            max_attempts=config.heal_max_attempts))
    # a restarted CP picks its convergence debt back up BEFORE any
    # agent reconnects
    state.reconverger.resume()
    # prime a lease for EVERY known server: an agent that died with the
    # old CP (or while it was down) never heartbeats the new one, and
    # without a lease its death would be invisible forever — its primed
    # lease expires to a DEAD verdict, the re-solve moves its stages,
    # and the stuck redelivery work is superseded. Live agents renew the
    # primed lease with their first heartbeat; servers with nothing
    # placed on them make the verdict a no-op.
    for s in state.store.list("servers"):
        state.failure_detector.prime(s.slug)
    _watch(state.reconverger.spawn(), "reconverge")


def _build_slo(state: AppState, config: ServerConfig) -> None:
    """Rolling SLO engine (obs/slo.py), installed as the process default
    so the placement/admission/reconverge observation points feed it.
    Primaries only — a standby serves no traffic to measure."""
    from ..obs.slo import SloEngine, parse_slo_props, set_engine
    state.slo = set_engine(SloEngine(parse_slo_props(config.slo or {})))


def _build_admission(state: AppState, config: ServerConfig) -> None:
    """Streaming-admission controller + its background drain loop
    (primaries only: exactly one admission writer per epoch)."""
    state.admission = AdmissionController(
        state.placement,
        config=AdmissionConfig(max_queue=config.admission_queue,
                               batch_max=config.admission_batch,
                               shed_age_s=config.admission_shed_age_s),
        store=state.store)
    state.admission.spawn()
    _watch(state.admission._task, "admission")


def collector_sources(state: AppState) -> list:
    """The CP's deep-gauge sources for the obs collector: callables
    run every sampling tick that read live subsystem state the registry
    scrape can't see (per-tenant queues, per-subscriber backlogs, slot
    byte accounting). Each both sets the registry gauges (so GET
    /metrics agrees) and RETURNS (name, labels, value, kind) entries —
    the chaos runner reuses these sources with registry=None, where the
    returned entries are the only way samples reach the capture (the
    process-global registry carries cross-test residue that must never
    leak into a pinned artifact). The collector dedups name+labels
    within a tick, so the double reporting never double-records."""
    from ..obs.collector import (_M_LOG_BACKLOG, _M_RECONV_DEBT,
                                 _M_RES_BUDGET, _M_TENANT_DEPTH,
                                 _M_TENANT_OLDEST)

    tenants_seen: set = set()

    def _slo(now):
        if state.slo is not None:
            state.slo.refresh()
        return ()

    def _admission(now):
        adm = state.admission
        if adm is None:
            return ()
        census = adm.queue_census()
        out = [("fleet_admission_queue_depth", {},
                float(census["queue_depth"])),
               ("fleet_admission_oldest_age_seconds", {},
                float(census["oldest_age_s"])),
               ("fleet_admission_parked", {}, float(census["parked"]))]
        live = set(census["tenants"])
        for tenant, row in census["tenants"].items():
            _M_TENANT_DEPTH.set(row["queued"], tenant=tenant)
            _M_TENANT_OLDEST.set(row["oldest_age_s"], tenant=tenant)
            out.append(("fleet_admission_tenant_queue_depth",
                        {"tenant": tenant}, float(row["queued"])))
            out.append(("fleet_admission_tenant_oldest_age_seconds",
                        {"tenant": tenant}, float(row["oldest_age_s"])))
        # a tenant whose queue drained must read 0, not freeze at its
        # last depth
        for tenant in tenants_seen - live:
            _M_TENANT_DEPTH.set(0, tenant=tenant)
            _M_TENANT_OLDEST.set(0.0, tenant=tenant)
            out.append(("fleet_admission_tenant_queue_depth",
                        {"tenant": tenant}, 0.0))
            out.append(("fleet_admission_tenant_oldest_age_seconds",
                        {"tenant": tenant}, 0.0))
        tenants_seen.update(live)
        return out

    def _log_router(now):
        total, subs = state.log_router.backlog()
        _M_LOG_BACKLOG.set(total)
        out = [("fleet_log_router_backlog_lines", {}, float(total))]
        # per-subscriber rows are TSDB-only: subscriber ids are
        # unbounded cardinality, so they must not become registry
        # label children
        for s in subs:
            out.append(("fleet_log_router_subscriber_backlog_lines",
                        {"subscriber": str(s["subscriber"])},
                        float(s["queued"])))
        return out

    def _reconverge(now):
        rec = state.reconverger
        if rec is None:
            return ()
        debt = rec.debt()
        _M_RECONV_DEBT.set(debt)
        return [("fleet_reconverge_redelivery_debt", {}, float(debt)),
                ("fleet_reconverge_parked_stages", {},
                 float(len(rec.parked_stage_keys())))]

    def _agents(now):
        return [("fleet_agents_connected", {},
                 float(len(state.agent_registry.list_connected()))),
                ("fleet_agent_commands_in_flight", {},
                 float(state.agent_registry.inflight()))]

    def _slots(now):
        slots = state.placement.solver_slots()
        _M_RES_BUDGET.set(slots["budget_bytes"])
        return [("fleet_sched_resident_budget_bytes", {},
                 float(slots["budget_bytes"])),
                ("fleet_sched_resident_bytes", {},
                 float(slots["resident_bytes"])),
                ("fleet_solver_resident_bytes_drift", {},
                 float(slots.get("bytes_drift", 0)))]

    def _shards(now):
        # per-shard occupancy + in-flight depth (cp/shards.py): shard
        # ids are a small fixed set, so the occupancy gauge also lives
        # in the registry; the in-flight split is TSDB-only like the
        # aggregate fleet_agent_commands_in_flight above
        out = []
        for row in state.agent_registry.shard_census():
            labels = {"shard": str(row["shard"])}
            out.append(("fleet_cp_shard_agents", labels,
                        float(row["agents"])))
            out.append(("fleet_cp_shard_inflight", labels,
                        float(row["inflight"])))
        return out

    return [_slo, _admission, _log_router, _reconverge, _agents, _slots,
            _shards]


def _build_collector(state: AppState, config: ServerConfig) -> None:
    """The fleet-horizon sampler (obs/collector.py): registry scrape +
    deep sources into the in-process TSDB, on the server's asyncio loop.
    Primaries only (rebuilt on promotion, like the SLO engine)."""
    from ..obs.collector import Collector
    from ..obs.tsdb import TimeSeriesDB
    tsdb = TimeSeriesDB(capacity_per_series=config.collector_capacity,
                        max_series=config.collector_max_series)
    collector = Collector(tsdb, interval_s=config.collector_interval_s)
    for src in collector_sources(state):
        collector.add_source(src)
    state.collector = collector
    collector.spawn()
    _watch(collector._task, "collector")


def _promote(state: AppState, config: ServerConfig,
             repl_config: ReplicationConfig) -> None:
    """Standby -> primary flip (StandbyRunner.on_promote): open the
    gates, start shipping OUR journal to the next generation of
    standbys, and pick up the dead primary's convergence debt. The
    promoted primary solves on `config.device`, on a fresh scheduler."""
    state.replication_role = "primary"
    # a fresh placement service on the configured solver and device: its
    # committed book loads from the replicated placements table, so the
    # promoted primary's next commit of a stage supersedes the dead
    # primary's allocation instead of stacking on it (the reference keeps
    # the service the standby built over its then-empty store)
    state.placement = PlacementService(state.store,
                                       use_gpu=config.use_gpu_solver,
                                       device=config.device)
    state.replicator = Replicator(
        state.store, config=repl_config, loop=asyncio.get_running_loop())
    state.agent_registry.epoch_source = lambda: state.store.epoch
    _build_slo(state, config)
    if config.self_heal:
        _build_self_heal(state, config)
    if config.admission:
        # streams do not survive the dead primary (they are in-memory
        # batching state, not placement truth — that is journaled); a
        # client's next deploy.submit re-attaches
        _build_admission(state, config)
    if config.collector:
        # fresh horizon: the standby's (empty) store is replaced, not
        # merged — series begin at promotion, like the SLO windows
        _build_collector(state, config)
    log.warning("standby promoted: now serving as primary %s", kv(
        epoch=state.store.epoch, name=config.name))
