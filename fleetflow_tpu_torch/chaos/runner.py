"""Chaos runner: replay a fault schedule against a simulated fleet (the
port's copy of ``fleetflow_tpu/chaos/runner.py``).

The simulation is the REAL control plane in a box — no network, no
subprocesses, but the production code paths end to end:

  Store                  in-memory, with the mutation-observer hook
  PlacementService       real solves on the card, 2-phase reservations,
                         churn holds
  AgentRegistry          real command correlation + delivery hook
  handlers.execute_deploy  the real deploy fan-out/commit/release path
  DeployEngine           real 5-step pipeline per node
  MockBackend            the fake-docker backend, one per node
  Autoscaler             real pool reconciler on the virtual clock

Each simulated node is a `SimAgent`: a MockBackend plus a duck-typed
Connection whose `send_event` executes the command inline (mirroring
fleet-agent's dispatch) and resolves the registry future — so a deploy
flows CP -> registry -> "wire" -> agent -> engine -> backend exactly as
in production, just synchronously and on a virtual clock.

Determinism: one seed fixes the schedule AND the replay. All iteration
is sorted or insertion-ordered, the event log carries only virtual
times and stable names (no wall clocks, no uuids), and re-running a
seed must reproduce the log byte for byte (`ChaosReport.digest()`).

The device: the world places on the card. `run_schedule(device=None)` is
the card's scheduler (DeviceUnavailable without CUDA), `device="cpu"` the
same scheduler's plain PyTorch versions, and `use_gpu=False` the host
greedy path alone: the reference's own world, whose event log it
reproduces digest for digest. Every failover builds a fresh AppState with
its own placement service and scheduler; the dead primary's is freed with
the state it belonged to. A fault of the device path itself
(`cp.placement._device_fault`) ends the run with its error: a deploy that
raises one is not logged as `deploy-failed`, and the collector re-raises
one from its sources.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..core.model import (Flow, ResourceSpec, Service, Stage)
from ..cp.admission import (AdmissionConfig, AdmissionController,
                            AdmissionRejected)
from ..cp.agent_registry import AgentRegistry
from ..cp.auth import NoAuth
from ..cp.autoscaler import Autoscaler
from ..cp.failure_detector import FailureDetector, LeaseConfig
from ..cp.log_router import LogRouter
from ..cp.models import (SchedulingState, ServerCapacity, ServerLabelsRec,
                         WorkerPool)
from ..cp.placement import PlacementService, _device_fault
from ..cp.reconverge import ReconvergeConfig, Reconverger
from ..cp.replication import StandbyReplica
from ..cp.server import AppState
from ..cp.shards import ShardTable
from ..cp.store import ReplicationFenced, Store
from ..core.errors import ControlPlaneError
from ..obs.slo import SloEngine, get_engine, parse_slo_props, set_engine
from ..obs.tsdb import TimeSeriesDB
from ..runtime.backend import MockBackend
from ..runtime.engine import DeployEngine, DeployRequest
from ..sched.base import Placement, level_schedule
from ..lower.tensors import local_node, lower_stage
from . import faults as F
from .injector import FaultInjector
from .invariants import check_final, check_instant, record_outage_census
from .worldgen import (M_WORLD_ARRIVALS, M_WORLD_RECLAIMS,
                       M_WORLD_ZONE_OUTAGES, validate_schedule)

__all__ = ["VirtualClock", "ChaosReport", "ChaosWorld", "run_schedule",
           "make_flow", "node_slug", "VIRTUAL_SLO_STREAMS", "slo_summary"]

TENANT = "default"
POOL_NAME = "workers"

# The SLO objectives every chaos world runs under (the `slo-met` FINAL
# invariant judges them: SLO invariants beside the safety invariants).
# heal/wait are exact VIRTUAL-clock arithmetic (deterministic);
# placement/solve values are wall ms of real solves, so those thresholds
# carry CI-machine headroom — the canary tests prove the invariant still
# has teeth.
CHAOS_SLOS = {
    "placement-p99-ms": 5000.0,     # per-stage churn re-solve (wall)
    "heal-p99-s": 600.0,            # dead verdict -> reconverged (virtual)
    "admission-wait-p99-s": 300.0,  # submit -> placed (virtual; shed age
                                    # bounds the queue at 240 s)
}

# streams whose samples are exact virtual-clock arithmetic — identical
# on any machine, so `fleet plan simulate` may pin a report digest over
# them; the remaining streams measure wall-clock host solves and are
# reported outside the digest
VIRTUAL_SLO_STREAMS = ("admission_wait_s", "heal_s")


def slo_summary(engine) -> dict:
    """Per-stream lifetime quantiles from a world's SLO engine, split
    into the deterministic virtual-clock bucket and the wall bucket
    (trace footers and `fleet plan simulate` reports digest only the
    former)."""
    if engine is None:
        return {}
    from ..obs.slo import KNOWN_STREAMS
    out: dict = {"virtual": {}, "wall": {}}
    for stream in KNOWN_STREAMS:
        n = engine.samples(stream)
        if not n:
            continue
        row: dict = {"n": n}
        for label, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            v = engine.observed_quantile(stream, q)
            if v is not None:
                row[label] = round(float(v), 6)
        bucket = "virtual" if stream in VIRTUAL_SLO_STREAMS else "wall"
        out[bucket][stream] = row
    return out


class VirtualClock:
    """Injectable time (the cp/autoscaler pattern), advanced only by the
    runner — never by real elapsed time. The world's Store stamps record
    timestamps from this clock too, so every age the autoscaler computes
    (idle grace, zombie/corpse reaping) is exact virtual arithmetic —
    identical on any machine, which is what makes the event-log digest
    reproducible across processes."""

    def __init__(self, start: float = 0.0):
        self.base = float(start)
        self._t = self.base

    def now(self) -> float:
        return self._t

    def offset(self) -> float:
        return self._t - self.base

    def advance(self, dt: float) -> None:
        self._t += max(float(dt), 0.0)

    def advance_to(self, offset: float) -> None:
        self._t = max(self._t, self.base + float(offset))


# --------------------------------------------------------------------------
# synthetic fleet
# --------------------------------------------------------------------------

def node_slug(i: int) -> str:
    return f"node{i:03d}"


def make_flow(n_services: int, n_stages: int, node_slugs: list[str],
              seed: int,
              stage_servers: Optional[dict[int, list[str]]] = None) -> Flow:
    """Synthetic flow shaped like a production fleet: dependency chains
    of depth <= 5, mixed demand, and every 20th service running 2
    replicas with hard self-anti-affinity (replica spreading).
    `stage_servers` (stage index -> slugs) homes stages onto subsets of
    the fleet — the world simulator's region-per-stage layout."""
    rng = random.Random(seed)
    flow = Flow(name="chaosfleet")
    names = [f"svc{i:04d}" for i in range(n_services)]
    per_stage = max(1, (n_services + n_stages - 1) // n_stages)
    for i, name in enumerate(names):
        svc = Service(
            name=name, image="chaos-app", version="1",
            resources=ResourceSpec(
                cpu=rng.choice((0.05, 0.1, 0.2)),
                memory=float(rng.choice((32, 64, 128))), disk=0.0),
        )
        # chains of 5 within a stage block (stage blocks are contiguous,
        # so dependencies never cross stages)
        if i % 5 != 0 and (i - 1) // per_stage == i // per_stage:
            svc.depends_on = [names[i - 1]]
        if i % 20 == 10:
            svc.replicas = 2
            svc.anti_affinity = [name]     # hard replica spreading
        flow.services[name] = svc
    for g in range(n_stages):
        block = names[g * per_stage:(g + 1) * per_stage]
        if not block:
            continue
        servers = (stage_servers.get(g) if stage_servers else None) \
            or node_slugs
        flow.stages[f"app{g}"] = Stage(name=f"app{g}", services=block,
                                       servers=list(servers))
    return flow


# --------------------------------------------------------------------------
# simulated agents
# --------------------------------------------------------------------------

class SimConnection:
    """Duck-types cp.protocol.Connection for AgentRegistry's use: the
    'wire' is an inline call into the agent."""

    def __init__(self, agent: "SimAgent"):
        self.agent = agent
        self.identity = agent.slug
        self._closed = False

    async def send_event(self, channel: str, method: str,
                         payload: dict) -> None:
        if self._closed:
            raise ControlPlaneError(
                f"connection to {self.agent.slug} is closed")
        await self.agent.on_command(method, payload)

    async def close(self) -> None:
        self._closed = True


class SimAgent:
    """One node: MockBackend + the agent command dispatch (the subset of
    fleet-agent's execute_command the chaos scenarios exercise)."""

    def __init__(self, slug: str, world: "ChaosWorld"):
        self.slug = slug
        self.world = world
        # the canned pack delivers deploy faults at the engine hook;
        # MockBackend.fault_hook remains available for scenario packs
        # that need op-level (pull/create/start) injection
        self.backend = MockBackend(auto_pull=True)
        self.conn = SimConnection(self)
        # idempotency dedupe window (the agent/agent.py semantics): a
        # replayed key answers from the cache instead of re-executing.
        # Survives CP failover — the agent process outlives its CP — but
        # not a node crash (world.connect builds a fresh SimAgent).
        self.idem: dict[str, dict] = {}

    async def on_command(self, method: str, payload: dict) -> None:
        request_id = payload.get("request_id")
        try:
            result = await self.execute(method, payload.get("payload", {}))
            reply = {"request_id": request_id, "result": result}
        except Exception as e:   # mirror agent._on_command: errors ride back
            reply = {"request_id": request_id, "error": str(e)}
        if request_id:
            self.world.state.agent_registry.resolve_result(request_id, reply)

    async def execute(self, method: str, payload: dict) -> dict:
        if method == "ping":
            return {"pong": True, "slug": self.slug}
        if method in ("restart", "start", "stop"):
            name = payload["container"]
            getattr(self.backend, method)(name)
            return {method: name}
        if method == "deploy.execute":
            req = DeployRequest.from_dict(payload["request"])
            if not req.node:
                req.node = self.slug
            key = payload.get("idempotency_key")
            if key and key in self.idem:
                self.world.log("idem-replay", node=self.slug,
                               stage=req.stage_name)
                return self.idem[key]
            placement = self.world.cp_placement(req, payload.get("assignment"))
            engine = DeployEngine(
                self.backend, sleep=self.world.clock.advance,
                fault_hook=self.world.injector.engine_hook(self.slug))
            res = engine.execute(req, placement=placement)
            if not res.ok:
                raise RuntimeError(f"failed services: {sorted(res.failed)}")
            result = {"deployed": res.deployed, "removed": res.removed}
            if key:
                self.idem[key] = result
                # execution census for the cp-failover-converged
                # invariant: a key executing twice ON ONE AGENT means a
                # dedupe window was lost across a failover (one key
                # legitimately fans out to several nodes)
                rec = self.world.idem_executions.setdefault(
                    f"{key}@{self.slug}", [req.stage_name, 0])
                rec[1] += 1
            return result
        if method == "deploy.down":
            req = DeployRequest.from_dict(payload["request"])
            engine = DeployEngine(self.backend, sleep=self.world.clock.advance)
            res = engine.down(req.flow, req.stage_name,
                              req.target_services or None)
            return {"removed": res.removed}
        raise ValueError(f"unknown sim agent command {method!r}")


# --------------------------------------------------------------------------
# world + report
# --------------------------------------------------------------------------

@dataclass
class ChaosReport:
    scenario: str
    seed: int
    services: int
    nodes: int
    stages: int
    events: list[dict] = field(default_factory=list)
    violations: list[str] = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    # per-stream SLO quantile summary (slo_summary): the virtual bucket
    # is deterministic and feeds trace footers / `fleet plan simulate`
    # report digests; OUTSIDE digest() like tsdb — derived telemetry
    slo: dict = field(default_factory=dict)
    # fleet-horizon capture (obs/tsdb.py snapshot(), schema-versioned
    # with its own content digest). Deliberately OUTSIDE digest(): the
    # replayable-repro contract hashes the causal event log, and the
    # capture is derived telemetry — its own `digest` key pins ITS
    # determinism separately (tests/test_collector.py,
    # tests/test_torch_tsdb.py)
    tsdb: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def digest(self) -> str:
        """Canonical hash of the event log — two runs of one seed must
        produce the same digest (the replayable-repro contract)."""
        blob = json.dumps(self.events, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def to_dict(self) -> dict:
        out = {"scenario": self.scenario, "seed": self.seed,
               "services": self.services, "nodes": self.nodes,
               "stages": self.stages, "ok": self.ok,
               "digest": self.digest(), "stats": self.stats,
               "slo": self.slo,
               "violations": self.violations, "events": self.events}
        if self.tsdb is not None:
            out["tsdb"] = self.tsdb
        return out


class ChaosWorld:
    """The simulated fleet: AppState + per-node agents/backends +
    virtual clock + causally-ordered event log."""

    LEASE = dict(lease_s=60.0, suspect_grace_s=30.0, flap_window_s=300.0,
                 flap_threshold=3, damp_hold_s=120.0)
    RECONV = dict(backoff_base_s=5.0, backoff_max_s=60.0, max_attempts=5)

    def __init__(self, flow: Flow, injector: FaultInjector,
                 clock: VirtualClock, pool_min: int = 0, seed: int = 0,
                 replicated: bool = False,
                 store_dir: Optional[Path] = None,
                 tenant_caps: Optional[dict] = None,
                 world_meta: Optional[dict] = None,
                 device=None, use_gpu: bool = True):
        self.flow = flow
        # where every state of this world places (failovers included):
        # the card by default, `device` naming another, or the host greedy
        # path alone with use_gpu=False
        self.device = device
        self.use_gpu = use_gpu
        self.clock = clock
        self.injector = injector
        self._seed = seed
        # per-tenant hard admission caps (tenant-storm scenario); wired
        # into every AdmissionConfig this world builds, failovers included
        self.tenant_caps = dict(tenant_caps or {})
        injector.clock = clock
        injector.on_fire = lambda kind, target: self.log(
            "fault-fired", kind=kind, target=target)
        # a replicated world's primary keeps a REAL journal (under a
        # throwaway dir) so the mid-compaction kill exercises the actual
        # snapshot/truncate lifecycle, not a no-op
        self.replicated = replicated
        self._store_dir = store_dir
        self._store_gen = 1
        # fleet-horizon capture (obs/tsdb.py): one TSDB on the VIRTUAL
        # clock for the whole scenario — it survives failover (the
        # promoted state gets a fresh collector bound to the same store,
        # so series run straight through the kill, which is exactly the
        # history a post-mortem wants). registry=None in _wire_obs keeps
        # process-global residue out of the pinned capture schema.
        self.tsdb = TimeSeriesDB(clock=clock.now)
        self.obs_collector = None
        store = Store(self._store_path("cp"), clock=clock.now)
        self.state = self._build_state(store)
        # the self-healing pair, on the VIRTUAL clock (lease expiry and
        # retry backoff are exact virtual arithmetic) with seeded jitter —
        # so every heal decision replays identically across processes
        self.detector = FailureDetector(LeaseConfig(**self.LEASE),
                                        clock=clock.now)
        self.reconverger = Reconverger(
            self.state, self.detector,
            config=ReconvergeConfig(**self.RECONV),
            clock=clock.now, rng=random.Random(seed ^ 0x5EA1))
        self.state.failure_detector = self.detector
        self.state.reconverger = self.reconverger
        self.agents: dict[str, SimAgent] = {}
        self.backends: dict[str, MockBackend] = {}
        self.events: list[dict] = []
        self._seq = 0
        self._levels_cache: dict[tuple, list[list[str]]] = {}
        self._server_status: dict[str, str] = {}
        self._provider_instances: dict[str, str] = {}   # name -> id
        self.pool_min = pool_min
        self.stage_keys = [f"{flow.name}/{s}" for s in sorted(flow.stages)]
        self.autoscaler = Autoscaler(self.state, clock=clock.now)
        store.subscribe(self._observe)
        # cp-failover bookkeeping (cp-failover-converged invariant)
        self.cp_failovers = 0
        self.fencing_rejections = 0
        self.prekill_work: set[tuple[str, bool]] = set()
        self.idem_executions: dict[str, list] = {}   # key -> [stage, runs]
        # streaming-admission bookkeeping (arrival-storm scenario): the
        # seeded generator state and which tenants deliberately burst
        # (the admission-fair invariant exempts them from the bound)
        self.admission_burst_tenants: set[str] = set()
        self._admit_rng = random.Random(seed ^ 0xAD317)
        self._admit_counts: dict[str, int] = {}
        # world-simulator topology (chaos/worldgen.py): region/spot-pool
        # membership by slug, stage -> home region, and the live
        # correlated-fault bookkeeping the degraded-gracefully invariant
        # reads. Empty for the classic single-domain scenarios.
        meta = dict(world_meta or {})
        self.regions: dict[str, list[str]] = dict(meta.get("regions", {}))
        self.spot_pools: dict[str, list[str]] = dict(
            meta.get("spot_pools", {}))
        self.capacity_scale: dict[str, float] = dict(
            meta.get("capacity_scale", {}))
        self.stage_region: dict[str, str] = dict(
            meta.get("stage_region", {}))
        self.node_region: dict[str, str] = {
            slug: r for r, slugs in self.regions.items() for slug in slugs}
        self.active_outages: set[str] = set()
        self.outage_killed: dict[str, list[str]] = {}
        self.outage_breaches: list[str] = []
        self.zone_outages = 0
        self.spot_pending: dict[str, list[str]] = {}
        self.spot_reclaimed: dict[str, list[str]] = {}
        self.hotspot_tenant: Optional[str] = None
        self.standby: Optional[StandbyReplica] = None
        self.standby_store: Optional[Store] = None
        if replicated:
            self._wire_replication(store)

    def _store_path(self, name: str) -> Optional[str]:
        if not self.replicated or self._store_dir is None:
            return None
        return str(self._store_dir / f"{name}{self._store_gen}.json")

    # CP worker shards for every chaos world (cp/shards.py): FIXED, not
    # read from FLEET_CP_SHARDS — the shard layout shapes batch lanes
    # and log routing, and a pinned digest must not depend on the env.
    # Sharding is therefore ACTIVE in every pinned scenario.
    CP_SHARDS = 4

    def _build_state(self, store: Store) -> AppState:
        shard_table = ShardTable(self.CP_SHARDS)
        state = AppState(
            store=store, auth=NoAuth(),
            agent_registry=AgentRegistry(shard_table=shard_table),
            log_router=LogRouter(shard_table=shard_table),
            placement=PlacementService(store, use_gpu=self.use_gpu,
                                       device=self.device),
            backend_factory=lambda: MockBackend(auto_pull=True),
            server_provider_factory=self._provider_factory,
            deploy_sleep=self.clock.advance, chaos=self.injector)
        state.agent_registry.delivery_hook = self.injector.delivery_hook
        state.agent_registry.epoch_source = lambda: store.epoch
        # streaming admission on the virtual clock (cp/admission.py):
        # batch_max/quantum sized so an arrival storm actually QUEUES
        # (fairness is only observable when drain capacity is contended)
        # parked arrivals journal into the world's store (replicated
        # worlds ship it to the standby), so a primary kill mid-storm
        # restores accepted-but-deferred work on the promoted CP
        state.admission = AdmissionController(
            state.placement, clock=self.clock.now, store=store,
            config=AdmissionConfig(batch_max=8, quantum=4.0,
                                   max_queue=512, shed_age_s=240.0,
                                   pressure_age_s=20.0,
                                   pressure_sustain_s=40.0,
                                   tenant_caps=dict(self.tenant_caps)))
        # rolling SLO engine on the VIRTUAL clock, installed as the
        # process default so the placement/admission/reconverge
        # observation points feed it; the slo-met FINAL invariant reads
        # it back. A failover builds a fresh one with the promoted state
        # (the engine is in-memory observability, not placement truth).
        state.slo = set_engine(SloEngine(parse_slo_props(CHAOS_SLOS),
                                         clock=self.clock.now))
        self._wire_obs(state)
        return state

    def _wire_obs(self, state: AppState) -> None:
        """Bind a fresh collector over this state's subsystems into the
        world's single TSDB. Called from _build_state, so a failover
        re-binds the sources to the promoted AppState while the series
        history continues uninterrupted. No loop runs: the _Runner calls
        `sample_obs()` at deterministic reconcile boundaries."""
        from ..cp.server import collector_sources
        from ..obs.collector import Collector
        collector = Collector(self.tsdb, registry=None,
                              clock=self.clock.now)
        for src in collector_sources(state):
            collector.add_source(src)
        self.obs_collector = collector
        state.collector = collector

    def sample_obs(self) -> None:
        if self.obs_collector is not None:
            self.obs_collector.sample_once(now=self.clock.now())

    # -- event log ---------------------------------------------------------

    def log(self, event: str, **fields) -> None:
        self._seq += 1
        entry = {"t": round(self.clock.offset(), 3), "seq": self._seq,
                 "event": event}
        entry.update(fields)
        self.events.append(entry)

    def _observe(self, op: str, table: str, payload) -> None:
        """Store mutation observer -> causal log (status changes only:
        allocation puts would flood, and record ids are not stable)."""
        if table != "servers" or op != "put":
            return
        slug, status = payload.slug, payload.status
        if self._server_status.get(slug) != status:
            self._server_status[slug] = status
            self.log("server-status", node=slug, status=status)

    # -- wiring ------------------------------------------------------------

    def _provider_factory(self, name: str, **kw):
        return _SimProvider(self)

    def connect(self, slug: str) -> SimAgent:
        """(Re)connect a node's agent: fresh backend, registry entry,
        heartbeat (exactly what an agent session does on connect)."""
        agent = SimAgent(slug, self)
        self.agents[slug] = agent
        self.backends[slug] = agent.backend
        self.state.agent_registry.register(slug, agent.conn,
                                           principal=slug)
        self.state.store.heartbeat(slug)
        self.detector.observe_heartbeat(slug)
        return agent

    def disconnect(self, slug: str, wipe: bool = True) -> None:
        """Crash semantics: session gone; `wipe` kills the containers."""
        agent = self.agents.pop(slug, None)
        if agent is not None:
            agent.conn._closed = True
            self.state.agent_registry.unregister(slug, agent.conn)
        self.detector.observe_disconnect(slug)
        if wipe:
            self.backends.pop(slug, None)

    # -- streaming admission (arrival-storm scenario) ----------------------

    def admit_wave(self, tenant: str, arrivals: int, departures: int,
                   burst: bool = False, stage: int = 0) -> None:
        """One tenant's wave: submit `arrivals` fresh streamed services
        (tiny, eligibility-free — the delta-path shape) and depart the
        tenant's oldest live ones. Deterministic: names come from a
        per-tenant counter, demand from the world's seeded rng, and the
        outcome (accepted vs shed) lands in the causal event log.
        `stage` picks the target stream by sorted index (clamped), so a
        multi-stage storm drives several different-size streaming
        problems through one controller."""
        ctrl = self.state.admission
        stages_sorted = sorted(self.flow.stages)
        stage_name = stages_sorted[min(max(stage, 0), len(stages_sorted) - 1)]
        key = f"{self.flow.name}/{stage_name}"
        if burst:
            self.admission_burst_tenants.add(tenant)
        ctrl.attach(self.flow, stage_name)
        specs = []
        for _ in range(arrivals):
            n = self._admit_counts[tenant] = \
                self._admit_counts.get(tenant, 0) + 1
            specs.append({"name": f"{tenant}-a{n:05d}",
                          "image": "chaos-app", "version": "1",
                          "cpu": self._admit_rng.choice((0.02, 0.05)),
                          "memory": float(self._admit_rng.choice((16, 32))),
                          "disk": 0.0})
        deps = ctrl.streamed_names(tenant, stage=key)[:departures]
        if specs:
            M_WORLD_ARRIVALS.inc(len(specs))
        try:
            out = ctrl.submit(tenant, arrivals=specs, departures=deps,
                              stage=key)
            self.log("admit", tenant=tenant, arrivals=len(specs),
                     departures=len(deps), queued=out["queued"],
                     burst=burst)
        except AdmissionRejected as e:
            self.log("admit-shed", tenant=tenant, arrivals=len(specs),
                     reason=e.reason)

    # -- correlated world faults (worldgen scenarios) ----------------------

    def _set_scheduling(self, slug: str, state: str) -> None:
        s = self.state.store.server_by_slug(slug)
        if s is not None:
            self.state.store.update("servers", s.id,
                                    scheduling_state=state)

    def spot_victims(self, pool: str, count: int) -> list[str]:
        """Deterministic reclamation targets: the pool's first `count`
        currently-connected members, sorted by slug."""
        members = sorted(s for s in self.spot_pools.get(pool, [])
                         if s in self.agents)
        return members[:max(int(count), 0)]

    def spot_warning(self, pool: str, count: int) -> list[str]:
        """Provider reclamation warning: resolve the victims NOW and
        cordon them, so every placement between warning and reclaim
        routes around machines that are already doomed."""
        victims = self.spot_victims(pool, count)
        self.log("fault", op="spot_warning", pool=pool, nodes=victims)
        self.spot_pending[pool] = victims
        for slug in victims:
            self._set_scheduling(slug, SchedulingState.CORDONED.value)
        return victims

    def spot_reclaim(self, pool: str, count: int) -> list[str]:
        """The storm lands: every warned victim dies in this instant —
        SILENTLY (the provider does not RPC the control plane; lease
        expiry must find the bodies)."""
        victims = self.spot_pending.pop(pool, None)
        if victims is None:               # storm without a warning
            victims = self.spot_victims(pool, count)
        victims = [v for v in victims if v in self.agents]
        self.log("fault", op="spot_reclaim", pool=pool, nodes=victims)
        for slug in victims:
            self.disconnect(slug)
        if victims:
            M_WORLD_RECLAIMS.inc(len(victims), pool=pool)
        self.spot_reclaimed.setdefault(pool, []).extend(victims)
        return victims

    def spot_revive(self, pool: str) -> list[str]:
        """Reclaimed capacity returns to the market: exactly the nodes
        the storm took reconnect and uncordon."""
        victims = self.spot_reclaimed.pop(pool, [])
        self.log("fault", op="spot_revive", pool=pool, nodes=victims)
        for slug in victims:
            self.connect(slug)
            self._set_scheduling(slug, SchedulingState.SCHEDULABLE.value)
        return victims

    def zone_down(self, region: str) -> list[str]:
        """A failure domain dies whole: every connected node of the
        region disconnects silently in one instant."""
        victims = sorted(s for s in self.regions.get(region, [])
                         if s in self.agents)
        self.log("fault", op="zone_down", region=region, nodes=victims)
        self.zone_outages += 1
        self.active_outages.add(region)
        self.outage_killed[region] = victims
        for slug in victims:
            self.disconnect(slug)
        M_WORLD_ZONE_OUTAGES.inc(region=region)
        return victims

    def zone_up(self, region: str) -> list[str]:
        """The domain revives: exactly the outage's victims reconnect."""
        victims = self.outage_killed.pop(region, [])
        self.log("fault", op="zone_up", region=region, nodes=victims)
        self.active_outages.discard(region)
        for slug in victims:
            self.connect(slug)
        return victims

    # -- replicated control plane (cp-failover scenario) -------------------

    def _wire_replication(self, primary_store: Store) -> None:
        """Attach a fresh warm standby to `primary_store`: snapshot
        catch-up first (the late-joiner path), then the synchronous
        in-process journal stream. The sink closure stays bound to ITS
        replica generation — after a failover the dead primary's sink
        still points at the promoted store, which is exactly how a
        zombie write meets the fence."""
        self._store_gen += 1
        standby_store = Store(self._store_path("standby"),
                              clock=self.clock.now)
        replica = StandbyReplica(standby_store)
        replica.install(primary_store.snapshot_doc())

        def ship(entries, _replica=replica):
            try:
                _replica.apply_lines(entries)
            except ReplicationFenced:
                self.fencing_rejections += 1
                self.log("fencing-rejected", entries=len(entries))

        primary_store.replication_sink = ship
        self.standby = replica
        self.standby_store = standby_store

    async def cp_failover(self, phase: str) -> None:
        """Kill the primary CP and promote the warm standby. The old
        AppState simply stops being `self.state` — its placement book,
        detector leases, and in-flight reconverger all die with it; only
        what was REPLICATED survives, which is the whole point."""
        rc = self.reconverger
        if phase == "redelivery":
            # die between enqueuing redelivery work and delivering it:
            # the sweep consumes the verdicts, parks/enqueues per-stage
            # work (journaled -> replicated), and then the process dies
            summary = await rc.step(drive=False)
            for slug in summary["dead"]:
                self.log("heal-dead", node=slug)
            for r in summary["resolved"]:
                self.log("heal-resolve", stage=r["stage"],
                         feasible=r["feasible"])
            for key in summary["parked"]:
                self.log("heal-parked", stage=key)
        elif phase == "compaction":
            # snapshot + journal truncate, then die: the shipped stream
            # must be unaffected (entries were shipped at append time)
            self.state.store.flush()
            self.log("cp-compacted")
        old_store = self.state.store
        old_store.unsubscribe(self._observe)
        # continuity ledger for the cp-failover-converged invariant:
        # every convergence-debt row the dead primary had persisted must
        # either converge or still be parked on the new one
        for rec in old_store.list("parked_work"):
            self.prekill_work.add((rec.stage_key, bool(rec.parked)))
        epoch = self.standby.promote()
        self.cp_failovers += 1
        self.log("cp-failover", phase=phase, epoch=epoch)
        store = self.standby_store
        self.state = self._build_state(store)
        self.detector = FailureDetector(LeaseConfig(**self.LEASE),
                                        clock=self.clock.now)
        self.reconverger = Reconverger(
            self.state, self.detector,
            config=ReconvergeConfig(**self.RECONV), clock=self.clock.now,
            rng=random.Random(self._seed ^ 0x5EA1 ^ (epoch << 8)))
        self.state.failure_detector = self.detector
        self.state.reconverger = self.reconverger
        # crash-only boot: resume the dead primary's convergence debt,
        # then prime a lease for every known server — a node that died
        # with the old primary must still expire to a verdict here
        resumed = self.reconverger.resume()
        for s in store.list("servers"):
            self.detector.prime(s.slug)
        self.log("cp-resumed", stages=resumed)
        # agents re-home (the reconnect loop finds the promoted CP);
        # their SimAgent objects — and idempotency windows — survive
        for slug in sorted(self.agents):
            agent = self.agents[slug]
            self.state.agent_registry.register(slug, agent.conn,
                                               principal=slug)
            store.heartbeat(slug)
            self.detector.observe_heartbeat(slug)
        self.autoscaler = Autoscaler(self.state, clock=self.clock.now)
        store.subscribe(self._observe)
        # the next generation's standby attaches via snapshot catch-up
        self._wire_replication(store)
        self.log("standby-attached", seq=self.standby.last_seq)
        # zombie proof: the dead primary's process gets one last write
        # in; its stale epoch must bounce off the promoted store
        zombies = sorted(s.slug for s in old_store.list("servers"))
        if zombies:
            old_store.heartbeat(zombies[0])

    def cp_placement(self, req: DeployRequest,
                     assignment: Optional[dict]) -> Optional[Placement]:
        """Mirror of agent._placement_from with a per-stage level cache.
        Keyed on the stage's service LIST, not just its name: streaming
        admission grows and shrinks stages mid-run, and a stale level
        schedule would silently skip every streamed service at deploy
        time (found by the arrival-storm scenario: 0 streamed containers
        despite 100 green deploys)."""
        if not assignment:
            return None
        sig = (req.stage_name,
               tuple(req.flow.stage(req.stage_name).services))
        levels = self._levels_cache.get(sig)
        if levels is None:
            pt = lower_stage(req.flow, req.stage_name,
                             nodes=[local_node(req.node or "sim")])
            levels = level_schedule(pt)
            if len(self._levels_cache) > 8:
                self._levels_cache.clear()
            self._levels_cache[sig] = levels
        return Placement(assignment=dict(assignment), levels=levels,
                         feasible=True, source="cp-solved")


class _SimProvider:
    """Cloud ServerProvider stand-in for the autoscaler (the FakeProvider
    test pattern): instant machines, deterministic ids."""

    def __init__(self, world: ChaosWorld):
        self.world = world

    def list_servers(self):
        from ..cloud.provider import ServerInfo
        return [ServerInfo(id=iid, name=name, status="up")
                for name, iid in sorted(
                    self.world._provider_instances.items())]

    def create_server(self, spec):
        from ..cloud.provider import ServerInfo
        iid = f"sim-{spec.name}"
        self.world._provider_instances[spec.name] = iid
        return ServerInfo(id=iid, name=spec.name, status="up",
                          ip="203.0.113.10")

    def delete_server(self, server_id) -> bool:
        for name, iid in list(self.world._provider_instances.items()):
            if iid == server_id:
                del self.world._provider_instances[name]
        return True

    def get_server(self, server_id):
        return None

    def power_on(self, server_id) -> bool:
        return True

    def power_off(self, server_id) -> bool:
        return True


# --------------------------------------------------------------------------
# the replay loop
# --------------------------------------------------------------------------

class _Runner:
    def __init__(self, schedule: F.FaultSchedule, n_services: int,
                 n_nodes: int, n_stages: int, pool_min: int,
                 flow: Optional[Flow] = None, *, device=None,
                 use_gpu: bool = True):
        self.schedule = schedule
        self.n_services = n_services
        self.n_nodes = n_nodes
        self.n_stages = n_stages
        self.pool_min = pool_min
        self.node_slugs = [node_slug(i) for i in range(n_nodes)]
        clock = VirtualClock()

        # region-aware world construction: worldgen schedules carry a
        # `world` block mapping regions/spot pools to node indices.
        # Stage g homes to region g % R (insertion order), so a zone
        # outage parks exactly that region's stages and no others.
        wmeta = dict(getattr(schedule, "world", {}) or {})
        region_slugs: dict[str, list[str]] = {}
        for rname, idxs in (wmeta.get("regions") or {}).items():
            slugs = [node_slug(int(i)) for i in idxs if int(i) < n_nodes]
            if slugs:
                region_slugs[rname] = slugs
        pool_slugs = {
            pname: [node_slug(int(i)) for i in idxs if int(i) < n_nodes]
            for pname, idxs in (wmeta.get("spot_pools") or {}).items()}
        region_names = list(region_slugs)
        stage_servers: Optional[dict[int, list[str]]] = None
        if region_names:
            stage_servers = {
                g: region_slugs[region_names[g % len(region_names)]]
                for g in range(n_stages)}

        if flow is None:
            flow = make_flow(n_services, n_stages, self.node_slugs,
                             seed=schedule.seed,
                             stage_servers=stage_servers)
        elif region_names:
            # adopted flow (plan simulate): re-home its stages onto the
            # recorded world's regions in declaration order
            for g, stage_name in enumerate(sorted(flow.stages)):
                flow.stages[stage_name].servers = list(
                    region_slugs[region_names[g % len(region_names)]])

        stage_region: dict[str, str] = {}
        if region_names:
            for g, stage_name in enumerate(sorted(flow.stages)):
                stage_region[f"{flow.name}/{stage_name}"] = \
                    region_names[g % len(region_names)]
        world_meta = {
            "regions": region_slugs,
            "spot_pools": pool_slugs,
            "capacity_scale": dict(wmeta.get("capacity_scale") or {}),
            "stage_region": stage_region,
        }
        # a schedule that kills the CP primary needs the replicated
        # control plane (warm standby + journaled primary store)
        replicated = any(op == F.CP_KILL for _, op, _ in schedule.events())
        self._tmp = (tempfile.TemporaryDirectory(prefix="fleet-chaos-cp-")
                     if replicated else None)
        self.world = ChaosWorld(
            flow, FaultInjector(), clock, pool_min=pool_min,
            seed=schedule.seed, replicated=replicated,
            store_dir=Path(self._tmp.name) if self._tmp else None,
            tenant_caps=getattr(schedule, "tenant_caps", {}),
            world_meta=world_meta, device=device, use_gpu=use_gpu)
        self.dirty: set[str] = set()     # stage names needing redeploy
        self.stats = {"deploys_ok": 0, "deploys_failed": 0, "faults": 0,
                      "resolves": 0, "restarts": 0, "scale_actions": 0,
                      "heals": 0, "failovers": 0, "admissions": 0}

    # -- world bootstrap ---------------------------------------------------

    def _bootstrap(self) -> None:
        w = self.world
        db = w.state.store
        for slug in self.node_slugs:
            db.register_server(slug, tenant=TENANT, hostname=slug)
            s = db.server_by_slug(slug)
            region = w.node_region.get(slug)
            scale = w.capacity_scale.get(region, 1.0) if region else 1.0
            cap = ServerCapacity(cpu=4.0 * scale, memory=8192.0 * scale,
                                 disk=40960.0 * scale)
            if region:
                db.update("servers", s.id, capacity=cap,
                          labels=ServerLabelsRec(region=region))
            else:
                db.update("servers", s.id, capacity=cap)
            w.connect(slug)
        if self.pool_min > 0:
            # max leaves headroom for replacements while dead records
            # await the corpse-reap window (a capped pool with several
            # un-reaped corpses must still reach its floor)
            db.create("worker_pools", WorkerPool(
                tenant=TENANT, name=POOL_NAME, min_servers=self.pool_min,
                max_servers=self.pool_min + 4,
                preferred_labels={"provider": "sim"}))
        w.log("world-built", services=self.n_services, nodes=self.n_nodes,
              stages=self.n_stages, pool_min=self.pool_min)

    # -- deploys -----------------------------------------------------------

    async def _deploy(self, stage_name: str) -> bool:
        from ..cp.handlers import execute_deploy
        w = self.world
        req = DeployRequest(flow=w.flow, stage_name=stage_name)
        try:
            await execute_deploy(w.state, req, tenant_name=TENANT)
        except Exception as e:
            # a fault of the device path itself is not a world event: it
            # ends the run with its error
            if _device_fault(e):
                raise
            self.stats["deploys_failed"] += 1
            w.log("deploy-failed", stage=stage_name,
                  error=str(e)[:200])
            return False
        self.stats["deploys_ok"] += 1
        w.log("deploy-ok", stage=stage_name)
        return True

    # -- fault application -------------------------------------------------

    def _resolve_worker(self, pool: str) -> Optional[str]:
        alive = sorted(s.slug for s in self.world.state.store.list(
            "servers", lambda s: s.pool == pool and s.status == "online"))
        return alive[0] if alive else None

    def _apply_container_exit(self, node: str) -> None:
        w = self.world
        backend = w.backends.get(node)
        if backend is None:
            w.log("container-exit-skipped", node=node, reason="node down")
            return
        for name in sorted(backend.containers):
            info = backend.containers[name]
            if (info.running and info.labels.get("fleetflow.project")
                    == w.flow.name):
                backend.set_state(name, "exited")
                info.exit_code = 137
                w.log("container-exit", node=node, container=name)
                return
        w.log("container-exit-skipped", node=node, reason="nothing running")

    async def _apply_group(self, group: list[tuple[float, str, dict]]) -> None:
        w = self.world
        burst: list[tuple[str, bool]] = []
        for _t, op, p in group:
            self.stats["faults"] += 1
            if op == F.NODE_DOWN:
                w.log("fault", op=op, node=p["node"])
                w.disconnect(p["node"], wipe=p.get("wipe", True))
                burst.append((p["node"], False))
            elif op == F.NODE_UP:
                w.log("fault", op=op, node=p["node"])
                w.connect(p["node"])
                burst.append((p["node"], True))
            elif op == F.NODE_DOWN_SILENT:
                # the self-healing contract: NO node_events, NO redeploy —
                # the CP must detect the death via lease expiry itself
                w.log("fault", op=op, node=p["node"])
                w.disconnect(p["node"])
            elif op == F.NODE_UP_SILENT:
                w.log("fault", op=op, node=p["node"])
                w.connect(p["node"])
            elif op == F.TICK:
                pass   # pacing only: the group boundary runs a reconcile
            elif op == F.WORKER_KILL:
                slug = self._resolve_worker(p["pool"])
                if slug is None:
                    w.log("fault-skipped", op=op, reason="no online worker")
                    continue
                w.log("fault", op=op, node=slug)
                w.disconnect(slug)
                burst.append((slug, False))
            elif op == F.PARTITION_START:
                w.log("fault", op=op, node=p["node"])
                w.injector.partition(p["node"])
            elif op == F.PARTITION_END:
                w.log("fault", op=op, node=p["node"])
                w.injector.heal_partition(p["node"])
            elif op == F.SLOW_START:
                w.log("fault", op=op, node=p["node"], delay=p["delay"])
                w.injector.slow_agent(p["node"], p["delay"])
            elif op == F.SLOW_END:
                w.log("fault", op=op, node=p["node"])
                w.injector.heal_slow(p["node"])
            elif op == F.ARM_DEPLOY_FAIL:
                w.log("fault", op=op, count=p["count"])
                w.injector.arm_deploy_fail(p["count"])
            elif op == F.CONTAINER_EXIT:
                self._apply_container_exit(p["node"])
            elif op == F.CP_KILL:
                w.log("fault", op=op, phase=p["phase"])
                await w.cp_failover(p["phase"])
                self.stats["failovers"] += 1
            elif op == F.ADMIT:
                w.admit_wave(p["tenant"], p["arrivals"], p["departures"],
                             p.get("burst", False), p.get("stage", 0))
            elif op == F.REDEPLOY:
                w.log("redeploy-requested", stage=p["stage"])
                self.dirty.add(p["stage"])
            elif op == F.SPOT_WARNING:
                w.spot_warning(p["pool"], p["count"])
            elif op == F.SPOT_RECLAIM:
                # correlated kill: the whole warned set dies SILENTLY in
                # one instant — lease expiry finds the bodies, and every
                # surviving placement already routed around the cordon
                w.spot_reclaim(p["pool"], p["count"])
            elif op == F.SPOT_REVIVE:
                w.spot_revive(p["pool"])
            elif op == F.ZONE_DOWN:
                w.zone_down(p["region"])
            elif op == F.ZONE_UP:
                w.zone_up(p["region"])
            elif op == F.HOTSPOT_SHIFT:
                w.hotspot_tenant = p["tenant"]
                # a hotspot tenant deliberately bursts: exempt it from
                # the admission-fair bound while it is hot
                w.admission_burst_tenants.add(p["tenant"])
                w.log("fault", op=op, tenant=p["tenant"])
            else:
                raise ValueError(f"unknown primitive op {op!r}")
        if burst:
            # coalesced churn: ONE warm re-solve per affected stage
            # against the final mask (the production node_events path)
            moved = await asyncio.get_running_loop().run_in_executor(
                None, lambda: w.state.placement.node_events(burst))
            self.stats["resolves"] += len(moved)
            for key, pl in moved:
                w.log("resolve", stage=key, feasible=pl.feasible,
                      moved_rows=len(pl.assignment))
                self.dirty.add(key.split("/", 1)[1])

    # -- reconciliation ----------------------------------------------------

    async def _heal_pass(self) -> None:
        """The production self-healing cadence, replayed: connected
        agents heartbeat (a partitioned agent's heartbeats don't reach
        the CP — exactly how its lease starves), then one reconverger
        step (detector sweep -> coalesced re-solve -> redeliveries).
        Every outcome lands in the causal event log with virtual times
        only, keeping the digest reproducible."""
        w = self.world
        for slug in sorted(w.agents):
            if slug in w.injector.partitioned:
                continue
            w.state.store.heartbeat(slug)
            w.detector.observe_heartbeat(slug)
        summary = await w.reconverger.step()
        for slug in summary["dead"]:
            w.log("heal-dead", node=slug)
        for slug in summary["online"]:
            w.log("heal-online", node=slug)
        for r in summary["resolved"]:
            w.log("heal-resolve", stage=r["stage"], feasible=r["feasible"])
        for key in summary["redelivered"]:
            self.stats["heals"] += 1
            w.log("heal-redeliver", stage=key)
        for key in summary["retried"]:
            w.log("heal-retry", stage=key)
        for key in summary["parked"]:
            w.log("heal-parked", stage=key)

    async def _monitor_pass(self) -> None:
        """Restart exited fleet containers through the real command path
        (a partitioned node's restart fails and is retried next pass)."""
        w = self.world
        for slug in sorted(w.backends):
            backend = w.backends[slug]
            for name in sorted(backend.containers):
                info = backend.containers[name]
                if (info.state == "exited"
                        and info.labels.get("fleetflow.project")
                        == w.flow.name):
                    try:
                        await w.state.agent_registry.send_command(
                            slug, "restart", {"container": name})
                        self.stats["restarts"] += 1
                        w.log("restart-ok", node=slug, container=name)
                    except ControlPlaneError as e:
                        w.log("restart-failed", node=slug, container=name,
                              error=str(e)[:120])

    def _autoscale(self) -> None:
        w = self.world
        actions = self.autoscaler_sweep()
        for a in actions:
            self.stats["scale_actions"] += 1
            w.log("scale", pool=a.pool, kind=a.kind, node=a.slug, ok=a.ok)
        # boot freshly provisioned workers: the machine "comes up" and
        # its agent connects (status provisioning -> online)
        booted = False
        for s in sorted(w.state.store.list(
                "servers", lambda s: s.status == "provisioning"
                and s.pool is not None), key=lambda s: s.slug):
            if not booted:
                w.clock.advance(1.0)
                booted = True
            w.connect(s.slug)
            w.log("worker-online", node=s.slug)

    def autoscaler_sweep(self):
        return self.world.autoscaler.run_sweep()

    async def _admission_pass(self) -> None:
        """Drain ONE admission micro-batch (the continuous-batching
        cadence: one bucketed micro-solve per reconcile), then mark the
        touched stages dirty so the placed services actually get their
        containers through the real deploy path."""
        w = self.world
        ctrl = w.state.admission
        if ctrl is None or not ctrl.has_work():
            return
        out = await asyncio.get_running_loop().run_in_executor(
            None, ctrl.step)
        if not out["batch"]:
            return
        self.stats["admissions"] += len(out["placed"])
        w.log("admit-batch", batch=out["batch"],
              placed=len(out["placed"]), departed=len(out["departed"]),
              parked=len(out["parked"]),
              depth=ctrl.pressure()["queue_depth"])
        for key in out["stages"]:
            self.dirty.add(key.split("/", 1)[1])

    async def _reconcile(self) -> None:
        await self._heal_pass()
        await self._admission_pass()
        await self._monitor_pass()
        if self.pool_min > 0:
            self._autoscale()
        for stage_name in sorted(self.dirty):
            if await self._deploy(stage_name):
                self.dirty.discard(stage_name)
        # one TSDB tick per reconcile: the capture's sample count equals
        # the reconcile count, so two runs of a seed agree exactly
        self.world.sample_obs()

    def _check_instant(self) -> list[str]:
        # mid-outage census for degraded-gracefully: collateral damage
        # must be recorded WHILE the outage is live (the final snapshot
        # only sees the healed world)
        record_outage_census(self.world)
        found = check_instant(self.world)
        for v in found:
            self.world.log("violation", detail=v)
        return found

    # -- main loop ---------------------------------------------------------

    async def run(self) -> ChaosReport:
        w = self.world
        violations: list[str] = []
        self._bootstrap()
        await self._reconcile()            # pool to floor before traffic
        for stage_name in sorted(w.flow.stages):
            await self._deploy(stage_name)
        violations += self._check_instant()

        events = self.schedule.events()
        groups: list[list] = []
        for ev in events:
            if groups and abs(groups[-1][0][0] - ev[0]) < 1e-9:
                groups[-1].append(ev)
            else:
                groups.append([ev])
        for group in groups:
            w.clock.advance_to(group[0][0])
            await self._apply_group(group)
            await self._reconcile()
            violations += self._check_instant()

        # settle: retry until converged (partitions/slowness have expired
        # by the schedule's horizon), then judge the final world
        w.clock.advance_to(max(self.schedule.horizon,
                               w.clock.offset()))
        # admission backlogs drain one micro-batch per round, so a storm
        # needs more settle headroom than the fault scenarios do; rounds
        # stay identical for schedules without admission work
        for _round in range(40):
            await self._reconcile()
            exited = any(
                info.state == "exited"
                and info.labels.get("fleetflow.project") == w.flow.name
                for slug in sorted(w.backends)
                for info in w.backends[slug].containers.values())
            admission_busy = (w.state.admission is not None
                              and w.state.admission.has_work())
            if (not self.dirty and not exited
                    and not w.reconverger.has_work()
                    and not admission_busy):
                break
            w.clock.advance(30.0)
        w.log("settled", rounds=_round + 1, dirty=sorted(self.dirty),
              healing=w.reconverger.pending_stage_keys())

        final = check_final(w)
        for v in final:
            w.log("violation", detail=v)
        violations += final
        report = ChaosReport(
            scenario=self.schedule.scenario, seed=self.schedule.seed,
            services=self.n_services, nodes=self.n_nodes,
            stages=self.n_stages, events=w.events,
            violations=violations, stats=dict(self.stats),
            slo=slo_summary(w.state.slo),
            tsdb=w.tsdb.snapshot())
        return report


def run_schedule(schedule: F.FaultSchedule, *, services: int, nodes: int,
                 stages: int = 4, pool_min: int = 2,
                 flow: Optional[Flow] = None,
                 validate: bool = True, device=None,
                 use_gpu: bool = True) -> ChaosReport:
    """Replay one schedule against a freshly built world. Deterministic:
    the same (schedule, sizes) reproduces the identical event log.
    `flow` substitutes a proposed Flow for the synthetic one (the
    `fleet plan simulate` path); `validate` runs the feasibility
    pre-check so mis-sized scenarios fail fast with a clear message
    instead of surfacing as invariant noise. `device` and `use_gpu` pick
    where the world places (the module's docstring): the card by
    default."""
    if validate:
        validate_schedule(schedule, services=services, nodes=nodes)
    # the world installs its virtual-clock SLO engine as the process
    # default; restore whatever was there so a long-lived process (the
    # test suite, a CP embedding the harness) doesn't keep observing
    # into a dead world's frozen clock after the run
    prev_engine = get_engine()
    runner = None
    try:
        runner = _Runner(schedule, services, nodes, stages, pool_min,
                         flow=flow, device=device, use_gpu=use_gpu)
        return asyncio.run(runner.run())
    finally:
        set_engine(prev_engine)
        if runner is not None and runner._tmp is not None:
            runner._tmp.cleanup()
