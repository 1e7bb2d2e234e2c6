"""DeployEngine: the 5-step deploy pipeline (the port's copy of
``fleetflow_tpu/runtime/engine.py``).

Analog of fleetflow-container engine.rs:100-194, re-architected around the
scheduler layer: instead of the reference's sequential per-service loop over
a 2-bucket partition (engine.rs:67-85,157-167), the engine takes a Placement
(assignment + exact dependency level schedule) and executes wave by wave —
every service in a level is independent, so a node executor can run a whole
wave concurrently and the cross-node picture matches the solver's plan.

Steps (engine.rs:100-194):
  1. stop/remove existing stage containers (target-filtered)
  2. pull images (unless no_pull)
  3. ensure the stage network
  4. create + start in dependency level order, waiting on each level
  5. prune old images (unless no_prune; policy: >168h, engine.rs:458-489)

`DeployRequest` is the serializable cross-machine contract (engine.rs:17-25)
that rides the control-plane wire to node agents.

The engine's own placement (no `placement=` given) keeps the reference's
default scheduler, `HostGreedyScheduler()`: it places a local deploy onto
the one implicit local node, where the card has nothing to solve. The card
enters through the control plane's `PlacementService`, whose solved
placement an agent executes (`placement=` given, no re-solve).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.errors import FlowError
from ..core.model import Flow
from ..core.serialize import flow_from_dict, flow_to_dict
from ..obs import get_logger, kv, span
from ..obs.metrics import REGISTRY
from ..obs.trace import current_trace_id, new_trace_id, use_trace
from ..lower.tensors import LOCAL_NODE_NAME, local_node, lower_stage
from ..sched import (HostGreedyScheduler, Placement, Scheduler,
                     place_with_fallback)
from .backend import BackendError, ContainerBackend
from .converter import (container_name, network_name,
                        service_to_container_config, stage_services)
from .waiter import wait_for_service

__all__ = ["DeployEngine", "DeployRequest", "DeployEvent", "DeployResult"]


@dataclass
class DeployRequest:
    """Serializable deploy order (engine.rs:17-25). `node` scopes execution
    to one node's slice of the placement (agents set it to their slug).
    `trace_id` carries the deploy's trace across the CP->agent wire, so
    one `fleet deploy` correlates CLI, CP, and every agent's span/log
    lines (and flight-recorder events) under a single id."""
    flow: Flow
    stage_name: str
    target_services: list[str] = field(default_factory=list)
    no_pull: bool = False
    no_prune: bool = False
    node: Optional[str] = None
    trace_id: Optional[str] = None

    def to_dict(self) -> dict:
        d: dict = {"flow": flow_to_dict(self.flow), "stage_name": self.stage_name}
        if self.target_services:
            d["target_services"] = self.target_services
        if self.no_pull:
            d["no_pull"] = True
        if self.no_prune:
            d["no_prune"] = True
        if self.node:
            d["node"] = self.node
        if self.trace_id:
            d["trace_id"] = self.trace_id
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DeployRequest":
        return cls(flow=flow_from_dict(d["flow"]),
                   stage_name=d["stage_name"],
                   target_services=d.get("target_services", []),
                   no_pull=d.get("no_pull", False),
                   no_prune=d.get("no_prune", False),
                   node=d.get("node"),
                   trace_id=d.get("trace_id"))


@dataclass
class DeployEvent:
    """Progress callback payload (engine.rs DeployEvent:30-49). Every event
    carries the deploy's trace_id (set by the engine's emitter) so callback
    consumers — the CP log router, the CLI printer — can correlate streams
    from concurrent deploys."""
    step: str            # stop|pull|network|place|start|wait|prune|done|error
    service: Optional[str] = None
    message: str = ""
    level: Optional[int] = None
    trace_id: Optional[str] = None

    def __str__(self) -> str:
        svc = f" {self.service}" if self.service else ""
        return f"[{self.step}]{svc} {self.message}".rstrip()


@dataclass
class DeployResult:
    """Outcome summary (engine.rs DeployResult)."""
    deployed: list[str] = field(default_factory=list)
    removed: list[str] = field(default_factory=list)
    failed: dict[str, str] = field(default_factory=dict)
    placement: Optional[Placement] = None
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.failed


EventCb = Callable[[DeployEvent], None]

log = get_logger("engine")

# metric catalog: docs/guide/10-observability.md
_M_DEPLOYS = REGISTRY.counter(
    "fleet_deploys_total", "Deploy pipeline runs by outcome",
    labels=("outcome",))
_M_DEPLOY_S = REGISTRY.histogram(
    "fleet_deploy_duration_seconds", "Deploy pipeline wall time")
_M_DEPLOY_EVENTS = REGISTRY.counter(
    "fleet_deploy_events_total", "Deploy progress events by pipeline step",
    labels=("step",))
_M_DEPLOY_SERVICES = REGISTRY.counter(
    "fleet_deploy_services_total",
    "Per-service deploy outcomes (containers deployed/removed/failed)",
    labels=("result",))


class DeployEngine:
    def __init__(self, backend: ContainerBackend, *,
                 scheduler: Optional[Scheduler] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 project_root: str = ".",
                 fault_hook: Optional[Callable[[str, str], None]] = None):
        self.backend = backend
        self.scheduler = scheduler or HostGreedyScheduler()
        self.sleep = sleep
        self.project_root = project_root
        # fault_hook("start", service_row) is consulted once per service,
        # right before its create/start; raising BackendError fails that
        # service through the normal error path (result.failed -> deploy
        # failure -> reservation release upstream). The chaos harness
        # injects DeployFail here.
        self.fault_hook = fault_hook

    # ------------------------------------------------------------------
    def execute(self, req: DeployRequest,
                on_event: Optional[EventCb] = None,
                placement: Optional[Placement] = None) -> DeployResult:
        """Run the 5-step pipeline. `placement` lets a control plane hand a
        pre-solved plan to node agents so each agent executes only its slice
        (req.node) without re-solving.

        The whole run executes inside the request's trace — minted here for
        local deploys, carried over the wire (req.trace_id) for CP-routed
        ones — so every log line, DeployEvent, and flight-recorder span of
        one deploy shares one trace_id across CLI, CP, and agents. The
        explicit use_trace() re-entry also makes the correlation survive
        run_in_executor thread hops, which don't propagate contextvars."""
        req.trace_id = req.trace_id or new_trace_id()
        with use_trace(req.trace_id):
            t0 = time.perf_counter()
            try:
                with span(log, "deploy.execute", project=req.flow.name,
                          stage=req.stage_name, node=req.node) as sp:
                    result = self._execute(req, on_event, placement)
                    sp["deployed"] = len(result.deployed)
                    sp["failed"] = len(result.failed) or None
            except Exception:
                _M_DEPLOYS.inc(outcome="error")
                _M_DEPLOY_S.observe(time.perf_counter() - t0)
                raise
        _M_DEPLOYS.inc(outcome="ok" if result.ok else "failed")
        _M_DEPLOY_S.observe(result.duration_s)
        for kind, rows in (("deployed", result.deployed),
                           ("removed", result.removed),
                           ("failed", result.failed)):
            if rows:
                _M_DEPLOY_SERVICES.inc(len(rows), result=kind)
        return result

    def _execute(self, req: DeployRequest,
                 on_event: Optional[EventCb],
                 placement: Optional[Placement]) -> DeployResult:
        cb = on_event or (lambda e: None)

        def emit(e: DeployEvent) -> None:
            # every progress event also lands in the structured log, so a
            # deploy is traceable without a callback (ref: engine.rs events
            # mirrored through #[instrument]-ed tracing)
            e.trace_id = e.trace_id or current_trace_id() or None
            _M_DEPLOY_EVENTS.inc(step=e.step)
            (log.error if e.step == "error" else log.debug)(
                "%s %s", e.step, kv(service=e.service, level=e.level,
                                    msg=e.message or None))
            cb(e)

        t0 = time.perf_counter()
        flow, stage = req.flow, req.flow.stage(req.stage_name)
        services = stage_services(flow, stage, req.target_services or None)
        by_name = {s.name: s for s in services}
        result = DeployResult()

        # ---- step 0: placement (replaces order_by_dependencies) ----------
        if placement is None:
            # fail fast on statically-doomed flows BEFORE lowering: the
            # lint structural rules (cycles, dangling references, and for
            # local single-node execution the host-port pigeonhole) prove
            # the deploy cannot succeed, so reject in milliseconds with
            # coded diagnostics instead of failing mid-pipeline. Agents
            # executing a CP-solved placement skip this — the CP already
            # gated the submit (cp/handlers.py execute_deploy).
            from ..lint import deploy_blockers
            blockers = deploy_blockers(flow, req.stage_name,
                                       local=req.node is None)
            if blockers:
                for d in blockers:
                    emit(DeployEvent("error", message=d.format()))
                raise FlowError(
                    "flow rejected by static analysis: "
                    + "; ".join(f"{d.code}: {d.message}" for d in blockers))
            # req.node unset = LOCAL execution (fleet up / CP-local deploy,
            # handlers/deploy.rs:470-507): everything runs on THIS machine,
            # so lower onto the single implicit local node — servers the
            # flow declares for remote stages must not siphon services into
            # slices nobody here executes (the "up deployed 0" trap).
            # Agents (req.node set) receive a CP-solved placement instead.
            if req.node is None:
                pt = lower_stage(flow, req.stage_name,
                                 nodes=[local_node()], local=True)
            else:
                pt = lower_stage(flow, req.stage_name)
            placement, _relaxed = place_with_fallback(self.scheduler, pt)
        emit(DeployEvent("place", message=(
            f"{len(placement.assignment)} rows -> "
            f"{len(set(placement.assignment.values()))} nodes "
            f"({placement.source}, {placement.solve_ms:.1f}ms, "
            f"violations={placement.violations})")))
        if not placement.feasible:
            raise FlowError(
                f"placement infeasible: {placement.violations} violations")
        result.placement = placement

        my_node = req.node or LOCAL_NODE_NAME
        node_names = set(placement.assignment.values())
        if (req.node is None and my_node not in node_names
                and len(node_names) == 1):
            # LOCAL execution against a placement solved under a different
            # (synthetic) node name: execute it all. Never for agents —
            # req.node is this agent's identity, and a single-node
            # assignment to ANOTHER node means this node's slice is empty
            # (the CP fans deploy.execute to every stage server; without
            # this guard each of them would run a full copy)
            my_node = next(iter(node_names))
        levels = placement.node_levels(my_node)

        # replica rows ("web#0") collapse back to their base service for
        # container naming on this node; replica index keeps names unique
        def parse_row(row: str) -> tuple[str, Optional[int]]:
            if "#" in row:
                base, idx = row.rsplit("#", 1)
                return base, int(idx)
            return row, None

        mine: list[tuple[str, Optional[int]]] = [
            parse_row(r) for lvl in levels for r in lvl]
        mine = [(b, i) for b, i in mine if b in by_name]

        # ---- step 1: stop/remove existing ---------------------------------
        label_filter = {"fleetflow.project": flow.name,
                        "fleetflow.stage": stage.name}
        existing = self.backend.list(label_filter=label_filter)
        targets = {b for b, _ in mine}
        for info in existing:
            svc_label = info.labels.get("fleetflow.service", "")
            if req.target_services and svc_label.split("#")[0] not in targets:
                continue
            emit(DeployEvent("stop", service=svc_label, message=info.name))
            self.backend.stop(info.name)
            self.backend.remove(info.name, force=True)
            result.removed.append(info.name)

        # ---- step 2: pull -------------------------------------------------
        if not req.no_pull:
            for image in dict.fromkeys(by_name[b].image_name() for b, _ in mine):
                emit(DeployEvent("pull", message=image))
                try:
                    self.backend.pull(image)
                except BackendError as e:
                    # a local build may provide the image; create will 404
                    # if it truly doesn't exist (up.rs:329-441 recovery)
                    emit(DeployEvent("pull", message=f"warn: {e}"))

        # ---- step 3: network ----------------------------------------------
        net = network_name(flow.name, stage.name)
        emit(DeployEvent("network", message=net))
        self.backend.ensure_network(net)

        # ---- step 4: create + start, wave by wave -------------------------
        for li, level in enumerate(levels):
            started: list[tuple[str, str]] = []   # (container, base)
            for row in level:
                base, ridx = parse_row(row)
                if base not in by_name:
                    continue
                svc = by_name[base]
                cname = container_name(flow.name, stage.name, base)
                if ridx is not None:
                    cname = f"{cname}-{ridx}"
                emit(DeployEvent("start", service=base, level=li, message=cname))
                try:
                    if self.fault_hook is not None:
                        self.fault_hook("start", row)
                    cfg = service_to_container_config(
                        svc, flow.name, stage.name,
                        project_root=self.project_root, network=net)
                    cfg.name = cname
                    if ridx is not None:
                        cfg.labels["fleetflow.service"] = row
                        cfg.labels["fleetflow.replica"] = str(ridx)
                    self._create_start(cfg, svc, emit)
                    started.append((cname, base))
                    result.deployed.append(cname)
                except BackendError as e:
                    emit(DeployEvent("error", service=base, message=str(e)))
                    result.failed[row] = str(e)
            # wait for the whole wave before the next level starts
            for cname, base in started:
                svc = by_name[base]
                if svc.healthcheck or li + 1 < len(levels):
                    emit(DeployEvent("wait", service=base, level=li))
                    wait_for_service(self.backend, cname, svc, sleep=self.sleep)

        # ---- step 5: prune ------------------------------------------------
        if not req.no_prune:
            emit(DeployEvent("prune"))
            self.backend.prune_images()

        result.duration_s = time.perf_counter() - t0
        emit(DeployEvent("done", message=(
            f"{len(result.deployed)} deployed, {len(result.removed)} removed, "
            f"{len(result.failed)} failed in {result.duration_s:.2f}s")))
        log.info("deploy %s", kv(
            project=flow.name, stage=stage.name, node=my_node,
            deployed=len(result.deployed), removed=len(result.removed),
            failed=len(result.failed) or None,
            duration_ms=f"{result.duration_s * 1e3:.1f}"))
        return result

    # ------------------------------------------------------------------
    def _create_start(self, cfg, svc, emit: EventCb) -> None:
        """create/start with the reference's recovery ladder
        (up.rs:329-441): 409 conflict -> start-or-restart the existing
        container; 404 missing image -> pull once and retry."""
        try:
            self.backend.create(cfg)
        except BackendError as e:
            msg = str(e)
            if "409" in msg or "already exists" in msg:
                emit(DeployEvent("start", service=svc.name,
                                 message="exists; restarting"))
                self.backend.restart(cfg.name)
                return
            if "404" in msg or "no such image" in msg.lower():
                self.backend.pull(cfg.image)
                self.backend.create(cfg)
            else:
                raise
        self.backend.start(cfg.name)

    # ------------------------------------------------------------------
    def down(self, flow: Flow, stage_name: str,
             target_services: Optional[list[str]] = None,
             on_event: Optional[EventCb] = None,
             remove_network: bool = True) -> DeployResult:
        """Stop + remove a stage's containers (runtime.rs down:120)."""
        emit = on_event or (lambda e: None)
        stage = flow.stage(stage_name)
        result = DeployResult()
        label_filter = {"fleetflow.project": flow.name,
                        "fleetflow.stage": stage.name}
        for info in self.backend.list(label_filter=label_filter):
            svc = info.labels.get("fleetflow.service", "").split("#")[0]
            if target_services and svc not in target_services:
                continue
            emit(DeployEvent("stop", service=svc, message=info.name))
            self.backend.stop(info.name)
            self.backend.remove(info.name, force=True)
            result.removed.append(info.name)
        if remove_network and not target_services:
            self.backend.remove_network(network_name(flow.name, stage.name))
        return result
