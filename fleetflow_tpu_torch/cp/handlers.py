"""Channel handlers: the CP's RPC surface (the port's copy of
``fleetflow_tpu/cp/handlers.py``, its deploy path).

Analog of controlplane handlers/ (13 channels, handlers/mod.rs:21-35), all
shaped `method -> store/registry op -> payload`. The port holds the deploy
path the reconverger's and the chaos world's redeploys share:
`execute_deploy` records the deployment, solves the stage's placement on
the card (in an executor thread, on the card's current stream), fans the
per-node slices out through the agent registry and commits or releases
the reservation. `register_all`, the channel handlers and `execute_down`
are not ported yet.

A failed deploy finishes its Deployment record as FAILED and re-raises,
whatever failed: a fault of the device path reaches the caller with its
own type.
"""

from __future__ import annotations

import asyncio
from typing import TYPE_CHECKING

from ..obs import get_logger, span
from ..obs.metrics import REGISTRY
from ..obs.trace import new_trace_id, use_trace
from ..runtime.engine import DeployEngine, DeployRequest
from .agent_registry import DEPLOY_TIMEOUT
from .models import Deployment, DeploymentStatus

if TYPE_CHECKING:
    from .server import AppState

__all__ = ["execute_deploy"]

_log = get_logger("cp.deploy")

# metric catalog: docs/guide/10-observability.md. Channel label only (the
# method vocabulary is open-ended via agent commands; channels are the
# fixed 15-way enum) — bounded cardinality by construction.
_M_REQUEST_S = REGISTRY.histogram(
    "fleet_cp_request_duration_seconds",
    "Channel RPC handler latency, by channel", labels=("channel",))
_M_REQUEST_ERRORS = REGISTRY.counter(
    "fleet_cp_request_errors_total",
    "Channel RPC handlers that raised, by channel", labels=("channel",))


async def execute_deploy(state: "AppState", req: DeployRequest,
                         tenant_name: str = "default") -> dict:
    """The deploy.execute path (handlers/deploy.rs:280-542), shared by the
    deploy channel and the web redeploy route: record the deployment (with
    the request, so redeploy can replay it), solve placement, fan out to
    every connected stage agent (or run CP-locally), finish the record.

    The whole path runs inside ONE trace: minted here (or adopted from the
    CLI's request), carried to every agent via DeployRequest.trace_id, so
    the CP span, each agent's engine spans, and all their log lines share
    a trace_id end to end."""
    req.trace_id = req.trace_id or new_trace_id()
    with use_trace(req.trace_id):
        with span(_log, "deploy.execute", project=req.flow.name,
                  stage=req.stage_name, tenant=tenant_name) as sp:
            return await _execute_deploy(state, req, tenant_name, sp)


async def _execute_deploy(state: "AppState", req: DeployRequest,
                          tenant_name: str, sp: dict) -> dict:
    db = state.store
    tenant = db.ensure_tenant(tenant_name)
    project = db.ensure_project(tenant.name, req.flow.name)
    stage_cfg = req.flow.stage(req.stage_name)
    # fail fast on statically-doomed flows BEFORE any record is created or
    # lowering begins: the lint structural rules (dependency cycles,
    # dangling depends_on / service references) prove the deploy cannot
    # succeed on ANY inventory, so the submit is rejected with coded
    # diagnostics in milliseconds. Inventory-dependent rules are NOT run
    # here — the CP solves against live agent inventory, not the flow's
    # declared servers.
    from ..lint import deploy_blockers
    blockers = deploy_blockers(req.flow, req.stage_name)
    if blockers:
        raise ValueError(
            "flow rejected by static analysis: "
            + "; ".join(f"{d.code}: {d.message}" for d in blockers))
    stage = db.ensure_stage(project.id, req.stage_name,
                            backend=stage_cfg.backend.value,
                            servers=stage_cfg.servers)
    # the stored request is a REPLAY TEMPLATE (stage_redeploy rebuilds it
    # via from_dict): the trace id must not ride along, or every future
    # redeploy would inherit this deploy's trace and `fleet events
    # --trace` would interleave operations that ran days apart
    stored_req = req.to_dict()
    stored_req.pop("trace_id", None)
    dep = db.create("deployments", Deployment(
        tenant=tenant.name, project=project.id, stage=stage.id,
        status=DeploymentStatus.RUNNING.value,
        services=[s.name for s in stage_cfg.resolved_services(req.flow)],
        request=stored_req))

    targets = [s for s in stage_cfg.servers
               if state.agent_registry.is_connected(s)]
    try:
        if targets:
            # Fan out to EVERY connected stage server concurrently —
            # the reference routes to .first() only and defers fan-out
            # (handlers/deploy.rs:386-398); the placement solve makes
            # per-node slices explicit, so we send each agent its own.
            placement, rid = await asyncio.get_running_loop(
                ).run_in_executor(None, lambda: state.placement
                                  .solve_stage(req.flow, req.stage_name,
                                               tenant=tenant.name))
            if not placement.feasible:
                raise ValueError(
                    f"placement infeasible: {placement.violations}")
            # batched shard-parallel fan-out (cp/shards.py): the deploy
            # engine hands the registry the whole per-node command set
            # and each shard lane pipelines its slice
            results = await state.agent_registry.send_batch(
                [(slug, "deploy.execute",
                  {"request": DeployRequest(
                      flow=req.flow, stage_name=req.stage_name,
                      target_services=req.target_services,
                      no_pull=req.no_pull, no_prune=req.no_prune,
                      node=slug, trace_id=req.trace_id).to_dict(),
                   "assignment": placement.assignment})
                 for slug in targets], timeout=DEPLOY_TIMEOUT)
            errors = [str(r) for r in results if isinstance(r, Exception)]
            if errors:
                if rid:
                    state.placement.release(rid)
                raise ValueError("; ".join(errors))
            if rid:
                state.placement.commit(rid)
            log = "\n".join(str(r) for r in results
                            if not isinstance(r, Exception))
            db.update("deployments", dep.id,
                      placement=placement.assignment)
        else:
            # CP-local execution (handlers/deploy.rs:470-507)
            engine = DeployEngine(state.backend_factory(),
                                  sleep=state.deploy_sleep)
            res = await asyncio.get_running_loop().run_in_executor(
                None, lambda: engine.execute(req))
            if not res.ok:
                raise ValueError(f"failed services: {res.failed}")
            log = f"deployed {len(res.deployed)} containers locally"
        for svc in (db.get("deployments", dep.id).services or []):
            db.upsert_service(stage.id, svc, status="deployed")
        db.finish_deployment(dep.id, DeploymentStatus.SUCCEEDED, log=log)
        sp["deployment"] = dep.id
        sp["agents"] = len(targets) or None
    except Exception as e:
        db.finish_deployment(dep.id, DeploymentStatus.FAILED,
                             error=str(e))
        raise
    return {"deployment": db.get("deployments", dep.id).public_dict()}
